// The NT products of the branch kernels, x @ W^T with the forward
// epilogues (qkv, proj, fc1, fc2, and the backward's recompute of qkv and
// fc1), and proj and fc2 split over a model axis, whose f32 sums (EPI_F32)
// the model group all-reduces. The kernel is csrc/gemm_sm90.cuh's; this file instantiates it, one
// source per layout so that nvcc builds the three in parallel.
#include "gemm_sm90.cuh"

namespace ssrl {

cudaError_t gemm_nt(int epi, const GemmArgs& p, cudaStream_t st) {
  switch (epi) {
    case EPI_F32: return launch_bn<false, false, EPI_F32>(p, 1, st);
    case EPI_BIAS_BF16: return launch_bn<false, false, EPI_BIAS_BF16>(p, 1, st);
    case EPI_BIAS_RESID: return launch_bn<false, false, EPI_BIAS_RESID>(p, 1, st);
    case EPI_BIAS_GELU: return launch_bn<false, false, EPI_BIAS_GELU>(p, 1, st);
    case EPI_BIAS_GELU32: return launch_bn<false, false, EPI_BIAS_GELU32>(p, 1, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ssrl
