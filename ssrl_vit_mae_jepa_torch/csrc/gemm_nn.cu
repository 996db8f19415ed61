// The NN products of the branch kernels, dY @ W with the data-gradient
// epilogues (da, dy1, dz with the GELU backward, dy2); W is read MN-major
// in place. Instantiates csrc/gemm_sm90.cuh.
#include "gemm_sm90.cuh"

namespace ssrl {

cudaError_t gemm_nn(int epi, const GemmArgs& p, cudaStream_t st) {
  switch (epi) {
    case EPI_BF16: return launch_bn<false, true, EPI_BF16>(p, 1, st);
    case EPI_F32: return launch_bn<false, true, EPI_F32>(p, 1, st);
    case EPI_GELU_BWD: return launch_bn<false, true, EPI_GELU_BWD>(p, 1, st);
    case EPI_GELU32_BWD: return launch_bn<false, true, EPI_GELU32_BWD>(p, 1, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ssrl
