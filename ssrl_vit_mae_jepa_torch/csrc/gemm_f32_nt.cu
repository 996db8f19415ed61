// The NT products of the f32 branch kernels, x @ W^T with W in torch Linear
// layout (qkv, proj, fc1, fc2), both operands k-contiguous; instantiates
// csrc/gemm_f32_simt.cuh.
#include "gemm_f32_simt.cuh"

namespace ssrl {

cudaError_t gemm_f32_nt(int epi, const float* A, const float* B, const float* bias,
                        const float* R, float* C, float* Z, int M, int N, int K,
                        cudaStream_t st) {
  switch (epi) {
    case F_BIAS: return gemm_f32_mn<true, F_BIAS>(A, B, bias, R, C, Z, M, N, K, st);
    case F_BIAS_GELU: return gemm_f32_mn<true, F_BIAS_GELU>(A, B, bias, R, C, Z, M, N, K, st);
    case F_BIAS_RESID: return gemm_f32_mn<true, F_BIAS_RESID>(A, B, bias, R, C, Z, M, N, K, st);
    case F_BIAS_GELU_Z:
      return gemm_f32_mn<true, F_BIAS_GELU_Z>(A, B, bias, R, C, Z, M, N, K, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ssrl
