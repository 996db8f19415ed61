// The NN products of the f32 branch kernels, dY @ W (da, dy1, dz with the
// GELU backward, dy2): A k-contiguous, B k-major; instantiates
// csrc/gemm_f32_simt.cuh.
#include "gemm_f32_simt.cuh"

namespace ssrl {

cudaError_t gemm_f32_nn(int epi, const float* A, const float* B, const float* bias,
                        const float* R, float* C, float* Z, int M, int N, int K,
                        cudaStream_t st) {
  switch (epi) {
    case F_NONE: return gemm_f32_mn<false, F_NONE>(A, B, bias, R, C, Z, M, N, K, st);
    case F_GELU_BWD: return gemm_f32_mn<false, F_GELU_BWD>(A, B, bias, R, C, Z, M, N, K, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ssrl
