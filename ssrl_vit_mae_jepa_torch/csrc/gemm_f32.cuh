// The f32 GEMM of the f32 branch kernels (defined in csrc/gemm_f32_simt.cuh,
// instantiated in csrc/gemm_f32_{nt,nn,tn}.cu): its layouts, its epilogues
// and its tiling plans. Every product of csrc/branch_f32.cu (and through
// csrc/branch_f32.cuh of fused_block_f32.cu and block_chain_f32.cu) is one
// call of it.
//
//   C[m][n] = sum_k A(m,k) * B(k,n), f32 in, f32 FFMA accumulation over k in
//   ascending order, no TF32; the layouts of gemm.cuh:
//   NT: A[M][K], B[N][K]   (x @ W^T)      NN: A[M][K], B[K][N]   (dY @ W)
//   TN: A[K][M], B[K][N]   (dY^T @ X over the B*L rows, split over K into
//       f32 partials summed in one fixed order; no atomics)
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "gemm.cuh"

namespace ssrl {

// The epilogues, applied to the f32 sum in registers (F_NONE writes it as
// it is: the data gradients and the TN partials).
enum F32Epi : int {
  F_NONE = 0,
  F_BIAS,         // C = acc + bias
  F_BIAS_GELU,    // C = gelu(acc + bias)
  F_BIAS_RESID,   // C = R + (acc + bias)
  F_BIAS_GELU_Z,  // Z = acc + bias; C = gelu(Z)
  F_GELU_BWD,     // C = acc * gelu'(R), R the pre-activation
};

// One NT or NN product C[M][N] (row length N) with its epilogue: bias [N],
// R [M][N] (the residual, or the GELU backward's pre-activation), Z [M][N]
// (F_BIAS_GELU_Z's pre-activation out). Any M, N, K >= 1. NT takes F_BIAS,
// F_BIAS_GELU, F_BIAS_RESID and F_BIAS_GELU_Z, NN F_NONE and F_GELU_BWD;
// any other layout or epilogue returns cudaErrorInvalidValue.
cudaError_t gemm_f32_nt(int epi, const float* A, const float* B, const float* bias,
                        const float* R, float* C, float* Z, int M, int N, int K,
                        cudaStream_t st);
cudaError_t gemm_f32_nn(int epi, const float* A, const float* B, const float* bias,
                        const float* R, float* C, float* Z, int M, int N, int K,
                        cudaStream_t st);

inline cudaError_t gemm_f32(GemmLayout layout, int epi, const float* A, const float* B,
                            const float* bias, const float* R, float* C, float* Z, int M,
                            int N, int K, cudaStream_t st) {
  if (layout == GEMM_NT) return gemm_f32_nt(epi, A, B, bias, R, C, Z, M, N, K, st);
  if (layout == GEMM_NN) return gemm_f32_nn(epi, A, B, bias, R, C, Z, M, N, K, st);
  return cudaErrorInvalidValue;
}

// out[M][N] = A^T B over the K rows (A [K][M], B [K][N]): split over K into
// `part` (gemm_tn_f32_part_floats floats), then summed in one fixed order.
cudaError_t gemm_tn_f32(const float* A, const float* B, float* out, float* part, int M, int N,
                        int K, cudaStream_t st);
size_t gemm_tn_f32_part_floats(int M, int N, int K);


}  // namespace ssrl
