// The bf16 GEMM of the branch kernels (defined in csrc/gemm_sm90.cuh,
// instantiated in csrc/gemm_{nt,nn,tn}.cu): its three layouts, its eight
// epilogues and its tiling plan.
//
//   C[m][n] = sum_k A(m,k) * B(k,n), bf16 in, f32 accumulate, with
//   NT: A(m,k) = A[m*lda + k], B(k,n) = B[n*ldb + k]   (x @ W^T, forward)
//   NN: A(m,k) = A[m*lda + k], B(k,n) = B[k*ldb + n]   (dY @ W, data grads)
//   TN: A(m,k) = A[k*lda + m], B(k,n) = B[k*ldb + n]   (dY^T @ X, weight
//       grads, K = the B*L rows, split over blocks into f32 partials)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <initializer_list>

namespace ssrl {

enum GemmLayout : int { GEMM_NT = 0, GEMM_NN = 1, GEMM_TN = 2 };

// The epilogues and their rounding contracts. branch.cuh's three callers
// depend on each rounding point.
enum Epi : int {
  EPI_F32 = 0,         // C f32 (split-K partials: + split * c_split)
  EPI_BF16 = 1,        // C = bf16(acc)
  EPI_BIAS_BF16 = 2,   // C = bf16(acc + bias)
  EPI_BIAS_RESID = 3,  // C = bf16(R + bf16(acc + bias))
  EPI_BIAS_GELU = 4,   // z = bf16(acc + bias); C = bf16(gelu(z)); Zout = z
  EPI_GELU_BWD = 5,    // dz = acc * gelu'(Zin); C = bf16(dz); colpart += dz
  EPI_BIAS_GELU32 = 6, // z = acc + bias in f32; C = bf16(gelu(z)); Zout32 = z
  EPI_GELU32_BWD = 7,  // EPI_GELU_BWD with the f32 pre-activation Zin32
};

struct GemmArgs {
  const __nv_bfloat16* A;
  const __nv_bfloat16* B;
  int lda, ldb;
  int M, N, K;
  int k_chunk;             // TN: rows of K per split, a multiple of kGemmBK
  void* C;
  int ldc;
  long long c_split;       // element stride between split-K partials
  const __nv_bfloat16* bias;   // [N]
  const __nv_bfloat16* R;      // residual, [M][ldc]
  const __nv_bfloat16* Zin;    // gelu pre-activation, [M][ldc]
  __nv_bfloat16* Zout;         // gelu pre-activation out, [M][ldc] (may be null)
  const float* Zin32;          // f32 forms of Zin and Zout (EPI_*GELU32*)
  float* Zout32;
  float* colpart;          // [cdiv(M, kGemmBM)][N] column sums of dz
};

// A block's output tile is kGemmBM rows (two warpgroups of 64) by the N
// tile gemm_bn(N); K goes through shared memory kGemmBK at a time.
constexpr int kGemmBM = 128, kGemmBK = 64;

// The N tile: 96, 144 or 192 columns, whichever pads N least (ties to the
// wider): the whole width where it is one of them, else an even split
// (288 = 2 x 144, 384 = 2 x 192, 432 = 3 x 144, 576 = 3 x 192, 768 = 4 x 192).
inline int gemm_bn(int N) {
  int best = 192, pad = -1;
  for (int bn : {192, 144, 96}) {
    const int p = (N + bn - 1) / bn * bn;
    if (pad < 0 || p < pad) {
      best = bn;
      pad = p;
    }
  }
  return best;
}

// Split-K plan of a TN product (M x N output, K rows): enough work units to
// give every SM of an H100 two (264), while each split still covers >= 256
// rows; the chunk is a multiple of kGemmBK, so only the last split is
// ragged. Returns the chunk and writes the number of splits.
inline int gemm_splitk(int M, int N, int K, int* splits) {
  const long long tiles = (long long)((M + kGemmBM - 1) / kGemmBM) *
                          ((N + gemm_bn(N) - 1) / gemm_bn(N));
  long long s = (264 + tiles - 1) / tiles;
  const long long smax = (K + 255) / 256;
  if (s > smax) s = smax;
  if (s < 1) s = 1;
  if (s > 64) s = 64;
  int chunk = (int)((K + s - 1) / s);
  chunk = (chunk + kGemmBK - 1) / kGemmBK * kGemmBK;
  *splits = (K + chunk - 1) / chunk;
  return chunk;
}

// One product. NT and NN take every epilogue of their row of the table
// below; TN takes EPI_F32 with p.k_chunk rows a split (gemm_splitk), its
// partials at C + split * c_split. Any other pairing, or a shape the kernel
// does not take (ldX or N not a multiple of 8, unaligned pointers), returns
// cudaErrorInvalidValue.
//   NT: EPI_F32, EPI_BIAS_BF16, EPI_BIAS_RESID, EPI_BIAS_GELU, EPI_BIAS_GELU32
//   NN: EPI_BF16, EPI_F32, EPI_GELU_BWD, EPI_GELU32_BWD
cudaError_t gemm_nt(int epi, const GemmArgs& p, cudaStream_t st);
cudaError_t gemm_nn(int epi, const GemmArgs& p, cudaStream_t st);
cudaError_t gemm_tn(const GemmArgs& p, cudaStream_t st);

inline cudaError_t gemm(GemmLayout layout, int epi, const GemmArgs& p, cudaStream_t st) {
  if (layout == GEMM_NT) return gemm_nt(epi, p, st);
  if (layout == GEMM_NN) return gemm_nn(epi, p, st);
  if (layout == GEMM_TN && epi == EPI_F32) return gemm_tn(p, st);
  return cudaErrorInvalidValue;
}

}  // namespace ssrl
