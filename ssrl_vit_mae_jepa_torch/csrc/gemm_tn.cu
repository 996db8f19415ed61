// The TN products of the branch kernels, the weight gradients dY^T @ X over
// the B*L rows (dWp, dWqkv, dW2, dW1), both operands MN-major in place,
// split over K into f32 partials (ssrl::gemm_splitk). Instantiates
// csrc/gemm_sm90.cuh; also the C entry that runs one product of any layout
// for the kernel's own checks.
#include "gemm_sm90.cuh"

namespace ssrl {

cudaError_t gemm_tn(const GemmArgs& p, cudaStream_t st) {
  if (p.k_chunk < kGemmBK || p.k_chunk % kGemmBK) return cudaErrorInvalidValue;
  return launch_bn<true, true, EPI_F32>(p, cdiv(p.K, p.k_chunk), st);
}

}  // namespace ssrl

namespace {

// The scratch of ssrl_gemm: TN's split-K partials, or the GELU backward's
// per-M-tile column sums, and reduce_rows' second-pass buffer.
size_t gemm_carve(Carver& c, int layout, int M, int N, int K, float** part, float** tmp) {
  int splits = 1;
  if (layout == ssrl::GEMM_TN) ssrl::gemm_splitk(M, N, K, &splits);
  const size_t rows = layout == ssrl::GEMM_TN ? (size_t)splits * M : (size_t)cdiv(M, kGemmBM);
  *part = c.take<float>(rows * N);
  *tmp = c.take<float>((size_t)64 * N);
  return c.off;
}

}  // namespace

extern "C" {

long long ssrl_gemm_workspace(int layout, int M, int N, int K) {
  Carver c{nullptr};
  float *part, *tmp;
  return (long long)gemm_carve(c, layout, M, N, K, &part, &tmp);
}

// One product C (M x N) of the branch GEMM, contiguous row-major operands:
// layout 0 NT (A [M][K], B [N][K]), 1 NN (A [M][K], B [K][N]), 2 TN (A
// [K][M], B [K][N]); epi as ssrl::Epi, with bias [N], R [M][N], Zin / Zin32
// and Zout / Zout32 [M][N] as the epilogue reads or writes them. TN (EPI_F32)
// writes the whole f32 A^T B into C, its split-K partials summed by
// reduce_rows; the GELU backward epilogues also write the column sums of the
// f32 dz into colsum [N]. ws: ssrl_gemm_workspace bytes.
int ssrl_gemm(int layout, int epi, const void* A, const void* B, void* C, const void* bias,
              const void* R, const void* Zin, void* Zout, const void* Zin32, void* Zout32,
              void* colsum, void* ws, int M, int N, int K, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Carver c{static_cast<char*>(ws)};
  float *part, *tmp;
  gemm_carve(c, layout, M, N, K, &part, &tmp);
  ssrl::GemmArgs g{};
  g.A = static_cast<const bf16*>(A);
  g.B = static_cast<const bf16*>(B);
  g.lda = layout == ssrl::GEMM_TN ? M : K;
  g.ldb = layout == ssrl::GEMM_NT ? K : N;
  g.M = M; g.N = N; g.K = K;
  g.ldc = N;
  g.bias = static_cast<const bf16*>(bias);
  g.R = static_cast<const bf16*>(R);
  g.Zin = static_cast<const bf16*>(Zin);
  g.Zout = static_cast<bf16*>(Zout);
  g.Zin32 = static_cast<const float*>(Zin32);
  g.Zout32 = static_cast<float*>(Zout32);
  g.colpart = part;
  int splits = 1;
  if (layout == ssrl::GEMM_TN) {
    g.k_chunk = ssrl::gemm_splitk(M, N, K, &splits);
    g.C = part;
    g.c_split = (long long)M * N;
  } else {
    g.C = C;
  }
  cudaError_t e = ssrl::gemm(static_cast<ssrl::GemmLayout>(layout), epi, g, st);
  if (e != cudaSuccess) return (int)e;
  if (layout == ssrl::GEMM_TN)
    reduce_rows(part, splits, M * N, static_cast<float*>(C), tmp, st);
  else if (epi == ssrl::EPI_GELU_BWD || epi == ssrl::EPI_GELU32_BWD)
    reduce_rows(part, cdiv(M, kGemmBM), N, static_cast<float*>(colsum), tmp, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
