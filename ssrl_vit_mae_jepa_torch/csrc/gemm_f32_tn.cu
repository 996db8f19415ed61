// The TN products of the f32 branch kernels, the weight gradients dY^T @ X
// over the B*L rows (dWp, dWqkv, dW2, dW1): both operands k-major, split
// over K into f32 partials, then folded in one fixed order. Instantiates
// csrc/gemm_f32_simt.cuh; also the C entry that runs one f32 product of any
// layout for the kernel's own checks.
#include "gemm_f32_simt.cuh"

namespace {

// out = the sum of part[z][R][C] over the S splits, in one fixed order:
// thread row ty sums splits ty, ty + 8, ... in turn, then the eight sums
// are added in ty order; with `trans`, out is [C][R] (the plan swapped A
// and B).
__global__ void tn_fold_kernel(const float* __restrict__ part, int S, int R, int C, int trans,
                               float* __restrict__ out) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const size_t RC = (size_t)R * C;
  const size_t e = (size_t)blockIdx.x * 32 + tx;
  float s = 0.f;
  if (e < RC)
    for (int z = ty; z < S; z += 8) s += part[(size_t)z * RC + e];
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && e < RC) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += red[k][tx];
    const size_t r = e / C, c = e % C;
    out[trans ? c * R + r : e] = t;
  }
}

}  // namespace

namespace ssrl {

size_t gemm_tn_f32_part_floats(int M, int N, int K) {
  return (size_t)f32_plan_tn(M, N, K).splits * M * N;
}

cudaError_t gemm_tn_f32(const float* A, const float* B, float* out, float* part, int M, int N,
                        int K, cudaStream_t st) {
  if (M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
  const F32Plan plan = f32_plan_tn(M, N, K);
  const bool vec = M % 4 == 0 && N % 4 == 0 && aligned16(A) && aligned16(B) && aligned16(part);
  // the block's rows are out's rows, or with `swap` its columns
  const F32Args p{plan.swap ? B : A, plan.swap ? A : B, nullptr, nullptr, part, nullptr,
                  plan.swap ? N : M, plan.swap ? M : N, K, plan.chunk};
  SSRL_TRY((launch_plan<false, false, F_NONE>(p, plan.wm, plan.wn, vec, plan.splits, st)));
  tn_fold_kernel<<<cdiv((long long)M * N, 32), 256, 0, st>>>(part, plan.splits, p.M, p.N,
                                                             plan.swap, out);
  return cudaGetLastError();
}

}  // namespace ssrl

namespace {

// The scratch of ssrl_gemm_f32: TN's partials, or reduce_rows' second-pass
// buffer for the GELU backward's column sums.
size_t gemm_f32_carve(Carver& c, int layout, int M, int N, int K, float** part, float** tmp) {
  *part = layout == ssrl::GEMM_TN ? c.take<float>(ssrl::gemm_tn_f32_part_floats(M, N, K))
                                  : nullptr;
  *tmp = c.take<float>((size_t)64 * N);
  return c.off;
}

}  // namespace

extern "C" {

long long ssrl_gemm_f32_workspace(int layout, int M, int N, int K) {
  Carver c{nullptr};
  float *part, *tmp;
  return (long long)gemm_f32_carve(c, layout, M, N, K, &part, &tmp);
}

// One f32 product C (M x N) of the f32 branch GEMM, contiguous row-major
// operands, layouts as ssrl_gemm's (0 NT, 1 NN, 2 TN) and epi as
// ssrl::Epi read at f32, where every rounding is a no-op: NT takes
// EPI_BIAS_BF16 (C = acc + bias), EPI_BIAS_RESID (R + (acc + bias)) and
// EPI_BIAS_GELU / EPI_BIAS_GELU32 (Zout = acc + bias, C = gelu(Zout)); NN
// EPI_F32 / EPI_BF16 (C = acc) and EPI_GELU_BWD / EPI_GELU32_BWD (C = acc *
// gelu'(Zin), and colsum [N] = the column sums of C by reduce_rows); TN
// EPI_F32 (the whole A^T B, its partials folded). Any other pairing returns
// cudaErrorInvalidValue. ws: ssrl_gemm_f32_workspace bytes.
int ssrl_gemm_f32(int layout, int epi, const void* A, const void* B, void* C, const void* bias,
                  const void* R, const void* Zin, void* Zout, void* colsum, void* ws, int M,
                  int N, int K, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Carver c{static_cast<char*>(ws)};
  float *part, *tmp;
  gemm_f32_carve(c, layout, M, N, K, &part, &tmp);
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  float* out = static_cast<float*>(C);
  const float* bs = static_cast<const float*>(bias);
  if (layout == ssrl::GEMM_TN)
    return (int)(epi == ssrl::EPI_F32 ? ssrl::gemm_tn_f32(a, b, out, part, M, N, K, st)
                                      : cudaErrorInvalidValue);
  if (layout == ssrl::GEMM_NT) {
    int f = -1;
    if (epi == ssrl::EPI_BIAS_BF16) f = F_BIAS;
    if (epi == ssrl::EPI_BIAS_RESID) f = F_BIAS_RESID;
    if (epi == ssrl::EPI_BIAS_GELU || epi == ssrl::EPI_BIAS_GELU32) f = F_BIAS_GELU_Z;
    if (f < 0) return (int)cudaErrorInvalidValue;
    return (int)ssrl::gemm_f32_nt(f, a, b, bs, static_cast<const float*>(R), out,
                                  static_cast<float*>(Zout), M, N, K, st);
  }
  if (layout != ssrl::GEMM_NN) return (int)cudaErrorInvalidValue;
  if (epi == ssrl::EPI_F32 || epi == ssrl::EPI_BF16)
    return (int)ssrl::gemm_f32_nn(F_NONE, a, b, nullptr, nullptr, out, nullptr, M, N, K, st);
  if (epi != ssrl::EPI_GELU_BWD && epi != ssrl::EPI_GELU32_BWD) return (int)cudaErrorInvalidValue;
  const cudaError_t e = ssrl::gemm_f32_nn(F_GELU_BWD, a, b, nullptr,
                                          static_cast<const float*>(Zin), out, nullptr, M, N, K,
                                          st);
  if (e != cudaSuccess) return (int)e;
  reduce_rows(out, M, N, static_cast<float*>(colsum), tmp, st);
  return (int)cudaGetLastError();
}


}  // extern "C"
