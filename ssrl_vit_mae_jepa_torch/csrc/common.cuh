// Shared device code for the transformer-branch kernels (sm_90a).
//
// The mma.sync / ldmatrix / cp.async helpers of the register-tiled kernels
// (mha.cu, patch_embed.cu), a warp-per-row LayerNorm forward and backward,
// and a deterministic two-pass column reduction that turns per-block f32
// partial sums into weight and bias gradients. The branch kernels' GEMM is
// csrc/gemm.cuh (declarations) and csrc/gemm_sm90.cuh (wgmma + TMA).
//
// Numerics follow the TPU kernels in ssrl_vit_mae_jepa_tpu/ops/block_pallas.py
// (:28-32, :501-533, :573-651): bf16 operands with f32 accumulation, LayerNorm
// statistics in f32 (two-pass, eps 1e-6), bias added in f32 before the single
// rounding to bf16, erf GELU (erf_as: the TPU kernels' rational erf) on the
// bf16-rounded pre-activation (or, for the whole-block kernel, on the f32
// one: block_pallas.py:271).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLnEps = 1e-6f;
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 tobf(float v) { return __float2bfloat16(v); }
// value rounded to bf16 and widened back: the rounding points of the contract
__device__ __forceinline__ float rbf(float v) { return bf(tobf(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// erf by Abramowitz-Stegun 7.1.26 (max abs error 1.5e-7), the TPU branch
// kernels' own (ssrl_vit_mae_jepa_tpu/ops/block_pallas.py::_erf, the GELU of
// _mlp_branch_fwd_kernel and _mlp_branch_bwd_kernel): branch-free, with the
// card's approximate reciprocal and exponential (a few ulp each), exact to
// well below bf16 resolution. The GEMM epilogues take a GELU of every
// element of fc1's output; with erff they took 5-10% longer (H100 80GB
// HBM3, chip_smoke.py's per-GEMM table).
__device__ __forceinline__ float erf_as(float x) {
  const float a = fabsf(x);
  const float t = __fdividef(1.f, fmaf(0.3275911f, a, 1.f));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                       -0.284496736f),
               0.254829592f);
  return copysignf(1.f - poly * __expf(-a * a), x);
}

__device__ __forceinline__ float gelu_f(float z) {
  return 0.5f * z * (1.f + erf_as(z * kInvSqrt2));
}

// d gelu / dz = Phi(z) + z * phi(z)
__device__ __forceinline__ float gelu_grad(float z) {
  const float cdf = 0.5f * (1.f + erf_as(z * kInvSqrt2));
  const float pdf = __expf(-0.5f * z * z) * kInvSqrt2Pi;
  return cdf + z * pdf;
}

// the GEMM's names (gemm.cuh), for the branch sequences
using ssrl::GemmArgs;
using ssrl::kGemmBK;
using ssrl::kGemmBM;
using ssrl::EPI_F32;
using ssrl::EPI_BF16;
using ssrl::EPI_BIAS_BF16;
using ssrl::EPI_BIAS_RESID;
using ssrl::EPI_BIAS_GELU;
using ssrl::EPI_GELU_BWD;
using ssrl::EPI_BIAS_GELU32;
using ssrl::EPI_GELU32_BWD;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) with ldmatrix fragment loads,
// for the kernels that keep their tiles in registers (mha.cu, patch_embed.cu).
// Lane l holds, with g = l / 4 and t = l % 4:
//   A (16 x 16):  a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 8+2t..), a3 (g+8, 8+2t..)
//   B (16 x 8):   b0 (k = 2t..2t+1, n = g), b1 (k = 8+2t.., n = g)
//   C (16 x 8):   c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// so the C tiles of two adjacent 8-column tiles are, packed to bf16, the A
// fragment of the next product over those 16 columns.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// c += a b
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to one bf16 pair, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// The element offset, in a row-major tile of leading dimension ld, whose
// address lane `lane` gives ldmatrix.x4 for the 16 x 16 block at (r0, c0).
//   ld_a: r[0..3] = a0..a3 of that block as an A operand (rows m, columns
//         k), or, with .trans, b0, b1 of columns c0..c0+7 then of
//         c0+8..c0+15 as a B operand stored k-major (rows k, columns n);
//   ld_b: r[0..3] = b0, b1 of rows r0..r0+7 then of r0+8..r0+15 as a B
//         operand stored n-major (rows n, columns k), or, with .trans,
//         a0..a3 as an A operand stored k-major (rows k, columns m).
__device__ __forceinline__ int ld_a(int r0, int c0, int ld, int lane) {
  return (r0 + (lane & 15)) * ld + c0 + ((lane >> 4) << 3);
}
__device__ __forceinline__ int ld_b(int r0, int c0, int ld, int lane) {
  return (r0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 + (((lane >> 3) & 1) << 3);
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// return the error of a launch sequence's step, if any
#define SSRL_TRY(expr)                      \
  do {                                      \
    const cudaError_t e_ = (expr);          \
    if (e_ != cudaSuccess) return e_;       \
  } while (0)

// ---------------------------------------------------------------------------
// Column reduction: out[n] = sum_r in[r][n], two deterministic passes.
// ---------------------------------------------------------------------------

__global__ void colsum_kernel(const float* __restrict__ in, int R, int N,
                              int rows_per_block, float* __restrict__ out) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + tx;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  float s = 0.f;
  if (n < N)
    for (int r = r0 + ty; r < r1; r += 8) s += in[(size_t)r * N + n];
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && n < N) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += red[k][tx];
    out[(size_t)blockIdx.y * N + n] = t;
  }
}

// tmp needs 64 * N floats.
inline void reduce_rows(const float* in, int R, int N, float* out, float* tmp,
                        cudaStream_t st) {
  if (R <= 64) {
    colsum_kernel<<<dim3(cdiv(N, 32), 1), 256, 0, st>>>(in, R, N, R > 0 ? R : 1, out);
    return;
  }
  const int rpb = cdiv(R, 64);
  const int R1 = cdiv(R, rpb);
  colsum_kernel<<<dim3(cdiv(N, 32), R1), 256, 0, st>>>(in, R, N, rpb, tmp);
  colsum_kernel<<<dim3(cdiv(N, 32), 1), 256, 0, st>>>(tmp, R1, N, R1, out);
}

// ---------------------------------------------------------------------------
// LayerNorm, one warp per row, D <= 256 (8 values per lane).
// ---------------------------------------------------------------------------

constexpr int LN_MAXV = 8;
constexpr int LN_WARPS = 8;

__device__ __forceinline__ void ln_stats(const float (&v)[LN_MAXV], int lane,
                                         int D, float* mu, float* inv) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) s += v[i];  // padding lanes hold 0
  const float m = warp_sum(s) / (float)D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    const float d = (lane + 32 * i < D) ? v[i] - m : 0.f;
    q += d * d;
  }
  *mu = m;
  *inv = rsqrtf(warp_sum(q) / (float)D + kLnEps);
}

__global__ void ln_fwd_kernel(const bf16* __restrict__ x,
                              const float* __restrict__ s,
                              const float* __restrict__ b, bf16* __restrict__ y,
                              int M, int D) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * D;
  float v[LN_MAXV];
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < D ? bf(xr[c]) : 0.f;
  }
  float mu, inv;
  ln_stats(v, lane, D, &mu, &inv);
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    const int c = lane + 32 * i;
    if (c < D) y[(size_t)row * D + c] = tobf((v[i] - mu) * inv * s[c] + b[c]);
  }
}

// dx = gy + LN'(dy), written as bf16 and, with DX32, also as f32 (dx32); gy
// is the f32 gy32 with GY32, else the bf16 gy; per-block partial column sums
// of [dy * xhat | dy | gy] -> part[blockIdx.x][3][D]. Compile-time flags, so
// that the branch kernels' <false, false> is the plain bf16 kernel.
template <bool GY32, bool DX32>
__global__ void ln_bwd_kernel(const bf16* __restrict__ x,
                              const float* __restrict__ s,
                              const float* __restrict__ dy,
                              const bf16* __restrict__ gy,
                              const float* __restrict__ gy32,
                              bf16* __restrict__ dx, float* __restrict__ dx32,
                              float* __restrict__ part, int M, int D,
                              int rows_per_block) {
  __shared__ float red[LN_WARPS][3][256];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float as[LN_MAXV], ab[LN_MAXV], ag[LN_MAXV];
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) as[i] = ab[i] = ag[i] = 0.f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(M, r0 + rows_per_block);
  for (int row = r0 + warp; row < r1; row += LN_WARPS) {
    const size_t base = (size_t)row * D;
    float v[LN_MAXV], g0[LN_MAXV], d[LN_MAXV];
#pragma unroll
    for (int i = 0; i < LN_MAXV; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < D ? bf(x[base + c]) : 0.f;
    }
    float mu, inv;
    ln_stats(v, lane, D, &mu, &inv);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < LN_MAXV; ++i) {
      const int c = lane + 32 * i;
      if (c < D) {
        v[i] = (v[i] - mu) * inv;  // xhat
        d[i] = dy[base + c];
        g0[i] = d[i] * s[c];
      } else {
        v[i] = d[i] = g0[i] = 0.f;
      }
      s1 += g0[i];
      s2 += g0[i] * v[i];
    }
    const float m1 = warp_sum(s1) / (float)D;
    const float m2 = warp_sum(s2) / (float)D;
#pragma unroll
    for (int i = 0; i < LN_MAXV; ++i) {
      const int c = lane + 32 * i;
      if (c < D) {
        const float g = GY32 ? gy32[base + c] : bf(gy[base + c]);
        const float r = g + (g0[i] - m1 - v[i] * m2) * inv;
        dx[base + c] = tobf(r);
        if (DX32) dx32[base + c] = r;
        as[i] += d[i] * v[i];
        ab[i] += d[i];
        ag[i] += g;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    const int c = lane + 32 * i;
    if (c < 256) {
      red[warp][0][c] = as[i];
      red[warp][1][c] = ab[i];
      red[warp][2][c] = ag[i];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 3 * D; j += blockDim.x) {
    const int k = j / D, c = j - k * D;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < LN_WARPS; ++w) t += red[w][k][c];
    part[(size_t)blockIdx.x * 3 * D + j] = t;
  }
}

inline int ln_bwd_blocks(int M) {
  int n = cdiv(M, LN_WARPS * 4);
  return n < 1024 ? n : 1024;
}

inline void launch_ln_fwd(const bf16* x, const float* s, const float* b,
                          bf16* y, int M, int D, cudaStream_t st) {
  ln_fwd_kernel<<<cdiv(M, LN_WARPS), 32 * LN_WARPS, 0, st>>>(x, s, b, y, M, D);
}

// LN backward + reduction of its [ds | db | sum(gy)] partials into out3 (3*D).
inline void launch_ln_bwd(const bf16* x, const float* s, const float* dy,
                          const bf16* gy, const float* gy32, bf16* dx, float* dx32,
                          float* out3, float* part, float* tmp, int M, int D,
                          cudaStream_t st) {
  const int nb = ln_bwd_blocks(M);
  const int rpb = cdiv(M, nb);
  auto kernel = gy32 ? (dx32 ? &ln_bwd_kernel<true, true> : &ln_bwd_kernel<true, false>)
                     : (dx32 ? &ln_bwd_kernel<false, true> : &ln_bwd_kernel<false, false>);
  kernel<<<nb, 32 * LN_WARPS, 0, st>>>(x, s, dy, gy, gy32, dx, dx32, part, M, D, rpb);
  reduce_rows(part, nb, 3 * D, out3, tmp, st);
}

// Bytes rounded up so that every carved buffer starts 256-byte aligned.
inline size_t align256(size_t b) { return (b + 255) & ~(size_t)255; }

struct Carver {
  char* p;
  size_t off = 0;
  template <typename T>
  T* take(size_t n) {
    T* r = p ? reinterpret_cast<T*>(p + off) : nullptr;
    off += align256(n * sizeof(T));
    return r;
  }
};

}  // namespace
