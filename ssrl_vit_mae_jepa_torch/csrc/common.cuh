// Shared device code for the transformer-branch kernels (sm_90a).
//
// The mma.sync / ldmatrix / cp.async helpers of the register-tiled kernels
// (mha.cu, patch_embed.cu), a warp-per-row LayerNorm forward, the LayerNorm
// backward (bf16 and f32, its column sums folded in its one launch), and a
// deterministic two-pass column reduction that turns per-block f32 partial
// sums into weight and bias gradients. The branch kernels' GEMM is
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

#include <type_traits>

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

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

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

inline void launch_ln_fwd(const bf16* x, const float* s, const float* b,
                          bf16* y, int M, int D, cudaStream_t st) {
  ln_fwd_kernel<<<cdiv(M, LN_WARPS), 32 * LN_WARPS, 0, st>>>(x, s, b, y, M, D);
}

// ---------------------------------------------------------------------------
// LayerNorm backward, D <= 256, bf16 or f32, in one launch:
//   dx = gy + LN'(dy) (bf16 and, with DX32, also f32; or f32), and the column
//   sums out3 = [sum dy * xhat | sum dy | sum gy] (d scale, d bias, and the
//   branch output's bias gradient).
// Replaces the LN backward that ends the TPU branch kernels
// (ssrl_vit_mae_jepa_tpu/ops/block_pallas.py::_ln_bwd, :187, used at :611
// and :648).
//
// What bounds it on the H100: bytes. It reads x, gy and the f32 dy and
// writes dx once (10 B an element in bf16, 16 at f32) for ~20 flops an
// element. The design moves them in 16-byte accesses with many rows in
// flight, in one launch:
//   - a thread owns 8 consecutive columns of a row (x, gy, dx one 16-byte
//     access each in bf16, dy, s two), a row is G = ceil(D / 8) consecutive
//     threads and a block of 256 holds RB = 256 / G rows side by side (at
//     D = 144, 252 threads of 256 work, not 18 of each warp of 32);
//   - a thread takes LNB_U rows a step (the block LNB_U RB) and loads
//     them all before it reduces any; x-hat stays in registers;
//   - a row's sums are a segmented scan over the warp (its threads are
//     consecutive) plus, where the row straddles two warps, the second
//     warp's piece through shared memory, one barrier a reduction; a step
//     takes two: the sum of x, then together the sum of squares about the
//     mean, of g0 = dy s and of g0 (x - mean), whose mean times 1 / std is
//     that of g0 x-hat; two buffers in turn, so none between steps;
//   - a thread sums its 8 columns over its rows in registers; the block
//     folds them over its RB rows in shared memory and writes its partial;
//     the last block of each group of LNB_GROUP to finish (a counter the
//     host zeroes with a memset before the launch) folds the group's
//     partials in block order, and the last group to finish folds the
//     groups' in group order into out3. No atomics on the sums: every call
//     gives the same bits, a CUDA-graph replay those of the eager call.
// Statistics: two-pass f32, eps 1e-6; 1 / sqrt at f32 (ln_f32_kernel's),
// rsqrt in bf16 (ln_stats'); dx rounded once. A width that is not a
// multiple of 8, or a pointer not 16-byte aligned, takes the same kernel
// with element loads (VEC false).
// ---------------------------------------------------------------------------

constexpr int LNB_THREADS = 256;
constexpr int LNB_U = 2;                         // rows a thread takes a step
constexpr int LNB_SM_BLOCKS = 2;                 // blocks an SM holds at once
constexpr int LNB_MAX_BLOCKS = 132 * LNB_SM_BLOCKS;  // one wave on the 132 SMs
constexpr int LNB_GROUP = 16;        // blocks whose partials one block folds
// the done counters: one a group, one for the groups
constexpr int LNB_DONE = (LNB_MAX_BLOCKS + LNB_GROUP - 1) / LNB_GROUP + 1;

struct LnBwdPlan {
  int G;       // threads a row: ceil(D / 8)
  int RB;      // rows side by side in a block
  int rpb;     // rows a block (the last may have fewer)
  int blocks;  // the grid
  int groups;  // cdiv(blocks, LNB_GROUP)
};

inline LnBwdPlan ln_bwd_plan(int M, int D) {
  LnBwdPlan p;
  p.G = (D + 7) / 8;
  p.RB = LNB_THREADS / p.G;
  const int steps = cdiv(M, p.RB * LNB_U);
  const int nb = steps < 1 ? 1 : (steps < LNB_MAX_BLOCKS ? steps : LNB_MAX_BLOCKS);
  p.rpb = M > nb ? cdiv(M, nb) : 1;
  p.blocks = M > 0 ? cdiv(M, p.rpb) : 1;
  p.groups = cdiv(p.blocks, LNB_GROUP);
  return p;
}

// Floats of the backward's `part`: the blocks' partials, then the groups'.
// Its `tmp` holds the groups + 1 <= LNB_DONE done counters.
inline size_t ln_bwd_part_floats(int M, int D) {
  const LnBwdPlan p = ln_bwd_plan(M, D);
  return (size_t)(p.blocks + p.groups) * 3 * D;
}

// 8 values from p (n valid, the rest 0): one 16-byte load of bf16 or two of
// f32 with VEC, else element loads.
template <bool VEC>
__device__ __forceinline__ void ld8(const bf16* p, int n, float (&v)[8]) {
  if (VEC) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const bf16* h = reinterpret_cast<const bf16*>(&q);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = bf(h[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < n ? bf(p[j]) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void ld8(const float* p, int n, float (&v)[8]) {
  if (VEC) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < n ? p[j] : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void st8(bf16* p, int n, const float (&v)[8]) {
  if (VEC) {
    uint4 q;
    q.x = pack_bf16(v[0], v[1]); q.y = pack_bf16(v[2], v[3]);
    q.z = pack_bf16(v[4], v[5]); q.w = pack_bf16(v[6], v[7]);
    *reinterpret_cast<uint4*>(p) = q;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n) p[j] = tobf(v[j]);
  }
}

template <bool VEC>
__device__ __forceinline__ void st8(float* p, int n, const float (&v)[8]) {
  if (VEC) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n) p[j] = v[j];
  }
}

// Where a thread sits in the block's rows, for the row sums.
struct LnRowLane {
  unsigned take;  // bit i: add the value of thread tid - 2^i (same row, same warp)
  bool seg_end;   // the last thread of its row in its warp
  int piece;      // 1 in the second warp of a row that straddles two
  bool two;       // the row straddles two warps
};

__device__ __forceinline__ LnRowLane ln_row_lane(int tid, int G, int ri) {
  LnRowLane r;
  const int lane = tid & 31;
  r.take = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i)
    if (lane >= (1 << i) && (tid - (1 << i)) / G == ri) r.take |= 1u << i;
  r.seg_end = lane == 31 || (tid + 1) / G != ri;
  r.piece = (tid >> 5) != ((ri * G) >> 5);
  r.two = ((ri * G) >> 5) != ((ri * G + G - 1) >> 5);
  return r;
}

// v[u][0..N) summed over each row's G threads, in one fixed order (the
// scan's, then the first warp's piece plus the second's); every thread of a
// row ends with its totals. red: one buffer, [2 pieces][LNB_U][3][
// LNB_THREADS]; the caller takes two in turn, so one barrier a call.
template <int N>
__device__ __forceinline__ void ln_row_sums(float (&v)[LNB_U][3], float* red,
                                            const LnRowLane& rl, int ri, bool live) {
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int u = 0; u < LNB_U; ++u)
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float o = __shfl_up_sync(0xffffffffu, v[u][k], 1 << i);
        if (rl.take >> i & 1u) v[u][k] += o;
      }
  constexpr int P = LNB_U * 3 * LNB_THREADS;  // one piece
  if (live && rl.seg_end) {
#pragma unroll
    for (int u = 0; u < LNB_U; ++u)
#pragma unroll
      for (int k = 0; k < N; ++k) red[rl.piece * P + (u * 3 + k) * LNB_THREADS + ri] = v[u][k];
  }
  __syncthreads();
  if (live) {
#pragma unroll
    for (int u = 0; u < LNB_U; ++u)
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int i = (u * 3 + k) * LNB_THREADS + ri;
        v[u][k] = rl.two ? red[i] + red[P + i] : red[i];
      }
  }
}

// T: bf16 (x, gy, dx; gy32 the f32 gy with GY32, dx32 an f32 copy of dx
// with DX32) or float (GY32, DX32 false).
template <typename T, bool GY32, bool DX32, bool VEC>
__global__ void __launch_bounds__(LNB_THREADS, LNB_SM_BLOCKS)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ s,
              const float* __restrict__ dy, const T* __restrict__ gy,
              const float* __restrict__ gy32, T* __restrict__ dx, float* __restrict__ dx32,
              float* __restrict__ part, unsigned* __restrict__ done, float* __restrict__ out3,
              int M, int D, LnBwdPlan p) {
  using G32 = typename std::conditional<GY32, float, T>::type;  // gy as it is stored
  // ln_row_sums' two buffers; after the rows, the block's fold [RB][3][8G]
  __shared__ float red[2 * 2 * LNB_U * 3 * LNB_THREADS];
  __shared__ unsigned last;
  constexpr int BUF = 2 * LNB_U * 3 * LNB_THREADS;
  const int tid = threadIdx.x;
  const int G = p.G, RB = p.RB;
  const int ri = tid / G, c0 = 8 * (tid - ri * G);
  const bool live = ri < RB;
  const int n = live ? min(8, D - c0) : 0;
  const LnRowLane rl = ln_row_lane(tid, G, ri);
  const G32* gsrc;
  if constexpr (GY32) gsrc = gy32;
  else gsrc = gy;
  const float invD = 1.f / (float)D;
  float sc[8], as[8], ab[8], ag[8];
  if (live) {
    ld8<VEC>(s + c0, n, sc);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) as[j] = ab[j] = ag[j] = 0.f;

  const int r0 = blockIdx.x * p.rpb;
  const int r1 = min(M, r0 + p.rpb);
  for (int base = r0; base < r1; base += RB * LNB_U) {
    float xv[LNB_U][8], dv[LNB_U][8], gv[LNB_U][8];
    bool ok[LNB_U];
#pragma unroll
    for (int u = 0; u < LNB_U; ++u) {
      const int r = base + u * RB + ri;
      ok[u] = live && r < r1;
      if (ok[u]) {
        const size_t off = (size_t)r * D + c0;
        ld8<VEC>(x + off, n, xv[u]);
        ld8<VEC>(dy + off, n, dv[u]);
        ld8<VEC>(gsrc + off, n, gv[u]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) xv[u][j] = dv[u][j] = gv[u][j] = 0.f;
      }
    }
    // the mean
    float t[LNB_U][3], mu[LNB_U];
#pragma unroll
    for (int u = 0; u < LNB_U; ++u) {
      t[u][0] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) t[u][0] += xv[u][j];
    }
    ln_row_sums<1>(t, red, rl, ri, live);
    // the sums of (x - mean)^2, g0 and g0 (x - mean)
#pragma unroll
    for (int u = 0; u < LNB_U; ++u) {
      mu[u] = t[u][0] / (float)D;
      t[u][0] = t[u][1] = t[u][2] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = (VEC || j < n) ? xv[u][j] - mu[u] : 0.f;
        const float g0 = dv[u][j] * sc[j];
        t[u][0] += d * d;
        t[u][1] += g0;
        t[u][2] += g0 * d;
      }
    }
    ln_row_sums<3>(t, red + BUF, rl, ri, live);
#pragma unroll
    for (int u = 0; u < LNB_U; ++u) {
      if (!ok[u]) continue;
      const float var = t[u][0] / (float)D + kLnEps;
      const float inv = sizeof(T) == 4 ? 1.f / sqrtf(var) : rsqrtf(var);
      const float m1 = t[u][1] / (float)D, m2 = t[u][2] * invD * inv;
      float r[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xh = (xv[u][j] - mu[u]) * inv;
        const float g0 = dv[u][j] * sc[j];
        r[j] = gv[u][j] + (g0 - m1 - xh * m2) * inv;
        as[j] += dv[u][j] * xh;
        ab[j] += dv[u][j];
        ag[j] += gv[u][j];
      }
      const size_t off = (size_t)(base + u * RB + ri) * D + c0;
      st8<VEC>(dx + off, n, r);
      if (DX32) st8<VEC>(dx32 + off, n, r);
    }
  }
  __syncthreads();  // red is free: the fold goes over it

  // the block's partial: its rows' column sums, folded in row order
  float* fold = red;  // [RB][3][8G]: at most 24 * LNB_THREADS floats
  const int W = 8 * G;
  if (live) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      fold[(ri * 3 + 0) * W + c0 + j] = as[j];
      fold[(ri * 3 + 1) * W + c0 + j] = ab[j];
      fold[(ri * 3 + 2) * W + c0 + j] = ag[j];
    }
  }
  __syncthreads();
  const int D3 = 3 * D;
  for (int j = tid; j < D3; j += LNB_THREADS) {
    const int k = j / D, c = j - k * D;
    float a = 0.f;
    for (int r = 0; r < RB; ++r) a += fold[(r * 3 + k) * W + c];
    part[(size_t)blockIdx.x * D3 + j] = a;
  }

  // the last block of its group folds the group's partials in block order
  const int g = blockIdx.x / LNB_GROUP;
  const int b0 = g * LNB_GROUP, b1 = min(p.blocks, b0 + LNB_GROUP);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&done[g], 1u) == (unsigned)(b1 - b0 - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* gdst = p.groups == 1 ? out3 : part + (size_t)(p.blocks + g) * D3;
  for (int j = tid; j < D3; j += LNB_THREADS) {
    float a = 0.f;
    for (int b = b0; b < b1; ++b) a += __ldcg(part + (size_t)b * D3 + j);
    gdst[j] = a;
  }
  if (p.groups == 1) return;

  // the last group to finish folds the groups' partials in group order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&done[p.groups], 1u) == (unsigned)(p.groups - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* gp = part + (size_t)p.blocks * D3;
  for (int j = tid; j < D3; j += LNB_THREADS) {
    float a = 0.f;
    for (int q = 0; q < p.groups; ++q) a += __ldcg(gp + (size_t)q * D3 + j);
    out3[j] = a;
  }
}

// The LN backward of x [M][D] (D <= 256): part takes ln_bwd_part_floats(M,
// D) floats, tmp the done counters (its first groups + 1 ints, zeroed here).
template <typename T, bool GY32, bool DX32>
cudaError_t ln_bwd(const T* x, const float* s, const float* dy, const T* gy,
                   const float* gy32, T* dx, float* dx32, float* out3, float* part,
                   float* tmp, int M, int D, cudaStream_t st) {
  if (M < 1 || D < 1 || D > 256) return cudaErrorInvalidValue;
  const LnBwdPlan p = ln_bwd_plan(M, D);
  unsigned* done = reinterpret_cast<unsigned*>(tmp);
  SSRL_TRY(cudaMemsetAsync(done, 0, (size_t)(p.groups + 1) * sizeof(unsigned), st));
  const bool vec = D % 8 == 0 && aligned16(x) && aligned16(s) && aligned16(dy) &&
                   aligned16(GY32 ? (const void*)gy32 : (const void*)gy) && aligned16(dx) &&
                   (!DX32 || aligned16(dx32));
  auto kernel = vec ? &ln_bwd_kernel<T, GY32, DX32, true> : &ln_bwd_kernel<T, GY32, DX32, false>;
  kernel<<<p.blocks, LNB_THREADS, 0, st>>>(x, s, dy, gy, gy32, dx, dx32, part, done, out3, M,
                                           D, p);
  return cudaGetLastError();
}

// dx = gy + LN'(dy) in bf16 (and, with dx32 set, f32) from the bf16 gy or,
// where gy32 is set, the f32 one; out3 (3*D) = [d scale | d bias | sum gy].
inline void launch_ln_bwd(const bf16* x, const float* s, const float* dy,
                          const bf16* gy, const float* gy32, bf16* dx, float* dx32,
                          float* out3, float* part, float* tmp, int M, int D,
                          cudaStream_t st) {
  if (gy32)
    dx32 ? ln_bwd<bf16, true, true>(x, s, dy, gy, gy32, dx, dx32, out3, part, tmp, M, D, st)
         : ln_bwd<bf16, true, false>(x, s, dy, gy, gy32, dx, dx32, out3, part, tmp, M, D, st);
  else
    dx32 ? ln_bwd<bf16, false, true>(x, s, dy, gy, gy32, dx, dx32, out3, part, tmp, M, D, st)
         : ln_bwd<bf16, false, false>(x, s, dy, gy, gy32, dx, dx32, out3, part, tmp, M, D, st);
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
