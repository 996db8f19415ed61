// Multi-head attention in f32 on Hopper (sm_90a): o = softmax(q k^T * s) v
// and its backward (dq, dk, dv) from (q, k, v, dO), over strided f32
// tensors (the layouts and the two scale contracts are described in mha.cuh).
//
// Replaces the f32 instantiation of the TPU kernels
//   ops/attention_pallas_stacked.py  _fwd_qkv (:440) / _bwd_qkv (:461)  fused (B, L, 3D) qkv
//   ops/attention_pallas_stacked.py  _fwd (:380) / _bwd (:401)          three (B, L, D)
//   ops/attention_pallas_packed.py   _fwd (:161) / _bwd (:186)          three (B, L, D)
//   ops/attention_pallas.py          _mha_fwd (:144) / _mha_bwd (:166)  (B, H, L, d), post-scaled
// (paths under ssrl_vit_mae_jepa_tpu/), and is the attention core of the f32
// attention branch in branch_f32.cu. The bf16 kernels are mha.cu.
//
// Numerics contract (the TPU kernels at f32, where every cast is a no-op):
// f32 operands and accumulation on the CUDA cores, no TF32; pre-scaled: q *
// scale in f32, then QK^T; post-scaled: QK^T, then * scale; softmax in f32
// with the row max subtracted (expf, division by the row sum); dS = P o (dP -
// rowsum(dP o P)); dq = (dS K) * scale; dk = dS^T q_s (pre) or (dS^T q) *
// scale (post); dv = P^T dO. The plain versions are ops/attention_core.py::
// plain_fwd / plain_bwd_f32 at f32.
//
// What bounds it on the H100: the products run on the CUDA cores (67
// TFLOP/s without TF32). A head does 4 L^2 d operations forward and 10 L^2
// d backward against 16 L d bytes (forward) and 28 L d (backward) of f32
// q, k, v, o (dO, dq, dk, dv): ~9 operations a byte forward at L = 145,
// below the card's f32 ridge of 67e12 / 3.35e12 = 20, so the floor is the
// bytes; but a SIMT product feeds each FMA from registers that it has to
// load from shared memory first, so what keeps a kernel from the floor is
// the shared-memory loads and instructions per FMA, and latency.
//
// What this design does about it: the bf16 core's schedule (mha.cu) with
// its products as SIMT register micro-tiles. Nothing L x L is stored. A
// block takes G heads and W warps (plan_for): at L = 145 one head and 10
// warps of one 16-row strip each, at L = 37 two heads and 6 warps.
// Shared memory holds each head's k, v (and, backward, q and dO) as exact L
// rows of d floats padded to a multiple of 4 (DP), loaded once by 16-byte
// cp.async; a row is an odd number of 16-byte units (ld_of), so the eight
// consecutive rows that a warp reads at once fall in eight bank quads.
// Every product is a warp's 16 x 32 tile, lane (rg, cg) = (lane / 8, lane %
// 8) holding rows 4 rg .. 4 rg + 3 and columns cg, cg + 8, cg + 16, cg + 24
// in 16 registers: each float4 step over d loads 4 + 4 float4 and does 64
// FMA (the 4 row loads are broadcasts). The second product of a pass (P V,
// dS K, P^T dO, dS^T q) goes through a 32 x 16 tile that the warp stages in
// its own 2.5 KB of shared memory: lane (rg, cg) then accumulates rows 4 rg
// .. + 3 and columns cg NC .. cg NC + NC - 1 (NC = DP / 8 rounded up), one
// float4 of P and NC floats of the operand for 4 NC FMA.
//  - forward, per query strip: q staged in the warp's own shared memory
//    (scaled, pre-scaled contract); one pass over 32-key tiles with the row
//    max kept as it grows and the output and the lanes' row sums rescaled by
//    exp(m_old - m_new) (the exact softmax, only summed in another order);
//    o = acc / l, normalised by division at the end.
//  - backward, phase A per query strip, two passes over 32-key tiles: each
//    lane's row max, sum of exp(s - m) and sum of exp(s - m) dP, joined over
//    the 8 lanes of a row (D_i = rowsum(dP o P) = u / l); then P, dS and dQ =
//    dS K. The statistics (3 L floats) go to shared memory.
//  - backward, phase B per 16-key strip: S^T and dP^T again per 32-query
//    tile (the same FMAs in the same order as phase A's S, so the same bits),
//    P^T and dS^T from the statistics, dV = P^T dO and dK = dS^T q in
//    registers, written once.
// At (145, 32) a block has 90 KB (forward) or 111 KB (backward) of shared
// memory and 96 registers a thread, so 2 blocks of 10 warps share an SM
// (the first version's backward: 99.5 KB for 8 warps, 16 warps an SM).
// Head dims above 32 loop over output chunks of 32 columns, recomputing the
// scores, so the fit (shared memory alone) holds every shape the first
// version took. exp is expf, the division that normalises P is exact. No
// atomics: every sum has one fixed order (the 8-lane joins are xor
// butterflies, which give every lane the same bits), so two calls give the
// same bits and a CUDA-graph replay the eager step's.
#include <math.h>

#include "common.cuh"
#include "mha.cuh"

namespace {

using Args = ssrl::MhaArgsT<float>;

constexpr int MAX_WARPS = 10;
// registers a thread: two blocks of 10 warps per SM (the backward spills a
// few hundred bytes at this cap; 168 without spills leaves 10 warps per SM
// and ran 7% slower at (145, 32) on the H100)
constexpr int REGS = 96;
constexpr int STRIP = 16;         // rows of a warp's strip: 4 row groups x 4 rows
constexpr int TILE = 32;          // columns of a tile: 8 lanes x 4, 8 apart
constexpr int PLD = STRIP + 4;    // row stride of a warp's staged 32 x 16 tile
constexpr int STAGE = TILE * PLD;  // floats of that tile
constexpr size_t kMaxShared = 232448;  // the H100's 227 KB a block

// the head dim padded to float4 steps, and a shared row: an odd number of
// 16-byte units, so that rows r .. r + 7 start in 8 different bank quads
__host__ __device__ inline int dp_of(int d) { return (d + 3) & ~3; }
__host__ __device__ inline int ld_of(int d) {
  const int p = dp_of(d);
  return (p / 4) % 2 ? p : p + 4;
}

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~(size_t)3; }

// G (image, head) pairs per block and W warps over their G * NS strips.
struct Plan {
  int G, W;
};

// floats of shared memory: forward, k and v of G heads, then per warp its q
// strip and staged tile; backward, q, k, v, dO of G heads, their statistics,
// then per warp its tile (+4: the last lanes' NC-float loads may read past a
// row's DP floats)
inline size_t smem_floats(bool bwd, int L, int d, const Plan& p) {
  const size_t ld = ld_of(d);
  if (bwd) return 4 * p.G * (size_t)L * ld + round4(3 * (size_t)p.G * L) + p.W * STAGE + 4;
  return 2 * p.G * (size_t)L * ld + p.W * (STRIP * ld + STAGE) + 4;
}

// One head and at most 8 warps of equal share from NS = 6 strips, else G = 6
// / NS heads of one strip a warp; fewer heads, then fewer warps, where that
// overflows a block's shared memory (long sequences at large head dims).
inline Plan plan_for(bool bwd, int L, int d) {
  const int NS = (L + STRIP - 1) / STRIP;
  Plan p{1, 1};
  if (NS >= 6) {
    const int per = (NS + MAX_WARPS - 1) / MAX_WARPS;
    p.W = (NS + per - 1) / per;
  } else {
    p.G = 6 / NS;
    p.W = p.G * NS;
  }
  while (p.G > 1 && smem_floats(bwd, L, d, p) * sizeof(float) > kMaxShared) p.W = --p.G * NS;
  while (p.W > 1 && smem_floats(bwd, L, d, p) * sizeof(float) > kMaxShared) --p.W;
  return p;
}

__device__ __forceinline__ size_t in_base(const Args& a, int p) {
  const int b = p / a.H, h = p - (p / a.H) * a.H;
  return (size_t)b * a.in_b + (size_t)h * a.in_h;
}
__device__ __forceinline__ size_t out_base(const Args& a, int p) {
  const int b = p / a.H, h = p - (p / a.H) * a.H;
  return (size_t)b * a.out_b + (size_t)h * a.out_h;
}

// Rows [0, n) of a strided (rows, d) f32 matrix (row stride rs) into shared
// rows of ld floats; columns [d, DP) and rows [n, nfill) zero. With `vec`
// (d, the strides and the base 16-byte aligned) every chunk goes by
// cp.async, all in flight at once (the caller commits and waits).
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long rs, int n,
                                          int nfill, int d, int ld, bool vec, int tid, int nt) {
  const int DP = dp_of(d);
  if (vec) {  // d % 4 == 0, so DP == d
    const int cpr = DP / 4;
    for (int i = tid; i < nfill * cpr; i += nt) {
      const int r = i / cpr, c = (i - r * cpr) * 4;
      float* o = dst + r * ld + c;
      if (r < n) cp_async16(o, src + r * rs + c);
      else *reinterpret_cast<float4*>(o) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  for (int i = tid; i < nfill * DP; i += nt) {
    const int r = i / DP, c = i - r * DP;
    dst[r * ld + c] = r < n && c < d ? src[r * rs + c] : 0.f;
  }
}

// acc[i][j] = sum over c < DP, in order, of A[ra[i]][c] * B[rb[j]][c] (rows
// of ld floats): a warp's 16 x 32 tile, 4 x 4 a lane.
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* A, const int (&ra)[4],
                                         const float* B, const int (&rb)[4], int DP, int ld) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 1
  for (int c = 0; c < DP; c += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(A + ra[i] * ld + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = *reinterpret_cast<const float4*>(B + rb[j] * ld + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = fmaf(x[i].x, y[j].x, acc[i][j]);
        s = fmaf(x[i].y, y[j].y, s);
        s = fmaf(x[i].z, y[j].z, s);
        acc[i][j] = fmaf(x[i].w, y[j].w, s);
      }
  }
}

// NC consecutive floats of a shared row
template <int NC>
__device__ __forceinline__ void load_cols(float (&x)[NC], const float* p) {
  if constexpr (NC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (NC == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c) x[c] = p[c];
  }
}

// Lane (rg, cg) stages t[i][j] (row 4 rg + i, column cg + 8 j of a 16 x 32
// tile) transposed into the warp's 32 x 16 tile.
__device__ __forceinline__ void stage_t(float* Pw, const float (&t)[4][4], int rg, int cg) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(Pw + (cg + 8 * j) * PLD + rg * 4) =
        make_float4(t[0][j], t[1][j], t[2][j], t[3][j]);
}

// acc[i][c] += sum over t < n, in order, of Pw[t][4 rg + i] * X[x0 + t][cg NC + c]
template <int NC>
__device__ __forceinline__ void mul_staged(float (&acc)[4][NC], const float* Pw, const float* X,
                                           int x0, int n, int ld, int rg, int cg) {
  const float* xp = X + (size_t)x0 * ld + cg * NC;
  for (int t = 0; t < n; ++t) {
    const float4 p = *reinterpret_cast<const float4*>(Pw + t * PLD + rg * 4);
    float x[NC];
    load_cols<NC>(x, xp + t * ld);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[0][c] = fmaf(p.x, x[c], acc[0][c]);
      acc[1][c] = fmaf(p.y, x[c], acc[1][c]);
      acc[2][c] = fmaf(p.z, x[c], acc[2][c]);
      acc[3][c] = fmaf(p.w, x[c], acc[3][c]);
    }
  }
}

// over the 8 lanes of a row group (lane bits 0-2), xor butterflies: every
// lane gets the same bits
__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// Row max m, sum l of exp(s - m) and u of exp(s - m) dP over this lane's 4
// scores x and dP values y of one row, l and u rescaled when m grows.
__device__ __forceinline__ void online(float& m, float& l, float& u, const float (&x)[4],
                                       const float (&y)[4]) {
  const float mn = fmaxf(m, fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])));
  if (mn == -INFINITY) return;  // every key of this lane so far is masked
  const float f = expf(m - mn);
  l *= f;
  u *= f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float p = expf(x[e] - mn);
    l += p;
    u = fmaf(p, y[e], u);
  }
  m = mn;
}

// the lane's 4 rows (or columns) of a strip or tile starting at r0,
// clamped to [0, L) for reading
__device__ __forceinline__ void strip_rows(int (&r)[4], int r0, int step, int L) {
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = min(r0 + i * step, L - 1);
}

template <int NC>
__device__ __forceinline__ void store_rows(const float (&x)[4][NC], float mul, float* out,
                                           long long rs, int r0, int L, int d, int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + i;
    if (r >= L) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = cg * NC + c;
      if (col < d) out[(size_t)r * rs + col] = x[i][c] * mul;
    }
  }
}

template <int NC>
__global__ void __maxnreg__(REGS) mha_f32_fwd_kernel(const Args a, int G, int vec) {
  extern __shared__ __align__(16) float sm[];
  const int L = a.L, d = a.d, DP = dp_of(d), ld = ld_of(d);
  const int NS = (L + STRIP - 1) / STRIP, BH = a.B * a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, W = blockDim.x >> 5;
  const int rg = lane >> 3, cg = lane & 7;
  const int p0 = blockIdx.x * G;
  const size_t T = (size_t)L * ld;
  float* Ks = sm;
  float* Vs = Ks + G * T;
  float* Qw = Vs + G * T + (size_t)warp * (STRIP * ld + STAGE);  // the warp's q strip
  float* Pw = Qw + STRIP * ld;                                     // and its staged tile
  for (int g = 0; g < G && p0 + g < BH; ++g) {
    const size_t ib = in_base(a, p0 + g);
    load_rows(Ks + g * T, a.k + ib, a.in_r, L, L, d, ld, vec, threadIdx.x, blockDim.x);
    load_rows(Vs + g * T, a.v + ib, a.in_r, L, L, d, ld, vec, threadIdx.x, blockDim.x);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const float post = a.post == ssrl::kPostScaled ? a.scale : 1.f;
  for (int t = warp; t < G * NS; t += W) {
    const int g = t / NS, s = t - g * NS, p = p0 + g;
    if (p >= BH) break;  // tasks go in head order
    const float *K = Ks + g * T, *V = Vs + g * T;
    const int r0 = s * STRIP;
    load_rows(Qw, a.q + in_base(a, p) + (size_t)r0 * a.in_r, a.in_r, min(STRIP, L - r0), STRIP,
              d, ld, vec, lane, 32);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    if (a.post == ssrl::kPreScaled) {
      for (int i = lane; i < STRIP * DP; i += 32) Qw[(i / DP) * ld + i % DP] *= a.scale;
      __syncwarp();
    }
    int ra[4];
    strip_rows(ra, rg * 4, 1, STRIP);
    // the output in chunks of 8 NC columns: one chunk unless d > 32
    for (int c0 = 0; c0 < DP; c0 += 8 * NC) {
      float m[4], l[4], o[4][NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
      }
      for (int k0 = 0; k0 < L; k0 += TILE) {
        int rb[4];
        strip_rows(rb, k0 + cg, 8, L);
        float sc[4][4];
        dot_tile(sc, Qw, ra, K, rb, DP, ld);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float tm = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = k0 + cg + 8 * j < L ? sc[i][j] * post : -INFINITY;
            tm = fmaxf(tm, sc[i][j]);
          }
          const float mn = fmaxf(m[i], group_max(tm));  // finite: key 0 is in the first tile
          const float f = expf(m[i] - mn);
          l[i] *= f;
#pragma unroll
          for (int c = 0; c < NC; ++c) o[i][c] *= f;
          m[i] = mn;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = expf(sc[i][j] - mn);
            l[i] += sc[i][j];
          }
        }
        stage_t(Pw, sc, rg, cg);
        __syncwarp();
        mul_staged<NC>(o, Pw, V + c0, k0, min(TILE, L - k0), ld, rg, cg);
        __syncwarp();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float sum = group_sum(l[i]);
#pragma unroll
        for (int c = 0; c < NC; ++c) o[i][c] = o[i][c] / sum;
      }
      store_rows<NC>(o, 1.f, a.o + out_base(a, p) + c0, a.out_r, r0 + rg * 4, L, d - c0, cg);
    }
  }
}

template <int NC>
__global__ void __maxnreg__(REGS) mha_f32_bwd_kernel(const Args a, int G, int vec) {
  extern __shared__ __align__(16) float sm[];
  const int L = a.L, d = a.d, DP = dp_of(d), ld = ld_of(d);
  const int NS = (L + STRIP - 1) / STRIP, BH = a.B * a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, W = blockDim.x >> 5;
  const int rg = lane >> 3, cg = lane & 7;
  const int p0 = blockIdx.x * G;
  const size_t T = (size_t)L * ld;
  float* Qs = sm;  // q_s (pre-scaled contract) or q
  float* Ks = Qs + G * T;
  float* Vs = Ks + G * T;
  float* dOs = Vs + G * T;
  float* stats = dOs + G * T;  // [G][3][L]: max, sum, D
  float* Pw = stats + round4(3 * (size_t)G * L) + (size_t)warp * STAGE;
  for (int g = 0; g < G && p0 + g < BH; ++g) {
    const size_t ib = in_base(a, p0 + g);
    const int tid = threadIdx.x, nt = blockDim.x;
    load_rows(Qs + g * T, a.q + ib, a.in_r, L, L, d, ld, vec, tid, nt);
    load_rows(Ks + g * T, a.k + ib, a.in_r, L, L, d, ld, vec, tid, nt);
    load_rows(Vs + g * T, a.v + ib, a.in_r, L, L, d, ld, vec, tid, nt);
    load_rows(dOs + g * T, a.dO + out_base(a, p0 + g), a.out_r, L, L, d, ld, vec, tid, nt);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const bool post = a.post == ssrl::kPostScaled;
  const float smul = post ? a.scale : 1.f;
  if (!post) {
    for (int i = threadIdx.x; i < G * L * DP; i += blockDim.x) {
      const int r = i / DP;
      Qs[r * ld + i % DP] *= a.scale;
    }
    __syncthreads();
  }

  // phase A, per query strip: the row statistics, then dS and dQ = dS K
  for (int t = warp; t < G * NS; t += W) {
    const int g = t / NS, s = t - g * NS, p = p0 + g;
    if (p >= BH) break;
    const float *Q = Qs + g * T, *K = Ks + g * T, *V = Vs + g * T, *dO = dOs + g * T;
    const int r0 = s * STRIP + rg * 4;
    int ra[4];
    strip_rows(ra, r0, 1, L);
    float m[4], l[4], u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f, u[i] = 0.f;
    for (int k0 = 0; k0 < L; k0 += TILE) {
      int rb[4];
      strip_rows(rb, k0 + cg, 8, L);
      float sc[4][4], dp[4][4];
      dot_tile(sc, Q, ra, K, rb, DP, ld);
      dot_tile(dp, dO, ra, V, rb, DP, ld);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = k0 + cg + 8 * j < L ? sc[i][j] * smul : -INFINITY;
        online(m[i], l[i], u[i], sc[i], dp[i]);
      }
    }
    float D[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mq = group_max(m[i]), f = expf(m[i] - mq);
      l[i] = group_sum(l[i] * f);
      D[i] = group_sum(u[i] * f) / l[i];  // rowsum(dP o P)
      m[i] = mq;
    }
    float* st = stats + g * 3 * L;
    if (cg == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (r0 + i < L) {
          st[r0 + i] = m[i];
          st[L + r0 + i] = l[i];
          st[2 * L + r0 + i] = D[i];
        }
    for (int c0 = 0; c0 < DP; c0 += 8 * NC) {  // dq in chunks of 8 NC columns
      float dq[4][NC] = {};
      for (int k0 = 0; k0 < L; k0 += TILE) {
        int rb[4];
        strip_rows(rb, k0 + cg, 8, L);
        float sc[4][4], dp[4][4];
        dot_tile(sc, Q, ra, K, rb, DP, ld);
        dot_tile(dp, dO, ra, V, rb, DP, ld);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float pr = k0 + cg + 8 * j < L ? expf(sc[i][j] * smul - m[i]) / l[i] : 0.f;
            dp[i][j] = pr * (dp[i][j] - D[i]);
          }
        stage_t(Pw, dp, rg, cg);
        __syncwarp();
        mul_staged<NC>(dq, Pw, K + c0, k0, min(TILE, L - k0), ld, rg, cg);
        __syncwarp();
      }
      store_rows<NC>(dq, a.scale, a.dq + in_base(a, p) + c0, a.in_r, r0, L, d - c0, cg);
    }
  }
  __syncthreads();

  // phase B, per key strip: P^T and dS^T from the statistics, dV = P^T dO
  // and dK = dS^T q
  for (int t = warp; t < G * NS; t += W) {
    const int g = t / NS, s = t - g * NS, p = p0 + g;
    if (p >= BH) break;
    const float *Q = Qs + g * T, *K = Ks + g * T, *V = Vs + g * T, *dO = dOs + g * T;
    const float* st = stats + g * 3 * L;
    const int k0s = s * STRIP + rg * 4;
    int ra[4];
    strip_rows(ra, k0s, 1, L);
    for (int c0 = 0; c0 < DP; c0 += 8 * NC) {  // dk, dv in chunks of 8 NC columns
      float dk[4][NC] = {}, dv[4][NC] = {};
      for (int q0 = 0; q0 < L; q0 += TILE) {
        int rb[4];
        strip_rows(rb, q0 + cg, 8, L);
        float sc[4][4], dp[4][4];
        dot_tile(sc, K, ra, Q, rb, DP, ld);   // S^T: rows keys, columns queries
        dot_tile(dp, V, ra, dO, rb, DP, ld);  // dP^T
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool liveq = q0 + cg + 8 * j < L;
          const float mq = st[rb[j]], lq = st[L + rb[j]], Dq = st[2 * L + rb[j]];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pr = liveq && k0s + i < L ? expf(sc[i][j] * smul - mq) / lq : 0.f;
            sc[i][j] = pr;
            dp[i][j] = pr * (dp[i][j] - Dq);
          }
        }
        const int nq = min(TILE, L - q0);
        stage_t(Pw, sc, rg, cg);
        __syncwarp();
        mul_staged<NC>(dv, Pw, dO + c0, q0, nq, ld, rg, cg);
        __syncwarp();
        stage_t(Pw, dp, rg, cg);
        __syncwarp();
        mul_staged<NC>(dk, Pw, Q + c0, q0, nq, ld, rg, cg);
        __syncwarp();
      }
      const size_t ib = in_base(a, p) + c0;
      store_rows<NC>(dk, smul, a.dk + ib, a.in_r, k0s, L, d - c0, cg);
      store_rows<NC>(dv, 1.f, a.dv + ib, a.in_r, k0s, L, d - c0, cg);
    }
  }
}

// 16-byte loads need d, every stride and every loaded base to be multiples
// of 4 floats
int vec_of(const Args& a, bool bwd) {
  bool v = a.d % 4 == 0 && a.in_b % 4 == 0 && a.in_h % 4 == 0 && a.in_r % 4 == 0 &&
           aligned16(a.q) && aligned16(a.k) && aligned16(a.v);
  if (bwd) v = v && a.out_b % 4 == 0 && a.out_h % 4 == 0 && a.out_r % 4 == 0 && aligned16(a.dO);
  return v ? 1 : 0;
}

// The kernel of head dim d: NC = DP / 8 rounded up columns a lane, 4 above
// d = 32 (then the column chunks loop).
template <bool BWD>
const void* pick(int d) {
  const int nc = dp_of(d) > 32 ? 4 : (dp_of(d) + 7) / 8;
  if constexpr (BWD) {
    const void* k[4] = {reinterpret_cast<const void*>(mha_f32_bwd_kernel<1>),
                        reinterpret_cast<const void*>(mha_f32_bwd_kernel<2>),
                        reinterpret_cast<const void*>(mha_f32_bwd_kernel<3>),
                        reinterpret_cast<const void*>(mha_f32_bwd_kernel<4>)};
    return k[nc - 1];
  } else {
    const void* k[4] = {reinterpret_cast<const void*>(mha_f32_fwd_kernel<1>),
                        reinterpret_cast<const void*>(mha_f32_fwd_kernel<2>),
                        reinterpret_cast<const void*>(mha_f32_fwd_kernel<3>),
                        reinterpret_cast<const void*>(mha_f32_fwd_kernel<4>)};
    return k[nc - 1];
  }
}

size_t smem_of(bool bwd, int L, int d) {
  return sizeof(float) * smem_floats(bwd, L, d, plan_for(bwd, L, d));
}

template <bool BWD>
cudaError_t launch(const Args& a, cudaStream_t st) {
  if (a.B < 1 || a.H < 1 || !ssrl::mha_f32_fits(a.L, a.d, BWD) ||
      (a.post != ssrl::kPreScaled && a.post != ssrl::kPostScaled))
    return cudaErrorInvalidValue;
  const void* fn = pick<BWD>(a.d);
  const Plan p = plan_for(BWD, a.L, a.d);
  const size_t smem = smem_of(BWD, a.L, a.d);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  Args args = a;
  int G = p.G, vec = vec_of(a, BWD);
  void* params[] = {&args, &G, &vec};
  const long long blocks = ((long long)a.B * a.H + p.G - 1) / p.G;
  e = cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3(32 * p.W), params, smem, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

namespace ssrl {

bool mha_f32_fits(int L, int d, bool bwd) {
  if (L < 1 || d < 1) return false;
  return smem_of(false, L, d) <= kMaxShared && (!bwd || smem_of(true, L, d) <= kMaxShared);
}

cudaError_t mha_f32_fwd(const MhaArgsT<float>& a, cudaStream_t st) { return launch<false>(a, st); }

cudaError_t mha_f32_bwd(const MhaArgsT<float>& a, cudaStream_t st) { return launch<true>(a, st); }

}  // namespace ssrl

extern "C" {

// Whether the f32 core takes (L, d): its forward (bwd = 0), or its forward
// and backward (bwd = 1), in one block's shared memory.
int ssrl_attn_f32_fits(int L, int d, int bwd) {
  return ssrl::mha_f32_fits(L, d, bwd != 0) ? 1 : 0;
}

// As ssrl_mha_occupancy of mha.cu, for the f32 kernels.
int ssrl_mha_f32_occupancy(int L, int d, int bwd, int* blocks_per_sm, int* warps,
                           int* smem_bytes, int* regs) {
  if (!ssrl::mha_f32_fits(L, d, bwd != 0)) return (int)cudaErrorInvalidValue;
  const void* fn = bwd ? pick<true>(d) : pick<false>(d);
  const Plan p = plan_for(bwd != 0, L, d);
  const size_t smem = smem_of(bwd != 0, L, d);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, 32 * p.W, smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  *warps = p.W;
  *smem_bytes = (int)smem;
  *regs = attr.numRegs;
  return 0;
}

// As ssrl_mha_fwd / ssrl_mha_bwd of mha.cu, on f32 tensors.
int ssrl_mha_f32_fwd(const void* q, const void* k, const void* v, void* o, long long in_b,
                     int in_h, int in_r, long long out_b, int out_h, int out_r, int B, int H,
                     int L, int d, float scale, int post, void* stream) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  a.in_b = in_b; a.in_h = in_h; a.in_r = in_r;
  a.out_b = out_b; a.out_h = out_h; a.out_r = out_r;
  a.B = B; a.H = H; a.L = L; a.d = d;
  a.scale = scale;
  a.post = post;
  return (int)ssrl::mha_f32_fwd(a, static_cast<cudaStream_t>(stream));
}

int ssrl_mha_f32_bwd(const void* q, const void* k, const void* v, const void* dO, void* dq,
                     void* dk, void* dv, long long in_b, int in_h, int in_r, long long out_b,
                     int out_h, int out_r, int B, int H, int L, int d, float scale, int post,
                     void* stream) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dO = static_cast<const float*>(dO);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.in_b = in_b; a.in_h = in_h; a.in_r = in_r;
  a.out_b = out_b; a.out_h = out_h; a.out_r = out_r;
  a.B = B; a.H = H; a.L = L; a.d = d;
  a.scale = scale;
  a.post = post;
  return (int)ssrl::mha_f32_bwd(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
