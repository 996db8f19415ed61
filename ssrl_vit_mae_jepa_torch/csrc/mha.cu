// Multi-head attention on Hopper (sm_90a): o = softmax(q k^T / sqrt(d)) v
// and its backward (dq, dk, dv) from (q, k, v, dO), over strided bf16
// tensors (the layouts are described in mha.cuh).
//
// Replaces the TPU kernels
//   ops/attention_pallas_stacked.py  _fwd_qkv (:440) / _bwd_qkv (:461)  fused (B, L, 3D) qkv
//   ops/attention_pallas_stacked.py  _fwd (:380) / _bwd (:401)          three (B, L, D)
//   ops/attention_pallas_packed.py   _fwd (:161) / _bwd (:186)          three (B, L, D)
//   ops/attention_pallas.py          _mha_fwd (:144) / _mha_bwd (:166)  (B, H, L, d), post-scaled
// (paths under ssrl_vit_mae_jepa_tpu/), and is the attention core of the
// attention branch in attn_branch.cu, whose per-image bias partials it
// writes when `colpart` is set.
//
// What bounds it on the H100: at the model's shapes (L = 37-145, d = 16-32)
// a head does 4 L^2 d operations forward against 8 L d bytes of q, k, v, o,
// ~2.3 operations per byte at L = 145, far below the card's ~295: the floor
// is reading q, k, v (and dO) once and writing o (or dq, dk, dv) once. What
// keeps a kernel from that floor is latency: a head is a chain of dependent
// steps (load, QK^T, softmax, PV) a few microseconds long, so each SM needs
// many heads in flight, and occupancy, not the tensor-core rate, sets the
// time. wgmma's 64-row tiles buy nothing at d <= 32 and L <= 160.
//
// The design: nothing L x L is stored anywhere. Shared memory holds only the
// head's bf16 q, k, v (and dO), padded to LP = L rounded up to 16 rows and
// DP = 16 or 32 columns, each loaded once by cp.async (every chunk of a
// block in flight at once); a warp owns 16-row strips and makes each 16 x 16
// tile of S (and dP) with mma.sync.m16n8k16 (ldmatrix fragments, f32
// accumulators) when it needs it, again rather than keep it:
//  - forward, per query strip: three passes over 16-key tiles, the row max,
//    then the row sum of exp(s - m), then P = exp(s - m) / l into PV, so the
//    softmax is exact and normalised by division before P's one rounding to
//    bf16; the accumulators convert in place to PV's A fragments, and O is
//    rounded once from its accumulators.
//  - backward, phase A per query strip, two passes: first the row max m,
//    the sum l of exp(s - m) and D_i = rowsum(dP o P) with the f32 P, as
//    sum(exp(s - m) dP) / l (both sums rescaled as m grows); then P, dS and
//    dQ = dS K. The statistics (3 LP floats) go to shared memory.
//  - backward, phase B per 16-key strip: S^T, P^T from the statistics, dP^T
//    and dS^T again, one 16-query tile at a time; dV = P^T dO and dK = dS^T q
//    accumulate in registers and are written once.
// Holding a strip's whole score row in registers instead takes LP / 2
// floats a lane (80 at L = 145) and, with dP in the backward, leaves 15
// warps (forward) and 5 (backward) per SM on the H100; recomputing leaves
// 64 and 96 registers a thread, 25 and 20 warps per SM at (145, 32), and
// the extra tensor-core work is cheap at d <= 32. Shared memory is 38 KB
// (forward) and 55 KB (backward) at (145, 32). A block takes G heads and W
// warps over their G * NS 16-row strips (plan_for): at L = 37, 2 heads and
// 6 warps of one strip each, so that no warp idles; at L = 145, 1 head and
// 5 warps of two strips. exp is the hardware's (__expf, a few ulp; the TPU's
// exp is not correctly rounded either); the division that normalises P is
// exact. No atomics: every sum has one fixed order, and two calls give the
// same bits.
#include "common.cuh"
#include "mha.cuh"

namespace {

using ssrl::MhaArgs;

// the longest sequence: the backward's shared memory (88 KB at d = 32) still
// leaves two blocks per SM
constexpr int MHA_MAX_L = 256;
constexpr int MHA_MAX_WARPS = 8;

// launch flags
constexpr int kVecLoads = 1;  // 16-byte loads of q, k, v (and dO)
constexpr int kPairOut = 2;   // bf16 pairs stored to o
constexpr int kPairIn = 4;    // bf16 pairs stored to dq, dk, dv

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// G (image, head) pairs per block and W warps over their G * NS strips:
// one strip per warp below NS = 6, two strips per warp above.
struct Plan {
  int G, W;
};
inline Plan plan_for(int L) {
  const int NS = pad16(L) / 16;
  if (NS >= 6) return {1, (NS + 1) / 2};
  const int G = 6 / NS > 1 ? 6 / NS : 1;
  return {G, G * NS};
}

inline size_t tile_elems(int L, int DP) { return (size_t)pad16(L) * (DP + 8); }

inline size_t fwd_smem(int L, int DP, int G) { return (size_t)3 * G * tile_elems(L, DP) * 2; }

// q, k, v, dO tiles, then per head the row max, sum and D_i, then per warp
// the f32 column sums of dq | dk | dv
inline size_t bwd_smem(int L, int DP, const Plan& p) {
  return (size_t)4 * p.G * tile_elems(L, DP) * 2 + (size_t)p.G * 3 * pad16(L) * 4 +
         (size_t)p.W * 3 * DP * 4;
}

// Stage q, k, v (and dO) of pair p = b * H + h, zero outside [0, L) x
// [0, d). With 16-byte aligned rows (`vec`) every chunk goes by cp.async, all
// of them in flight at once (the caller commits and waits); otherwise element
// by element. q arrives unscaled: see stage_heads.
template <int DP>
__device__ __forceinline__ void load_head(const MhaArgs& a, bool vec, int p, int LP, bf16* Qs,
                                          bf16* K, bf16* V, bf16* dO) {
  const int b = p / a.H, h = p - (p / a.H) * a.H;
  const size_t ib = (size_t)b * a.in_b + (size_t)h * a.in_h;
  const bf16 *q = a.q + ib, *k = a.k + ib, *v = a.v + ib;
  const bf16* g = dO ? a.dO + (size_t)b * a.out_b + (size_t)h * a.out_h : nullptr;
  const int L = a.L, d = a.d;
  if (vec) {
    constexpr int CPR = DP / 8;  // 16-byte chunks per padded row
    for (int idx = threadIdx.x; idx < LP * CPR; idx += blockDim.x) {
      const int i = idx / CPR, c = (idx - (idx / CPR) * CPR) * 8;
      const int o = i * (DP + 8) + c;
      if (i < L && c < d) {
        const size_t r = (size_t)i * a.in_r + c;
        cp_async16(Qs + o, q + r);
        cp_async16(K + o, k + r);
        cp_async16(V + o, v + r);
        if (dO) cp_async16(dO + o, g + (size_t)i * a.out_r + c);
      } else {
        const uint4 z = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(Qs + o) = z;
        *reinterpret_cast<uint4*>(K + o) = z;
        *reinterpret_cast<uint4*>(V + o) = z;
        if (dO) *reinterpret_cast<uint4*>(dO + o) = z;
      }
    }
    return;
  }
  const bf16 zero = __float2bfloat16(0.f);
  for (int idx = threadIdx.x; idx < LP * DP; idx += blockDim.x) {
    const int i = idx / DP, c = idx - (idx / DP) * DP;
    bf16 qe = zero, ke = zero, ve = zero, ge = zero;
    if (i < L && c < d) {
      const size_t r = (size_t)i * a.in_r + c;
      qe = q[r];
      ke = k[r];
      ve = v[r];
      if (g) ge = g[(size_t)i * a.out_r + c];
    }
    const int o = i * (DP + 8) + c;
    Qs[o] = qe;
    K[o] = ke;
    V[o] = ve;
    if (dO) dO[o] = ge;
  }
}

// The staged heads' q, and for the pre-scaled contract q scaled in f32 and
// rounded to bf16 in place, once every load has landed.
template <int DP>
__device__ __forceinline__ void stage_heads(const MhaArgs& a, int flags, int p0, int G, int LP,
                                            bf16* Qs, bf16* Ks, bf16* Vs, bf16* dOs) {
  const int BH = a.B * a.H;
  const size_t T = (size_t)LP * (DP + 8);
  for (int g = 0; g < G && p0 + g < BH; ++g)
    load_head<DP>(a, flags & kVecLoads, p0 + g, LP, Qs + g * T, Ks + g * T, Vs + g * T,
                  dOs ? dOs + g * T : nullptr);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (a.post != ssrl::kPreScaled) return;
  union Chunk {
    uint4 u;
    bf16 e[8];
  };
  for (int i = threadIdx.x; i < G * LP * (DP / 8); i += blockDim.x) {
    const int row = i / (DP / 8), c = (i - row * (DP / 8)) * 8;
    Chunk x;
    x.u = *reinterpret_cast<const uint4*>(Qs + row * (DP + 8) + c);
#pragma unroll
    for (int e = 0; e < 8; ++e) x.e[e] = tobf(bf(x.e[e]) * a.scale);
    *reinterpret_cast<uint4*>(Qs + row * (DP + 8) + c) = x.u;
  }
  __syncthreads();
}

// The 16 x 16 A fragments of rows [16 s, 16 s + 16) of a (LP, DP) tile.
template <int DP>
__device__ __forceinline__ void strip_frags(unsigned (&f)[DP / 16][4], const bf16* T, int s,
                                            int lane) {
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) ldsm_x4(f[kc], T + ld_a(s * 16, kc * 16, DP + 8, lane));
}

// c0, c1 += A X[16 t .. 16 t + 16)^T for X stored (rows, DP): the product's
// columns 16 t .. 16 t + 8 and 16 t + 8 .. 16 t + 16.
template <int DP>
__device__ __forceinline__ void mul_t(float (&c0)[4], float (&c1)[4],
                                      const unsigned (&A)[DP / 16][4], const bf16* X, int t,
                                      int lane) {
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    unsigned x[4];
    ldsm_x4(x, X + ld_b(t * 16, kc * 16, DP + 8, lane));
    mma16816(c0, A[kc], x[0], x[1]);
    mma16816(c1, A[kc], x[2], x[3]);
  }
}

// acc += A X[16 t .. 16 t + 16) for a 16 x 16 A and X stored (rows, DP):
// acc[j] covers columns 8 j .. 8 j + 8.
template <int DP>
__device__ __forceinline__ void mul_n(float (&acc)[DP / 8][4], const unsigned (&A)[4],
                                      const bf16* X, int t, int lane) {
#pragma unroll
  for (int nc = 0; nc < DP / 16; ++nc) {
    unsigned x[4];
    ldsm_x4_t(x, X + ld_a(t * 16, nc * 16, DP + 8, lane));
    mma16816(acc[2 * nc], A, x[0], x[1]);
    mma16816(acc[2 * nc + 1], A, x[2], x[3]);
  }
}

// The bf16 A fragment of columns [16 t, 16 t + 16) of a strip held as C
// fragments.
__device__ __forceinline__ void to_a(unsigned (&A)[4], const float (&c0)[4],
                                     const float (&c1)[4]) {
  A[0] = pack_bf16(c0[0], c0[1]);
  A[1] = pack_bf16(c0[2], c0[3]);
  A[2] = pack_bf16(c1[0], c1[1]);
  A[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The scores of key tile kt (c0: keys 16 kt .. + 8, c1: the next 8) times
// post in f32 (1 for the pre-scaled contract), -inf for keys >= L.
__device__ __forceinline__ void mask_scale(float (&c0)[4], float (&c1)[4], int kt, int L,
                                           float post, int lane) {
  const int c = kt * 16 + 2 * (lane & 3);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = c + (e & 1);
    c0[e] = k < L ? c0[e] * post : -INFINITY;
    c1[e] = k + 8 < L ? c1[e] * post : -INFINITY;
  }
}

// Row max m, sum l of exp(s - m) and u of exp(s - m) dP over this lane's
// scores x and dP values y of one row, four at a time, l and u rescaled
// when m grows.
__device__ __forceinline__ void online(float& m, float& l, float& u, const float (&x)[4],
                                       const float (&y)[4]) {
  const float mn = fmaxf(m, fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])));
  if (mn == -INFINITY) return;  // every key so far is masked
  const float f = __expf(m - mn);
  l *= f;
  u *= f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float p = __expf(x[e] - mn);
    l += p;
    u += p * y[e];
  }
  m = mn;
}

// The f32 P of key tile kt from the row statistics: exp(s * post - m) / l,
// 0 for keys >= L and rows >= L.
__device__ __forceinline__ void probs(float (&c0)[4], float (&c1)[4], int kt, int L,
                                      float post, const float (&m)[2], const float (&l)[2],
                                      bool live0, bool live1, int lane) {
  const int c = kt * 16 + 2 * (lane & 3);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = c + (e & 1), hh = e >> 1;
    const bool row = hh ? live1 : live0;
    c0[e] = row && k < L ? __expf(c0[e] * post - m[hh]) / l[hh] : 0.f;
    c1[e] = row && k + 8 < L ? __expf(c1[e] * post - m[hh]) / l[hh] : 0.f;
  }
}

// Round x * mul (C fragments of rows [r0, r0 + 16), DP columns) to bf16 and
// store rows < L, columns < d at out (row stride ld); with cs, add the f32
// column sums of x * mul to cs[0 .. DP).
template <int DP>
__device__ __forceinline__ void store_strip(float (&x)[DP / 8][4], float mul, bf16* out,
                                            int ld, int r0, int L, int d, bool pair, int lane,
                                            float* cs) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int c = j * 8 + 2 * tq;
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] *= mul;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + g + 8 * hh;
      if (r < L && c < d) {
        bf16* o = out + (size_t)r * ld + c;
        if (pair) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x[j][2 * hh], x[j][2 * hh + 1]);
        } else {
          o[0] = tobf(x[j][2 * hh]);
          if (c + 1 < d) o[1] = tobf(x[j][2 * hh + 1]);
        }
      }
    }
    if (cs) {  // warp-uniform
      float s0 = (r0 + g < L ? x[j][0] : 0.f) + (r0 + g + 8 < L ? x[j][2] : 0.f);
      float s1 = (r0 + g < L ? x[j][1] : 0.f) + (r0 + g + 8 < L ? x[j][3] : 0.f);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (g == 0) {
        cs[c] += s0;
        cs[c + 1] += s1;
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(32 * MHA_MAX_WARPS)
    mha_fwd_kernel(const MhaArgs a, int flags, int G) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = a.L, LP = pad16(L), NS = LP / 16, BH = a.B * a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, W = blockDim.x >> 5;
  const int p0 = blockIdx.x * G;
  const size_t T = (size_t)LP * (DP + 8);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + G * T;
  bf16* Vs = Ks + G * T;
  stage_heads<DP>(a, flags, p0, G, LP, Qs, Ks, Vs, nullptr);

  const float post = a.post == ssrl::kPostScaled ? a.scale : 1.f;
  for (int t = warp; t < G * NS; t += W) {
    const int g = t / NS, s = t - g * NS, p = p0 + g;
    if (p >= BH) break;  // tasks go in head order
    const bf16 *Q = Qs + g * T, *K = Ks + g * T, *V = Vs + g * T;
    unsigned qa[DP / 16][4];
    strip_frags<DP>(qa, Q, s, lane);
    const int r0 = s * 16 + (lane >> 2);
    const bool live0 = r0 < L, live1 = r0 + 8 < L;
    // the exact two-pass softmax over 16-key tiles: the row max, then the
    // row sum, then P = exp(s - m) / l into PV
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int kt = 0; kt < NS; ++kt) {
      float s0[4] = {}, s1[4] = {};
      mul_t<DP>(s0, s1, qa, K, kt, lane);
      mask_scale(s0, s1, kt, L, post, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], fmaxf(s0[e], s1[e]));
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
    for (int kt = 0; kt < NS; ++kt) {
      float s0[4] = {}, s1[4] = {};
      mul_t<DP>(s0, s1, qa, K, kt, lane);
      mask_scale(s0, s1, kt, L, post, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += __expf(s0[e] - m[e >> 1]) + __expf(s1[e] - m[e >> 1]);
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    float o[DP / 8][4] = {};
    for (int kt = 0; kt < NS; ++kt) {
      float s0[4] = {}, s1[4] = {};
      mul_t<DP>(s0, s1, qa, K, kt, lane);
      probs(s0, s1, kt, L, post, m, l, live0, live1, lane);
      unsigned pa[4];
      to_a(pa, s0, s1);
      mul_n<DP>(o, pa, V, kt, lane);
    }
    const int b = p / a.H, h = p - (p / a.H) * a.H;
    store_strip<DP>(o, 1.f, a.o + (size_t)b * a.out_b + (size_t)h * a.out_h, a.out_r, s * 16,
                    L, a.d, flags & kPairOut, lane, nullptr);
  }
}

// dq, dk, dv rounded to bf16 and, when a.colpart is set, colpart[b][3 H d]:
// the f32 column sums of this image's dq | dk | dv (the branch's dbqkv
// partials).
// at most 96 registers a thread: 20 warps per SM at L = 145 (112, the
// compiler's choice without the cap, gave 15; the cap spills a few bytes)
template <int DP>
__global__ void __maxnreg__(96) mha_bwd_kernel(const MhaArgs a, int flags, int G) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = a.L, LP = pad16(L), NS = LP / 16, BH = a.B * a.H, H = a.H, d = a.d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, W = blockDim.x >> 5;
  const int g8 = lane >> 2, tq = lane & 3;
  const int p0 = blockIdx.x * G;
  const size_t T = (size_t)LP * (DP + 8);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + G * T;
  bf16* Vs = Ks + G * T;
  bf16* dOs = Vs + G * T;
  float* stats = reinterpret_cast<float*>(dOs + G * T);  // [G][3][LP]: max, sum, D
  float* cs = stats + G * 3 * LP;                         // [W][3][DP]
  float* mine = a.colpart ? cs + warp * 3 * DP : nullptr;
  if (mine)
    for (int c = lane; c < 3 * DP; c += 32) mine[c] = 0.f;
  stage_heads<DP>(a, flags, p0, G, LP, Qs, Ks, Vs, dOs);

  const float scale = a.scale;
  const bool post = a.post == ssrl::kPostScaled;
  const bool pair = flags & kPairIn;

  // phase A, per query strip: the row statistics, then dS and dQ = dS K,
  // one 16-key tile at a time (S three times, dP twice)
  for (int t = warp; t < G * NS; t += W) {
    const int g = t / NS, s = t - g * NS, p = p0 + g;
    if (p >= BH) break;
    const bf16 *Q = Qs + g * T, *K = Ks + g * T, *V = Vs + g * T, *dO = dOs + g * T;
    unsigned qa[DP / 16][4], oa[DP / 16][4];
    strip_frags<DP>(qa, Q, s, lane);
    strip_frags<DP>(oa, dO, s, lane);
    const int r0 = s * 16 + g8;
    const bool live0 = r0 < L, live1 = r0 + 8 < L;
    // m, l and u = sum of exp(s - m) dP, rescaled as m grows
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
    for (int kt = 0; kt < NS; ++kt) {
      float s0[4] = {}, s1[4] = {}, dp0[4] = {}, dp1[4] = {};
      mul_t<DP>(s0, s1, qa, K, kt, lane);
      mul_t<DP>(dp0, dp1, oa, V, kt, lane);
      mask_scale(s0, s1, kt, L, post ? scale : 1.f, lane);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float x[4] = {s0[2 * hh], s0[2 * hh + 1], s1[2 * hh], s1[2 * hh + 1]};
        const float y[4] = {dp0[2 * hh], dp0[2 * hh + 1], dp1[2 * hh], dp1[2 * hh + 1]};
        online(m[hh], l[hh], u[hh], x, y);
      }
    }
    float Di[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float mq = quad_max(m[hh]), f = __expf(m[hh] - mq);
      l[hh] = quad_sum(l[hh] * f);
      Di[hh] = quad_sum(u[hh] * f) / l[hh];  // rowsum(dP o P), P in f32
      m[hh] = mq;
    }
    const float D0 = Di[0], D1 = Di[1];
    float dq[DP / 8][4] = {};
    for (int kt = 0; kt < NS; ++kt) {
      float s0[4] = {}, s1[4] = {}, dp0[4] = {}, dp1[4] = {};
      mul_t<DP>(s0, s1, qa, K, kt, lane);
      probs(s0, s1, kt, L, post ? scale : 1.f, m, l, live0, live1, lane);
      mul_t<DP>(dp0, dp1, oa, V, kt, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float Di = (e >> 1) ? D1 : D0;
        dp0[e] = s0[e] * (dp0[e] - Di);
        dp1[e] = s1[e] * (dp1[e] - Di);
      }
      unsigned da[4];
      to_a(da, dp0, dp1);
      mul_n<DP>(dq, da, K, kt, lane);
    }
    float* st = stats + g * 3 * LP;
    if (tq == 0) {
      st[r0] = m[0];
      st[r0 + 8] = m[1];
      st[LP + r0] = l[0];
      st[LP + r0 + 8] = l[1];
      st[2 * LP + r0] = D0;
      st[2 * LP + r0 + 8] = D1;
    }
    const int b = p / H, h = p - (p / H) * H;
    const size_t ib = (size_t)b * a.in_b + (size_t)h * a.in_h;
    store_strip<DP>(dq, scale, a.dq + ib, a.in_r, s * 16, L, d, pair, lane, mine);
  }
  __syncthreads();

  // phase B, per key strip: P^T from the statistics, dS^T, dV = P^T dO and
  // dK = dS^T q
  for (int t = warp; t < G * NS; t += W) {
    const int g = t / NS, s = t - g * NS, p = p0 + g;
    if (p >= BH) break;
    const bf16 *Q = Qs + g * T, *K = Ks + g * T, *V = Vs + g * T, *dO = dOs + g * T;
    const float* st = stats + g * 3 * LP;
    unsigned ka[DP / 16][4], va[DP / 16][4];
    strip_frags<DP>(ka, K, s, lane);
    strip_frags<DP>(va, V, s, lane);
    float dk[DP / 8][4] = {}, dv[DP / 8][4] = {};
    const int key = s * 16 + g8;
    for (int qt = 0; qt < NS; ++qt) {
      float s0[4] = {}, s1[4] = {}, t0[4] = {}, t1[4] = {};
      mul_t<DP>(s0, s1, ka, Q, qt, lane);   // S^T: rows keys, columns queries
      mul_t<DP>(t0, t1, va, dO, qt, lane);  // dP^T
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = key + (e >> 1) * 8;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = qt * 16 + j * 8 + 2 * tq + (e & 1);
          float& sv = j ? s1[e] : s0[e];
          float& dpv = j ? t1[e] : t0[e];
          const bool live = i < L && kr < L;
          const float pr = live ? __expf((post ? sv * scale : sv) - st[i]) / st[LP + i] : 0.f;
          sv = pr;
          dpv = pr * (dpv - (live ? st[2 * LP + i] : 0.f));
        }
      }
      unsigned pa[4], da[4];
      to_a(pa, s0, s1);
      to_a(da, t0, t1);
      mul_n<DP>(dv, pa, dO, qt, lane);
      mul_n<DP>(dk, da, Q, qt, lane);
    }
    const int b = p / H, h = p - (p / H) * H;
    const size_t ib = (size_t)b * a.in_b + (size_t)h * a.in_h;
    store_strip<DP>(dk, post ? scale : 1.f, a.dk + ib, a.in_r, s * 16, L, d, pair, lane,
                    mine ? mine + DP : nullptr);
    store_strip<DP>(dv, 1.f, a.dv + ib, a.in_r, s * 16, L, d, pair, lane,
                    mine ? mine + 2 * DP : nullptr);
  }
  if (!a.colpart) return;
  __syncthreads();

  // per head, the warps' sums in warp order (a warp's strips are all of one
  // head: G = 1, or one strip per warp)
  for (int i = threadIdx.x; i < G * 3 * d; i += blockDim.x) {
    const int g = i / (3 * d), part = (i - g * 3 * d) / d, c = i - g * 3 * d - part * d;
    const int p = p0 + g;
    if (p >= BH) continue;
    float sum = 0.f;
    for (int w = 0; w < W; ++w)
      if (G == 1 || w / NS == g) sum += cs[(w * 3 + part) * DP + c];
    const int b = p / H, h = p - (p / H) * H;
    a.colpart[(size_t)b * 3 * H * d + (size_t)part * H * d + h * d + c] = sum;
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (uintptr_t)(bytes - 1)) == 0;
}

// 16-byte loads need d, every stride and every loaded base to be multiples
// of 8 elements; bf16 pair stores need them even and 4-byte aligned bases
int flags_of(const MhaArgs& a, bool bwd) {
  bool vec = a.d % 8 == 0 && a.in_b % 8 == 0 && a.in_h % 8 == 0 && a.in_r % 8 == 0 &&
             aligned(a.q, 16) && aligned(a.k, 16) && aligned(a.v, 16);
  if (bwd)
    vec = vec && a.out_b % 8 == 0 && a.out_h % 8 == 0 && a.out_r % 8 == 0 && aligned(a.dO, 16);
  int f = vec ? kVecLoads : 0;
  if (!bwd && a.d % 2 == 0 && a.out_b % 2 == 0 && a.out_h % 2 == 0 && a.out_r % 2 == 0 &&
      aligned(a.o, 4))
    f |= kPairOut;
  if (bwd && a.d % 2 == 0 && a.in_b % 2 == 0 && a.in_h % 2 == 0 && a.in_r % 2 == 0 &&
      aligned(a.dq, 4) && aligned(a.dk, 4) && aligned(a.dv, 4))
    f |= kPairIn;
  return f;
}

// The kernel of head dim d: DP = d rounded up to 16 or 32.
template <bool BWD>
const void* pick(int d) {
  if constexpr (BWD)
    return d <= 16 ? reinterpret_cast<const void*>(mha_bwd_kernel<16>)
                   : reinterpret_cast<const void*>(mha_bwd_kernel<32>);
  else
    return d <= 16 ? reinterpret_cast<const void*>(mha_fwd_kernel<16>)
                   : reinterpret_cast<const void*>(mha_fwd_kernel<32>);
}

size_t smem_of(bool bwd, int L, int d) {
  const Plan p = plan_for(L);
  const int DP = d <= 16 ? 16 : 32;
  return bwd ? bwd_smem(L, DP, p) : fwd_smem(L, DP, p.G);
}

template <bool BWD>
cudaError_t launch(const MhaArgs& a, cudaStream_t st) {
  if (a.B < 1 || a.H < 1 || !ssrl::mha_fits(a.L, a.d) ||
      (a.post != ssrl::kPreScaled && a.post != ssrl::kPostScaled))
    return cudaErrorInvalidValue;
  const void* fn = pick<BWD>(a.d);
  const Plan p = plan_for(a.L);
  const size_t smem = smem_of(BWD, a.L, a.d);
  cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return e;
  MhaArgs args = a;
  int flags = flags_of(a, BWD), G = p.G;
  void* params[] = {&args, &flags, &G};
  const long long blocks = ((long long)a.B * a.H + p.G - 1) / p.G;
  e = cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3(32 * p.W), params, smem, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

namespace ssrl {

bool mha_fits(int L, int d) { return L >= 1 && L <= MHA_MAX_L && d >= 1 && d <= 32; }

cudaError_t mha_fwd(const MhaArgs& a, cudaStream_t st) { return launch<false>(a, st); }

cudaError_t mha_bwd(const MhaArgs& a, cudaStream_t st) { return launch<true>(a, st); }

}  // namespace ssrl

extern "C" {

int ssrl_mha_fits(int L, int d) { return ssrl::mha_fits(L, d) ? 1 : 0; }

// The launch of the forward (bwd = 0) or backward (1) at (L, d): blocks per
// SM on this device (cudaOccupancyMaxActiveBlocksPerMultiprocessor), warps
// per block, dynamic shared memory per block and registers a thread.
int ssrl_mha_occupancy(int L, int d, int bwd, int* blocks_per_sm, int* warps,
                       int* smem_bytes, int* regs) {
  if (!ssrl::mha_fits(L, d)) return (int)cudaErrorInvalidValue;
  const void* fn = bwd ? pick<true>(d) : pick<false>(d);
  const Plan p = plan_for(L);
  const size_t smem = smem_of(bwd != 0, L, d);
  cudaError_t e = allow_smem(fn, smem);
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

// o = MHA(q, k, v); q, k, v with strides (in_b, in_h, in_r), o with
// (out_b, out_h, out_r); post: 0 pre-scaled q, 1 post-scaled scores.
int ssrl_mha_fwd(const void* q, const void* k, const void* v, void* o, long long in_b,
                 int in_h, int in_r, long long out_b, int out_h, int out_r, int B, int H,
                 int L, int d, float scale, int post, void* stream) {
  MhaArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.in_b = in_b; a.in_h = in_h; a.in_r = in_r;
  a.out_b = out_b; a.out_h = out_h; a.out_r = out_r;
  a.B = B; a.H = H; a.L = L; a.d = d;
  a.scale = scale;
  a.post = post;
  return (int)ssrl::mha_fwd(a, static_cast<cudaStream_t>(stream));
}

// (dq, dk, dv) in the strides of (q, k, v); dO in those of o.
int ssrl_mha_bwd(const void* q, const void* k, const void* v, const void* dO, void* dq,
                 void* dk, void* dv, long long in_b, int in_h, int in_r, long long out_b,
                 int out_h, int out_r, int B, int H, int L, int d, float scale, int post,
                 void* stream) {
  MhaArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dO = static_cast<const bf16*>(dO);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.in_b = in_b; a.in_h = in_h; a.in_r = in_r;
  a.out_b = out_b; a.out_h = out_h; a.out_r = out_r;
  a.B = B; a.H = H; a.L = L; a.d = d;
  a.scale = scale;
  a.post = post;
  return (int)ssrl::mha_bwd(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
