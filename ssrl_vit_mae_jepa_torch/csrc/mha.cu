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
// What bounds it on the H100: at the model's shapes (L = 37/145, d = 16-32)
// a head's work is 4 L^2 d FLOP forward against 8 L d bytes of q, k, v, o,
// i.e. ~2.3 FLOP/byte at L = 145 -- far below the card's ~295 FLOP/byte
// ridge. The kernel is bound by device-memory traffic; the floor is reading
// q, k, v (and dO) once and writing o (or dq, dk, dv) once.
//
// What the design does about it: one block per (image, head) stages its q,
// k, v (and dO) into shared memory as bf16 tiles, zero-padded to LP = L
// rounded up to 16 rows and DP = d rounded up to 16 or 32 columns, so that
// the L x L scores, P and dS never reach device memory; QK^T, PV and the
// backward's products run as WMMA 16x16x16 tensor-core tiles with f32
// accumulation; softmax and dS run in f32. Each tensor moves exactly once.
// The backward holds bf16 P and dS for the whole head (~214 KB at L = 145,
// d = 32), so one block runs per SM; mha_fits refuses shapes that would not
// fit (L > 160 at d = 32). wgmma, TMA and more blocks per SM are later work.
#include "common.cuh"
#include "mha.cuh"

namespace {

using ssrl::MhaArgs;
using namespace nvcuda;

// One block of ATT_WARPS warps (BWD_WARPS in the backward) per (image,
// head). Each warp owns 16-row query strips. Leading dimensions are padded
// (DP + 8, LP + 8, LP + 4, 20) so that the eight rows a fragment load or
// store touches at once fall in distinct banks.
constexpr int ATT_WARPS = 4;
// the backward's strips: 5 warps split the decoder's 10 evenly (2 each)
constexpr int BWD_WARPS = 5;
constexpr int SMEM_MAX = 232448;  // per-block dynamic shared memory on sm_90

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }
constexpr int TLD = 20;  // leading dimension of a warp's 16x16 f32 tile

// per-warp scratch: an f32 score strip [16][LP + 4], then (fwd) a bf16
// probability strip [16][LP + 8] or (bwd) a [16][TLD] f32 tile + column sums
__host__ __device__ inline size_t strip_bytes(int LP) { return (size_t)16 * (LP + 4) * 4; }

inline size_t attn_fwd_smem(int L, int DP) {
  const int LP = pad16(L);
  return (size_t)3 * LP * (DP + 8) * 2 +
         ATT_WARPS * (strip_bytes(LP) + (size_t)16 * (LP + 8) * 2);
}

inline size_t attn_bwd_smem(int L, int DP) {
  const int LP = pad16(L);
  return (size_t)4 * LP * (DP + 8) * 2 + (size_t)2 * LP * (LP + 8) * 2 +
         BWD_WARPS * (strip_bytes(LP) + 16 * TLD * 4 + (size_t)3 * DP * 4);
}

// S strip (16 x LP, f32) = Qs[strip] K^T into Sw (ld LP + 4); post-scaled
// scores are multiplied by the scale in f32 before the store
template <int DP, bool POST>
__device__ __forceinline__ void score_strip(const bf16* Qs, const bf16* K, float* Sw,
                                            int strip, int LP, float scale) {
  FragA fq[DP / 16];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wmma::load_matrix_sync(fq[kk], Qs + strip * 16 * (DP + 8) + kk * 16, DP + 8);
  for (int n = 0; n < LP / 16; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      FragBT fk;
      wmma::load_matrix_sync(fk, K + n * 16 * (DP + 8) + kk * 16, DP + 8);
      wmma::mma_sync(acc, fq[kk], fk, acc);
    }
    if (POST) {
#pragma unroll
      for (int t = 0; t < acc.num_elements; ++t) acc.x[t] *= scale;
    }
    wmma::store_matrix_sync(Sw + n * 16, acc, LP + 4, wmma::mem_row_major);
  }
}

// In-place row softmax of the strip (rows i >= L and columns j >= L give 0):
// Sw keeps the f32 P, and P (ld pld) gets its bf16 rounding. Two lanes per
// row, each over every other column, so the 16 rows proceed together.
__device__ __forceinline__ void softmax_strip(float* Sw, bf16* P, int pld, int strip,
                                              int L, int LP, int lane) {
  const int r = lane >> 1, h = lane & 1;
  float* s = Sw + r * (LP + 4);
  bf16* p = P + r * pld;
  const bool live = strip * 16 + r < L;
  float mx = -INFINITY;
  for (int j = h; j < L; j += 2) mx = fmaxf(mx, s[j]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  float sum = 0.f;
  for (int j = h; j < L; j += 2) {
    const float e = expf(s[j] - mx);
    s[j] = e;
    sum += e;
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  for (int j = h; j < LP; j += 2) {
    const float v = (live && j < L) ? s[j] / sum : 0.f;
    s[j] = v;
    p[j] = tobf(v);
  }
}

// Stage q (pre-scaled: scaled in f32, rounded to bf16), k, v (and dO) of
// (b, h), zero outside [0, L) x [0, d). When every row segment is 16-byte
// aligned (`vec`) it moves as uint4 loads, several in flight per thread;
// otherwise element by element. Both give the same values.
template <int DP, bool POST>
__device__ __forceinline__ void load_head(const MhaArgs& a, bool vec, int b, int h,
                                          int LP, bf16* Qs, bf16* K, bf16* V, bf16* dO) {
  const size_t ib = (size_t)b * a.in_b + (size_t)h * a.in_h;
  const bf16 *q = a.q + ib, *k = a.k + ib, *v = a.v + ib;
  const bf16* g = dO ? a.dO + (size_t)b * a.out_b + (size_t)h * a.out_h : nullptr;
  const int L = a.L, d = a.d;
  union Chunk {
    uint4 u;
    bf16 e[8];
  };
  if (vec) {
    constexpr int CPR = DP / 8;  // 16-byte chunks per padded row
    for (int idx = threadIdx.x; idx < LP * CPR; idx += blockDim.x) {
      const int i = idx / CPR, c = (idx - (idx / CPR) * CPR) * 8;
      Chunk cq, ck, cv, cg;
      cq.u = ck.u = cv.u = cg.u = make_uint4(0, 0, 0, 0);
      if (i < L && c < d) {
        const size_t r = (size_t)i * a.in_r + c;
        cq.u = *reinterpret_cast<const uint4*>(q + r);
        ck.u = *reinterpret_cast<const uint4*>(k + r);
        cv.u = *reinterpret_cast<const uint4*>(v + r);
        if (g) cg.u = *reinterpret_cast<const uint4*>(g + (size_t)i * a.out_r + c);
        if (!POST) {
#pragma unroll
          for (int e = 0; e < 8; ++e) cq.e[e] = tobf(bf(cq.e[e]) * a.scale);
        }
      }
      const int o = i * (DP + 8) + c;
      *reinterpret_cast<uint4*>(Qs + o) = cq.u;
      *reinterpret_cast<uint4*>(K + o) = ck.u;
      *reinterpret_cast<uint4*>(V + o) = cv.u;
      if (dO) *reinterpret_cast<uint4*>(dO + o) = cg.u;
    }
    return;
  }
  const bf16 zero = __float2bfloat16(0.f);
  for (int idx = threadIdx.x; idx < LP * DP; idx += blockDim.x) {
    const int i = idx / DP, c = idx - (idx / DP) * DP;
    bf16 qe = zero, ke = zero, ve = zero, ge = zero;
    if (i < L && c < d) {
      const size_t r = (size_t)i * a.in_r + c;
      qe = POST ? q[r] : tobf(bf(q[r]) * a.scale);
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

template <int DP, bool POST>
__global__ void __launch_bounds__(32 * ATT_WARPS) mha_fwd_kernel(const MhaArgs a, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, L = a.L, d = a.d;
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const int LP = pad16(L), PLD = LP + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* K = Qs + LP * (DP + 8);
  bf16* V = K + LP * (DP + 8);
  unsigned char* mine = reinterpret_cast<unsigned char*>(V + LP * (DP + 8)) +
                        warp * (strip_bytes(LP) + (size_t)16 * PLD * 2);
  float* Sw = reinterpret_cast<float*>(mine);
  bf16* Pw = reinterpret_cast<bf16*>(mine + strip_bytes(LP));
  load_head<DP, POST>(a, vec != 0, b, h, LP, Qs, K, V, nullptr);
  __syncthreads();

  bf16* o = a.o + (size_t)b * a.out_b + (size_t)h * a.out_h;
  for (int strip = warp; strip < LP / 16; strip += ATT_WARPS) {
    score_strip<DP, POST>(Qs, K, Sw, strip, LP, a.scale);
    __syncwarp();
    softmax_strip(Sw, Pw, PLD, strip, L, LP, lane);
    __syncwarp();
    // O strip = P V, into the first DP columns of Sw
#pragma unroll
    for (int n = 0; n < DP / 16; ++n) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < LP / 16; ++kk) {
        FragA fp;
        FragB fv;
        wmma::load_matrix_sync(fp, Pw + kk * 16, PLD);
        wmma::load_matrix_sync(fv, V + kk * 16 * (DP + 8) + n * 16, DP + 8);
        wmma::mma_sync(acc, fp, fv, acc);
      }
      wmma::store_matrix_sync(Sw + n * 16, acc, LP + 4, wmma::mem_row_major);
    }
    __syncwarp();
    for (int e = lane; e < 16 * DP; e += 32) {
      const int r = e / DP, c = e - (e / DP) * DP, i = strip * 16 + r;
      if (i < L && c < d) o[(size_t)i * a.out_r + c] = tobf(Sw[r * (LP + 4) + c]);
    }
    __syncwarp();
  }
}

// dq, dk, dv rounded to bf16 and, when a.colpart is set, colpart[b][3 H d]:
// the f32 column sums of this image's dq | dk | dv (the branch's dbqkv
// partials).
template <int DP, bool POST>
__global__ void __launch_bounds__(32 * BWD_WARPS) mha_bwd_kernel(const MhaArgs a, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, L = a.L, d = a.d;
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const int LP = pad16(L), PLD = LP + 8, NS = LP / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float scale = a.scale;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* K = Qs + LP * (DP + 8);
  bf16* V = K + LP * (DP + 8);
  bf16* dO = V + LP * (DP + 8);
  bf16* P = dO + LP * (DP + 8);  // [LP][PLD], bf16 probabilities
  bf16* dS = P + LP * PLD;  // [LP][PLD]
  unsigned char* w0 = reinterpret_cast<unsigned char*>(dS + LP * PLD);
  const size_t wbytes = strip_bytes(LP) + 16 * TLD * 4 + (size_t)3 * DP * 4;
  float* Sw = reinterpret_cast<float*>(w0 + warp * wbytes);
  float* tile = Sw + 16 * (LP + 4);  // [16][TLD]
  float* cs = tile + 16 * TLD;       // [3][DP] column sums of this warp
  load_head<DP, POST>(a, vec != 0, b, h, LP, Qs, K, V, dO);
  for (int c = lane; c < 3 * DP; c += 32) cs[c] = 0.f;
  __syncthreads();

  const size_t ib = (size_t)b * a.in_b + (size_t)h * a.in_h;
  bf16* dq = a.dq + ib;
  const int tr = lane >> 1, tc = (lane & 1) * 8;  // 8 elements of a tile row

  // phase 1, per query strip: P, dS = P o (dP - rowsum(dP o P)), dQ = dS K
  for (int strip = warp; strip < NS; strip += BWD_WARPS) {
    score_strip<DP, POST>(Qs, K, Sw, strip, LP, scale);
    __syncwarp();
    softmax_strip(Sw, P + strip * 16 * PLD, PLD, strip, L, LP, lane);
    __syncwarp();
    FragA fo[DP / 16];
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wmma::load_matrix_sync(fo[kk], dO + strip * 16 * (DP + 8) + kk * 16, DP + 8);
    // two passes over the key tiles: dP = dO V^T is recomputed rather than
    // kept, once for the row sums and once for dS
    float rs = 0.f;
    for (int pass = 0; pass < 2; ++pass) {
      for (int n = 0; n < NS; ++n) {
        FragC acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          FragBT fv;
          wmma::load_matrix_sync(fv, V + n * 16 * (DP + 8) + kk * 16, DP + 8);
          wmma::mma_sync(acc, fo[kk], fv, acc);
        }
        wmma::store_matrix_sync(tile, acc, TLD, wmma::mem_row_major);
        __syncwarp();
        const float* p = Sw + tr * (LP + 4) + n * 16 + tc;
        const float* g = tile + tr * TLD + tc;
        if (pass == 0) {
#pragma unroll
          for (int c = 0; c < 8; ++c) rs += g[c] * p[c];
        } else {
          bf16* o = dS + (strip * 16 + tr) * PLD + n * 16 + tc;
#pragma unroll
          for (int c = 0; c < 8; ++c) o[c] = tobf(p[c] * (g[c] - rs));
        }
        __syncwarp();
      }
      if (pass == 0) rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    }
    __syncwarp();
    // dQ strip = dS K (then times the scale), into Sw's first DP columns
#pragma unroll
    for (int n = 0; n < DP / 16; ++n) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < NS; ++kk) {
        FragA fs;
        FragB fk;
        wmma::load_matrix_sync(fs, dS + strip * 16 * PLD + kk * 16, PLD);
        wmma::load_matrix_sync(fk, K + kk * 16 * (DP + 8) + n * 16, DP + 8);
        wmma::mma_sync(acc, fs, fk, acc);
      }
      wmma::store_matrix_sync(Sw + n * 16, acc, LP + 4, wmma::mem_row_major);
    }
    __syncwarp();
    if (lane < d) {
      float s = 0.f;
      for (int r = 0; r < 16; ++r) {
        const int i = strip * 16 + r;
        if (i >= L) break;
        const float v = Sw[r * (LP + 4) + lane] * scale;
        dq[(size_t)i * a.in_r + lane] = tobf(v);
        s += v;
      }
      cs[lane] += s;
    }
    __syncwarp();
  }
  __syncthreads();

  // phase 2, over (key tile, column tile): dK = dS^T Qs and dV = P^T dO
  const int per = NS * (DP / 16);
  for (int t = warp; t < 2 * per; t += BWD_WARPS) {
    const int which = t / per;  // 0: dK, 1: dV
    const int jt = (t % per) / (DP / 16), ct = (t % per) % (DP / 16);
    const bf16* A = which ? P : dS;
    const bf16* Bm = which ? dO : Qs;
    bf16* out = (which ? a.dv : a.dk) + ib;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < NS; ++kk) {
      FragAT fa;
      FragB fb;
      wmma::load_matrix_sync(fa, A + kk * 16 * PLD + jt * 16, PLD);
      wmma::load_matrix_sync(fb, Bm + kk * 16 * (DP + 8) + ct * 16, DP + 8);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(tile, acc, TLD, wmma::mem_row_major);
    __syncwarp();
    const int c16 = lane & 15, half = lane >> 4, c = ct * 16 + c16;
    float s = 0.f;
    if (c < d) {
      for (int r = half * 8; r < half * 8 + 8; ++r) {
        const int j = jt * 16 + r;
        if (j >= L) break;
        float v = tile[r * TLD + c16];
        if (POST && !which) v *= scale;
        out[(size_t)j * a.in_r + c] = tobf(v);
        s += v;
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (half == 0 && c < d) cs[(which + 1) * DP + c] += s;
    __syncwarp();
  }
  if (!a.colpart) return;
  __syncthreads();

  for (int t = threadIdx.x; t < 3 * d; t += blockDim.x) {
    const int part = t / d, c = t - (t / d) * d;
    float s = 0.f;
    for (int w = 0; w < BWD_WARPS; ++w)
      s += reinterpret_cast<const float*>(w0 + w * wbytes + strip_bytes(LP) +
                                          16 * TLD * 4)[part * DP + c];
    a.colpart[(size_t)b * 3 * H * d + (size_t)part * H * d + h * d + c] = s;
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// 16-byte loads need d, every stride and every loaded base to be multiples
// of 8 elements (16 bytes)
int vec_ok(const MhaArgs& a, bool bwd) {
  bool ok = a.d % 8 == 0 && a.in_b % 8 == 0 && a.in_h % 8 == 0 && a.in_r % 8 == 0 &&
            aligned16(a.q) && aligned16(a.k) && aligned16(a.v);
  if (bwd)
    ok = ok && a.out_b % 8 == 0 && a.out_h % 8 == 0 && a.out_r % 8 == 0 && aligned16(a.dO);
  return ok ? 1 : 0;
}

template <int DP, bool POST>
cudaError_t fwd_launch(const MhaArgs& a, cudaStream_t st) {
  const size_t smem = attn_fwd_smem(a.L, DP);
  cudaError_t e = allow_smem(mha_fwd_kernel<DP, POST>, smem);
  if (e != cudaSuccess) return e;
  mha_fwd_kernel<DP, POST><<<a.B * a.H, 32 * ATT_WARPS, smem, st>>>(a, vec_ok(a, false));
  return cudaGetLastError();
}

template <int DP, bool POST>
cudaError_t bwd_launch(const MhaArgs& a, cudaStream_t st) {
  const size_t smem = attn_bwd_smem(a.L, DP);
  cudaError_t e = allow_smem(mha_bwd_kernel<DP, POST>, smem);
  if (e != cudaSuccess) return e;
  mha_bwd_kernel<DP, POST><<<a.B * a.H, 32 * BWD_WARPS, smem, st>>>(a, vec_ok(a, true));
  return cudaGetLastError();
}

bool args_ok(const MhaArgs& a) {
  return a.B >= 1 && a.H >= 1 && ssrl::mha_fits(a.L, a.d) &&
         (a.post == ssrl::kPreScaled || a.post == ssrl::kPostScaled);
}

}  // namespace

namespace ssrl {

bool mha_fits(int L, int d) {
  if (L < 1 || d < 1 || d > 32) return false;
  return attn_bwd_smem(L, pad16(d)) <= SMEM_MAX;
}

cudaError_t mha_fwd(const MhaArgs& a, cudaStream_t st) {
  if (!args_ok(a)) return cudaErrorInvalidValue;
  if (a.d <= 16)
    return a.post ? fwd_launch<16, true>(a, st) : fwd_launch<16, false>(a, st);
  return a.post ? fwd_launch<32, true>(a, st) : fwd_launch<32, false>(a, st);
}

cudaError_t mha_bwd(const MhaArgs& a, cudaStream_t st) {
  if (!args_ok(a)) return cudaErrorInvalidValue;
  if (a.d <= 16)
    return a.post ? bwd_launch<16, true>(a, st) : bwd_launch<16, false>(a, st);
  return a.post ? bwd_launch<32, true>(a, st) : bwd_launch<32, false>(a, st);
}

}  // namespace ssrl

extern "C" {

int ssrl_mha_fits(int L, int d) { return ssrl::mha_fits(L, d) ? 1 : 0; }

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
