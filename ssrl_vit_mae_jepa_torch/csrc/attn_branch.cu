// Attention branch of a pre-LN transformer block on Hopper (sm_90a):
//   out = x + bf16(a @ Wp^T + bp),  a = MHA(bf16(LN1(x) @ Wqkv^T + bqkv))
// and its backward from (x, a, dy).
//
// Replaces the TPU kernels of ssrl_vit_mae_jepa_tpu/ops/block_pallas.py:
//   _ab_fwd (:722, body _attn_branch_fwd_kernel :536), _ab_fwd_only (:692,
//   _attn_branch_fwd_only_kernel :555) and _ab_bwd (:752,
//   _attn_branch_bwd_kernel :573), with the attention math of
//   ops/attention_pallas_stacked.py::_attn_fwd_one/_attn_bwd_one (:169-242).
//
// What bounds it on the H100: at the model's widths (D = 144/192, head dim
// d = 24/32, L = 37/145) every GEMM has K <= 3D, so each output element costs
// a few hundred MACs and the work sits far below the card's ~295 FLOP/byte
// ridge. The branch is bound by memory traffic and by launch count, not by
// the tensor cores.
//
// What this design does about it: a few simple launches per pass, each
// reading bf16 and writing bf16 only once --
//   1. LayerNorm (warp per row, f32 statistics) -> y1;
//   2. tiled WMMA GEMM with the bias in the epilogue -> qkv;
//   3. attention with one block per (image, head): q, k, v, the
//      probabilities and dS stay in shared memory as bf16 tiles, so the
//      L x L scores never reach device memory, and QK^T, PV and the
//      backward's products run as WMMA tensor-core tiles (L padded to 16,
//      the head dim to 16 or 32);
//   4. tiled GEMM with bias and residual in the epilogue -> out.
// The backward recomputes LN1 and qkv (one GEMM) instead of storing them, as
// the TPU kernel does; weight gradients use split-K GEMMs into f32 partials
// followed by a deterministic column reduction. The no-grad forward is the
// same sequence with `a` written to a scratch buffer that the caller drops.
// Separate launches, WMMA fragments and a two-stage cp.async pipeline in the
// GEMM; fusing the launches, wgmma and TMA belong to later work on speed.
//
// Numerics contract: LN statistics in f32 (two-pass, eps 1e-6); y1 and qkv
// rounded to bf16; q scaled in f32 then rounded to bf16 before QK^T; softmax
// in f32 with P rounded to bf16 before PV; `a` in bf16; the projection
// rounded to bf16 before the residual add. Backward: dS = P o (dP -
// rowsum(dP o P)) from the f32 P, rounded to bf16; dbqkv summed from the f32
// dqkv while dWqkv uses its bf16 form; all weight and bias gradients in f32.
#include "common.cuh"

namespace {

// Attention core on tensor cores. One block of ATT_WARPS warps (BWD_WARPS in
// the backward) per (image, head); q, k, v (and dO) live in shared memory as
// bf16 tiles zero-padded to LP = L rounded up to 16 rows and DP = d rounded up to 16
// columns. Each warp owns 16-row query strips: S = Q K^T and the products
// with P and dS are WMMA 16x16x16 bf16 tiles with f32 accumulation; the
// softmax and dS run in f32 on the strip's scores in shared memory. Leading
// dimensions are padded (DP + 8, LP + 8, LP + 4, 20) so that the eight rows a
// fragment load or store touches at once fall in distinct banks.
constexpr int ATT_WARPS = 4;
// the backward's strips: 5 warps split the decoder's 10 evenly (2 each)
constexpr int BWD_WARPS = 5;
constexpr int SMEM_MAX = 232448;  // per-block dynamic shared memory on sm_90

using namespace nvcuda;
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

// S strip (16 x LP, f32) = Qs[strip] K^T into Sw (ld LP + 4)
template <int DP>
__device__ __forceinline__ void score_strip(const bf16* Qs, const bf16* K, float* Sw,
                                            int strip, int LP) {
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

// Stage q (scaled in f32, rounded to bf16), k, v (and dO) for (b, h), zero
// outside [0, L) x [0, d). With d and D multiples of 8 every row segment is
// 16-byte aligned and moves as uint4 loads, several in flight per thread;
// otherwise element by element.
template <int DP>
__device__ __forceinline__ void load_head(const bf16* qkv, const bf16* da, bf16* Qs,
                                          bf16* K, bf16* V, bf16* dO, int b, int h,
                                          int L, int LP, int D, int d, float scale) {
  const size_t ld = 3 * (size_t)D;
  union Chunk {
    uint4 u;
    bf16 e[8];
  };
  if ((d & 7) == 0 && (D & 7) == 0) {
    constexpr int CPR = DP / 8;  // 16-byte chunks per padded row
    for (int idx = threadIdx.x; idx < LP * CPR; idx += blockDim.x) {
      const int i = idx / CPR, c = (idx - (idx / CPR) * CPR) * 8;
      Chunk q, k, v, g;
      q.u = k.u = v.u = g.u = make_uint4(0, 0, 0, 0);
      if (i < L && c < d) {
        const bf16* r = qkv + ((size_t)b * L + i) * ld + h * d + c;
        q.u = *reinterpret_cast<const uint4*>(r);
        k.u = *reinterpret_cast<const uint4*>(r + D);
        v.u = *reinterpret_cast<const uint4*>(r + 2 * D);
        if (da) g.u = *reinterpret_cast<const uint4*>(da + ((size_t)b * L + i) * D + h * d + c);
#pragma unroll
        for (int e = 0; e < 8; ++e) q.e[e] = tobf(bf(q.e[e]) * scale);
      }
      const int o = i * (DP + 8) + c;
      *reinterpret_cast<uint4*>(Qs + o) = q.u;
      *reinterpret_cast<uint4*>(K + o) = k.u;
      *reinterpret_cast<uint4*>(V + o) = v.u;
      if (dO) *reinterpret_cast<uint4*>(dO + o) = g.u;
    }
    return;
  }
  const bf16 zero = __float2bfloat16(0.f);
  for (int idx = threadIdx.x; idx < LP * DP; idx += blockDim.x) {
    const int i = idx / DP, c = idx - (idx / DP) * DP;
    bf16 q = zero, k = zero, v = zero, g = zero;
    if (i < L && c < d) {
      const bf16* r = qkv + ((size_t)b * L + i) * ld + h * d + c;
      q = tobf(bf(r[0]) * scale);
      k = r[D];
      v = r[2 * D];
      if (da) g = da[((size_t)b * L + i) * D + h * d + c];
    }
    const int o = i * (DP + 8) + c;
    Qs[o] = q;
    K[o] = k;
    V[o] = v;
    if (dO) dO[o] = g;
  }
}

template <int DP>
__global__ void __launch_bounds__(32 * ATT_WARPS)
    attn_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ a, int L,
                    int D, int H, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
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
  load_head<DP>(qkv, nullptr, Qs, K, V, nullptr, b, h, L, LP, D, d, scale);
  __syncthreads();

  for (int strip = warp; strip < LP / 16; strip += ATT_WARPS) {
    score_strip<DP>(Qs, K, Sw, strip, LP);
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
      if (i < L && c < d) a[((size_t)b * L + i) * D + h * d + c] = tobf(Sw[r * (LP + 4) + c]);
    }
    __syncwarp();
  }
}

// dqkv (bf16, the rounded gradient the GEMMs consume) and colpart[b][3D], the
// f32 column sums of this image's dq | dk | dv (the dbqkv partials).
template <int DP>
__global__ void __launch_bounds__(32 * BWD_WARPS)
    attn_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ da,
                    bf16* __restrict__ dqkv, float* __restrict__ colpart,
                    int L, int D, int H, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const int LP = pad16(L), PLD = LP + 8, NS = LP / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
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
  load_head<DP>(qkv, da, Qs, K, V, dO, b, h, L, LP, D, d, scale);
  for (int c = lane; c < 3 * DP; c += 32) cs[c] = 0.f;
  __syncthreads();

  const size_t ld = 3 * (size_t)D;
  bf16* dbase = dqkv + (size_t)b * L * ld + h * d;
  const int tr = lane >> 1, tc = (lane & 1) * 8;  // 8 elements of a tile row

  // phase 1, per query strip: P, dS = P o (dP - rowsum(dP o P)), dQ = dS K
  for (int strip = warp; strip < NS; strip += BWD_WARPS) {
    score_strip<DP>(Qs, K, Sw, strip, LP);
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
        dbase[(size_t)i * ld + lane] = tobf(v);
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
        const float v = tile[r * TLD + c16];
        dbase[(size_t)j * ld + (which + 1) * D + c] = tobf(v);
        s += v;
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (half == 0 && c < d) cs[(which + 1) * DP + c] += s;
    __syncwarp();
  }
  __syncthreads();

  for (int t = threadIdx.x; t < 3 * d; t += blockDim.x) {
    const int part = t / d, c = t - (t / d) * d;
    float s = 0.f;
    for (int w = 0; w < BWD_WARPS; ++w)
      s += reinterpret_cast<const float*>(w0 + w * wbytes + strip_bytes(LP) +
                                          16 * TLD * 4)[part * DP + c];
    colpart[(size_t)b * ld + part * D + h * d + c] = s;
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int DP>
cudaError_t attn_fwd_launch(const bf16* qkv, bf16* a, int B, int L, int D, int H,
                            float scale, cudaStream_t st) {
  const size_t smem = attn_fwd_smem(L, DP);
  cudaError_t e = allow_smem(attn_fwd_kernel<DP>, smem);
  if (e != cudaSuccess) return e;
  attn_fwd_kernel<DP><<<B * H, 32 * ATT_WARPS, smem, st>>>(qkv, a, L, D, H, D / H, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t attn_bwd_launch(const bf16* qkv, const bf16* da, bf16* dqkv, float* colpart,
                            int B, int L, int D, int H, float scale, cudaStream_t st) {
  const size_t smem = attn_bwd_smem(L, DP);
  cudaError_t e = allow_smem(attn_bwd_kernel<DP>, smem);
  if (e != cudaSuccess) return e;
  attn_bwd_kernel<DP><<<B * H, 32 * BWD_WARPS, smem, st>>>(qkv, da, dqkv, colpart, L, D,
                                                         H, D / H, scale);
  return cudaGetLastError();
}

cudaError_t attn_fwd(const bf16* qkv, bf16* a, int B, int L, int D, int H, float scale,
                     cudaStream_t st) {
  return D / H <= 16 ? attn_fwd_launch<16>(qkv, a, B, L, D, H, scale, st)
                     : attn_fwd_launch<32>(qkv, a, B, L, D, H, scale, st);
}

cudaError_t attn_bwd(const bf16* qkv, const bf16* da, bf16* dqkv, float* colpart, int B,
                     int L, int D, int H, float scale, cudaStream_t st) {
  return D / H <= 16
             ? attn_bwd_launch<16>(qkv, da, dqkv, colpart, B, L, D, H, scale, st)
             : attn_bwd_launch<32>(qkv, da, dqkv, colpart, B, L, D, H, scale, st);
}

// head dim <= 32; L bounded by the backward's shared memory (L <= 160 at d = 32)
bool shape_ok(int B, int L, int D, int H) {
  if (B < 1 || L < 1 || D < 8 || D > 256 || H < 1 || D % H || D / H > 32) return false;
  return attn_bwd_smem(L, pad16(D / H)) <= SMEM_MAX;
}

// Scratch of the forward: y1, qkv and, without a stash, the attention output.
size_t fwd_carve(Carver& c, size_t M, int D, bool stash, bf16** y1, bf16** qkv,
                 bf16** a_scratch) {
  *y1 = c.take<bf16>(M * D);
  *qkv = c.take<bf16>(M * 3 * D);
  *a_scratch = stash ? nullptr : c.take<bf16>(M * D);
  return c.off;
}

struct BwdPlan {
  int s_wp, k_wp, s_wqkv, k_wqkv;
  size_t part, tmp;
};

BwdPlan bwd_plan(int B, int L, int D) {
  BwdPlan p;
  const int M = B * L;
  p.k_wp = splitk_chunk(cdiv(D, BM) * cdiv(D, BN), M, &p.s_wp);
  p.k_wqkv = splitk_chunk(cdiv(3 * D, BM) * cdiv(D, BN), M, &p.s_wqkv);
  size_t part = (size_t)p.s_wp * D * D;
  const size_t cands[3] = {(size_t)B * 3 * D, (size_t)p.s_wqkv * 3 * D * D,
                           (size_t)ln_bwd_blocks(M) * 3 * D};
  for (size_t x : cands) part = x > part ? x : part;
  p.part = part;
  p.tmp = (size_t)64 * 3 * D;
  return p;
}

size_t bwd_carve(Carver& c, int B, int L, int D, bf16** y1, bf16** qkv, bf16** da,
                 bf16** dqkv, float** dy1, float** part, float** tmp) {
  const size_t M = (size_t)B * L;
  const BwdPlan p = bwd_plan(B, L, D);
  *y1 = c.take<bf16>(M * D);
  *qkv = c.take<bf16>(M * 3 * D);
  *da = c.take<bf16>(M * D);
  *dqkv = c.take<bf16>(M * 3 * D);
  *dy1 = c.take<float>(M * D);
  *part = c.take<float>(p.part);
  *tmp = c.take<float>(p.tmp);
  return c.off;
}

}  // namespace

extern "C" {

long long ssrl_attn_branch_fwd_workspace(int B, int L, int D, int stash) {
  Carver c{nullptr};
  bf16 *y1, *qkv, *as;
  return (long long)fwd_carve(c, (size_t)B * L, D, stash != 0, &y1, &qkv, &as);
}

// x, out, a: [B*L][D] bf16; ln_s, ln_b: [D] f32; wqkv: [3D][D], bqkv: [3D],
// wp: [D][D], bp: [D] bf16 (torch Linear layout). `a` null: no stash.
int ssrl_attn_branch_fwd(const void* x, const void* ln_s, const void* ln_b,
                         const void* wqkv, const void* bqkv, const void* wp,
                         const void* bp, void* out, void* a, void* ws, int B,
                         int L, int D, int H, float scale, void* stream) {
  if (!shape_ok(B, L, D, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * L;
  Carver c{static_cast<char*>(ws)};
  bf16 *y1, *qkv, *a_scratch;
  fwd_carve(c, M, D, a != nullptr, &y1, &qkv, &a_scratch);
  bf16* abuf = a ? static_cast<bf16*>(a) : a_scratch;
  const bf16* xb = static_cast<const bf16*>(x);

  launch_ln_fwd(xb, static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
                y1, M, D, st);
  GemmArgs g{};
  g.A = y1; g.lda = D;
  g.B = static_cast<const bf16*>(wqkv); g.ldb = D;
  g.M = M; g.N = 3 * D; g.K = D;
  g.C = qkv; g.ldc = 3 * D;
  g.bias = static_cast<const bf16*>(bqkv);
  launch_gemm<false, true, EPI_BIAS_BF16>(g, 1, st);

  cudaError_t e = attn_fwd(qkv, abuf, B, L, D, H, scale, st);
  if (e != cudaSuccess) return (int)e;

  GemmArgs o{};
  o.A = abuf; o.lda = D;
  o.B = static_cast<const bf16*>(wp); o.ldb = D;
  o.M = M; o.N = D; o.K = D;
  o.C = out; o.ldc = D;
  o.bias = static_cast<const bf16*>(bp);
  o.R = xb;
  launch_gemm<false, true, EPI_BIAS_RESID>(o, 1, st);
  return (int)cudaGetLastError();
}

long long ssrl_attn_branch_bwd_workspace(int B, int L, int D) {
  Carver c{nullptr};
  bf16 *y1, *qkv, *da, *dqkv;
  float *dy1, *part, *tmp;
  return (long long)bwd_carve(c, B, L, D, &y1, &qkv, &da, &dqkv, &dy1, &part, &tmp);
}

// Outputs (all written, none accumulated): dx [B*L][D] bf16; dln3 [3][D] f32
// = (d ln_s, d ln_b, d bp); dwqkv [3D][D], dbqkv [3D], dwp [D][D] f32.
int ssrl_attn_branch_bwd(const void* x, const void* ln_s, const void* ln_b,
                         const void* wqkv, const void* bqkv, const void* wp,
                         const void* a, const void* gy, void* dx, void* dln3,
                         void* dwqkv, void* dbqkv, void* dwp, void* ws, int B,
                         int L, int D, int H, float scale, void* stream) {
  if (!shape_ok(B, L, D, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * L;
  const BwdPlan plan = bwd_plan(B, L, D);
  Carver c{static_cast<char*>(ws)};
  bf16 *y1, *qkv, *da, *dqkv;
  float *dy1, *part, *tmp;
  bwd_carve(c, B, L, D, &y1, &qkv, &da, &dqkv, &dy1, &part, &tmp);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gyb = static_cast<const bf16*>(gy);
  const bf16* wqkvb = static_cast<const bf16*>(wqkv);

  // recompute y1 = LN1(x) and qkv
  launch_ln_fwd(xb, static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
                y1, M, D, st);
  GemmArgs g{};
  g.A = y1; g.lda = D;
  g.B = wqkvb; g.ldb = D;
  g.M = M; g.N = 3 * D; g.K = D;
  g.C = qkv; g.ldc = 3 * D;
  g.bias = static_cast<const bf16*>(bqkv);
  launch_gemm<false, true, EPI_BIAS_BF16>(g, 1, st);

  // dWp = dy^T a (split over the B*L rows)
  GemmArgs w{};
  w.A = gyb; w.lda = D;
  w.B = static_cast<const bf16*>(a); w.ldb = D;
  w.M = D; w.N = D; w.K = M;
  w.k_chunk = plan.k_wp;
  w.C = part; w.ldc = D; w.c_split = (long long)D * D;
  launch_gemm<true, false, EPI_F32>(w, plan.s_wp, st);
  reduce_rows(part, plan.s_wp, D * D, static_cast<float*>(dwp), tmp, st);

  // da = bf16(dy @ Wp)
  GemmArgs d{};
  d.A = gyb; d.lda = D;
  d.B = static_cast<const bf16*>(wp); d.ldb = D;
  d.M = M; d.N = D; d.K = D;
  d.C = da; d.ldc = D;
  launch_gemm<false, false, EPI_BF16>(d, 1, st);

  // attention backward -> dqkv (bf16) and dbqkv
  cudaError_t e = attn_bwd(qkv, da, dqkv, part, B, L, D, H, scale, st);
  if (e != cudaSuccess) return (int)e;
  reduce_rows(part, B, 3 * D, static_cast<float*>(dbqkv), tmp, st);

  // dWqkv = dqkv^T y1
  GemmArgs wq{};
  wq.A = dqkv; wq.lda = 3 * D;
  wq.B = y1; wq.ldb = D;
  wq.M = 3 * D; wq.N = D; wq.K = M;
  wq.k_chunk = plan.k_wqkv;
  wq.C = part; wq.ldc = D; wq.c_split = (long long)3 * D * D;
  launch_gemm<true, false, EPI_F32>(wq, plan.s_wqkv, st);
  reduce_rows(part, plan.s_wqkv, 3 * D * D, static_cast<float*>(dwqkv), tmp, st);

  // dy1 = dqkv @ Wqkv (f32)
  GemmArgs y{};
  y.A = dqkv; y.lda = 3 * D;
  y.B = wqkvb; y.ldb = D;
  y.M = M; y.N = D; y.K = 3 * D;
  y.C = dy1; y.ldc = D;
  launch_gemm<false, false, EPI_F32>(y, 1, st);

  // dx = dy + LN1'(dy1); d ln_s, d ln_b and d bp = sum(dy)
  launch_ln_bwd(xb, static_cast<const float*>(ln_s), dy1, gyb,
                static_cast<bf16*>(dx), static_cast<float*>(dln3), part, tmp, M, D,
                st);
  return (int)cudaGetLastError();
}

}  // extern "C"
