// The f32 MLP half of a pre-LN block as one CUDA-core kernel each way on
// Hopper (sm_90a):
//   out = x + (h W2^T + b2),  h = gelu(z),  z = LN2(x) W1^T + b1
// and its backward from the f32 gradient at out. It runs alone
// (ops/block_fused.py::mlp_half / mlp_half_bwd on f32 tensors): it is
// slower than the split f32 MLP branch (measured below), so the f32 whole
// block (csrc/fused_block_f32.cu) and chain (csrc/block_chain_f32.cu) keep
// the split sequence until a design of this kernel beats it.
//
// Serves the f32 instantiation of the TPU kernels of
// ssrl_vit_mae_jepa_tpu/ops/block_pallas.py _fb_fwd_impl (:408) and
// _fb_vjp_bwd (:442), the MLP half of _block_fwd_one / _block_bwd_one
// (:256-317), and of ops/block_chain.py _chain_fwd_only (:235), _chain_fwd
// (:261) and _chain_bwd (:288), the MLP half of their bodies (:85-117,
// :141-166). At f32 every rounding point there is a no-op. The bf16 MLP
// half, which the bf16 block and chain do run, is csrc/block_mlp.cu.
//
// Numerics: branch_f32.cu's contract -- f32 operands, FFMA on the CUDA cores
// with one accumulator per output summed in ascending k, no TF32 and no
// tensor-core emulation of f32, LN statistics two-pass with eps 1e-6 in
// ln_f32_kernel's order, exact erff GELU and its derivative, every sum in one
// fixed order with no atomics. fc1 sums K = D and fc2 K = F in ascending k as
// the split SIMT GEMM does (the F chunks in order, each chunk's k in order),
// and y2 is made by ln_f32_kernel's expression from its statistics, so the
// forward equals the split f32 MLP branch bit for bit.
//
// What bounds it on the H100: operations. Per row 4DF FLOP forward and 6DF
// in the fused backward (z again, dh, dy2; the two weight products stay on
// gemm_tn_f32), against 2D f32 values in and out: at D = 96-192, F = 4D,
// hundreds of FLOP per byte, far above the f32 ridge (~20 FLOP/byte at 67
// TFLOP/s and 3.35 TB/s). As the split sequence (branch_f32.cu's
// mlp_fwd_seq / mlp_bwd_seq) it also moves the F-wide intermediates through
// device memory: z, h and dz are each 4F bytes a row (342 MB at the MAE
// decoder, M = 111,360, F = 768), written and read back, and y2 and dy2 go
// through memory beside a warp-per-row LN pass each way.
//
// What this design does about it: a block owns 64 rows and walks F in
// chunks of FC = D/2 (D padded to 48 a warp: wn = ceil(D / 48) warps, FC =
// 24 wn), with the SIMT design of csrc/gemm_f32_simt.cuh -- k-major shared
// tiles read as float4 / float2 broadcasts, k-contiguous operands landing by
// cp.async in padded raw tiles that the block turns k-major one tile ahead,
// copies two tiles ahead of the FFMAs:
//   - the 64 x D product that runs the whole F walk (fc2's out, the
//     backward's dy2) stays in registers, 8 x 12 outputs a thread (the
//     GEMM's warp tile, 64 x 48 a warp); the chunk's 64 x FC product (z, dh)
//     takes 8 x 6 a thread, so a thread holds 144 accumulators;
//   - LN2 in the prologue as row statistics only: x streams in k tiles like
//     an A operand and is normalised as each tile turns k-major, so no
//     64 x D y2 tile stays resident (the backward writes y2 to memory once,
//     in its first chunk, for dW1);
//   - forward, per chunk: z = y2 W1c^T + b1 and h = gelu(z) in registers,
//     h into a k-major shared tile, then out += h W2c^T; the epilogue adds b2
//     and the residual with F_BIAS_RESID's expression. z and h never reach
//     device memory;
//   - backward, per chunk: z again, h written once (for dW2) and gelu'(z)
//     parked in shared memory; dh = g W2c (W2's rows land k-major); dz = dh
//     gelu'(z) written once (for dW1), db1's column partials per block, dz
//     into the shared tile; then dy2 += dz W1c (W1's rows land k-major);
//     the epilogue runs the LN2 backward on the dy2 tile (dx = g + LN2'(dy2),
//     per-block partials of d ln_s, d ln_b, d b2), so z and dy2 never reach
//     memory. The partials are folded by common.cuh::reduce_rows, dW2 =
//     g^T h and dW1 = dz^T y2 by gemm_tn_f32 and its fixed-order fold.
// Shared memory: ~68 KB a block at D = 192 (the chunk tile, two rings of
// 8-deep tiles), so the registers set the blocks an SM: two of 4 warps at
// D = 192, three of 3 at D = 144. The kernels are instantiated by warps a
// block (hf_launch); every edge is masked.
//
// Measured (H100 80GB HBM3, 700 W; chip_smoke.py phase 24 (a), PERF.md):
// 1.5-2.2x the device time of the split f32 MLP branch. Holding
// the walk's 64 x D tile in registers costs 144 accumulators a thread, so
// an SM runs 6-9 warps against the split GEMM's 12, and the 8 x 6 chunk
// tile reads shared memory at a higher rate per FFMA than the GEMM's 8 x 12;
// deeper k tiles and other register caps did not close the gap.
#include "common.cuh"
#include "branch_f32.cuh"
#include "gemm_f32.cuh"
#include "gemm_f32_simt.cuh"

namespace {

constexpr int HF_ROWS = 64;         // rows a block
constexpr int HF_BK = 8;            // k values a stage
constexpr int HF_RAW = HF_BK + 4;   // a raw k-contiguous tile's row, padded (48 bytes)
constexpr int HF_MAXW = 6;          // warps a block at D = 256

// Blocks an SM the register cap is set for, by warps a block: three at D <=
// 144 (~227 registers; measured faster at D = 144 on an H100, the same at 96),
// two at D = 192 (at three the accumulators spill), one above.
__host__ __device__ constexpr int hf_min_blocks(int wn) { return wn <= 3 ? 3 : wn == 4 ? 2 : 1; }

// Where the A operand of a product comes from: the block's x rows with LN2
// applied as each tile turns k-major (A_LN), the block's rows of an f32
// [M][lda] tensor (A_ROWS), or the resident k-major chunk tile (A_RES).
enum : int { A_LN, A_ROWS, A_RES };

struct HalfF32Args {
  const float* x;
  const float* ln_s;
  const float* ln_b;
  const float* w1;  // [F][D]
  const float* b1;
  const float* w2;  // [D][F]
  const float* b2;
  const float* g;   // backward: the gradient at out
  float* out;       // forward
  float* dx;        // backward: g + the half's input gradient
  float* y2;        // backward: LN2(x), h and dz for the weight products
  float* h;
  float* dz;
  float* colpart;   // backward: [blocks][F] column sums of dz
  float* lnpart;    // backward: [blocks][3][D] of dy2 xhat, dy2, g
  int M, D, F;
};

// Floats of shared memory at wn warps (D padded to DP = 48 wn): the row
// statistics and LN2's scale and bias, the chunk tile [FC][64], the A ring
// (two raw [64][RAW], two k-major [BK][64]) and the B ring (two raw
// [DP][RAW] and two k-major [BK][DP]; three k-major [BK][DP] for an operand
// that lands k-major).
__host__ __device__ constexpr int hf_smem_floats(int wn) {
  return 2 * HF_ROWS + 2 * 48 * wn + 24 * wn * HF_ROWS + 2 * HF_ROWS * HF_RAW +
         2 * HF_BK * HF_ROWS + 2 * 48 * wn * (HF_RAW + HF_BK);
}

struct Ctx {
  float* mu;
  float* inv;
  float* lns;  // LN2's scale and bias, [DP] each
  float* lnb;
  float* ares;  // the chunk tile
  float* araw;
  float* akm;
  float* bring;
  int tid, lane, warp, mi, ni, nthr, m0, M;
};

__device__ __forceinline__ Ctx make_ctx(float* s, int wn, int M) {
  Ctx c;
  c.mu = s;
  c.inv = s + HF_ROWS;
  c.lns = s + 2 * HF_ROWS;
  c.lnb = c.lns + 48 * wn;
  c.ares = c.lnb + 48 * wn;
  c.araw = c.ares + 24 * wn * HF_ROWS;
  c.akm = c.araw + 2 * HF_ROWS * HF_RAW;
  c.bring = c.akm + 2 * HF_BK * HF_ROWS;
  c.tid = threadIdx.x;
  c.lane = c.tid & 31;
  c.warp = c.tid >> 5;
  c.mi = c.lane & 7;
  c.ni = c.lane >> 3;
  c.nthr = 32 * wn;
  c.m0 = blockIdx.x * HF_ROWS;
  c.M = M;
  return c;
}

// A thread's row r of the block's 64: rows 32 (i / 4) + 4 mi + i % 4.
__device__ __forceinline__ int row_of(const Ctx& c, int i) {
  return 32 * (i >> 2) + 4 * c.mi + (i & 3);
}

// LN2's row statistics of the block's rows, as ln_f32_kernel takes them (one
// warp a row, lane-strided sums, a butterfly, two passes): mu and 1/sigma,
// 0 for rows past M; and LN2's scale and bias into shared memory.
__device__ __forceinline__ void ln_stats(const Ctx& c, const float* __restrict__ x,
                                         const float* __restrict__ ln_s,
                                         const float* __restrict__ ln_b, int D) {
  for (int k = c.tid; k < 48 * (c.nthr / 32); k += c.nthr) {
    c.lns[k] = k < D ? ln_s[k] : 0.f;
    c.lnb[k] = k < D ? ln_b[k] : 0.f;
  }
  for (int r = c.warp; r < HF_ROWS; r += c.nthr / 32) {
    const int row = c.m0 + r;
    float mu = 0.f, inv = 0.f;
    if (row < c.M) {
      const float* xr = x + (size_t)row * D;
      float t = 0.f;
      for (int k = c.lane; k < D; k += 32) t += xr[k];
      mu = warp_sum(t) / (float)D;
      float q = 0.f;
      for (int k = c.lane; k < D; k += 32) {
        const float d = xr[k] - mu;
        q += d * d;
      }
      inv = 1.f / sqrtf(warp_sum(q) / (float)D + kLnEps);
    }
    if (c.lane == 0) {
      c.mu[r] = mu;
      c.inv[r] = inv;
    }
  }
}

// acc (8 x TN a thread) += A (64 x K) B (K x nb), one fmaf chain per output
// in ascending k. TN 12: the thread's columns are 48 warp + 16 j + 4 ni +
// (0..3) of nb = 48 wn; TN 6: 24 warp + 6 ni + (0..5) of nb = 24 wn. A: see
// A_LN / A_ROWS / A_RES (a: the source, lda its row length; with A_LN,
// y2out, where set, gets y2). B: BROW, n rows of k-contiguous values b[n *
// ldb + k], turned k-major here; else k rows b[k * ldb + n] landing
// k-major. Only n < nlim and k < K are read, the rest is zero. Iteration t:
// a barrier (tile t + 1 has landed, tile t is k-major, every warp is done
// with tile t - 1), tile t + 2's copies, tile t + 1 turned k-major, tile t
// multiplied.
template <int VEC, int TN, int AM, bool BROW>
__device__ __forceinline__ void product(float (&acc)[8][TN], const Ctx& c, const float* a,
                                        int lda, float* y2out, const float* b, int ldb,
                                        int nlim, int nb, int K) {
  __syncthreads();  // the rings are free, and the chunk tile is written
  const int nk = (K + HF_BK - 1) / HF_BK;
  float* const b_raw = c.bring;
  float* const b_km = BROW ? c.bring + 2 * nb * HF_RAW : c.bring;
  auto b_land = [&](int t) {
    return BROW ? b_raw + (t & 1) * nb * HF_RAW : b_km + (t % 3) * HF_BK * nb;
  };
  auto b_tile = [&](int t) {
    return BROW ? b_km + (t & 1) * HF_BK * nb : b_km + (t % 3) * HF_BK * nb;
  };

  auto load = [&](int t) {
    if (t < nk) {
      const int k0 = t * HF_BK;
      if constexpr (AM != A_RES) {
        constexpr int PER = HF_BK / VEC;
        float* land = c.araw + (t & 1) * HF_ROWS * HF_RAW;
        for (int i = c.tid; i < HF_ROWS * PER; i += c.nthr) {
          const int r = i / PER, k = (i % PER) * VEC;
          const int gr = c.m0 + r, gk = k0 + k;
          const bool ok = gr < c.M && gk < K;
          cp_async_f32<VEC>(land + r * HF_RAW + k, ok ? a + (size_t)gr * lda + gk : a, ok);
        }
      }
      float* land = b_land(t);
      if constexpr (BROW) {
        constexpr int PER = HF_BK / VEC;
        for (int i = c.tid; i < nb * PER; i += c.nthr) {
          const int n = i / PER, k = (i % PER) * VEC;
          const bool ok = n < nlim && k0 + k < K;
          cp_async_f32<VEC>(land + n * HF_RAW + k, ok ? b + (size_t)n * ldb + k0 + k : b, ok);
        }
      } else {
        const int per = nb / VEC;
        for (int i = c.tid; i < HF_BK * per; i += c.nthr) {
          const int k = i / per, n = (i % per) * VEC;
          const bool ok = n < nlim && k0 + k < K;
          cp_async_f32<VEC>(land + k * nb + n, ok ? b + (size_t)(k0 + k) * ldb + n : b, ok);
        }
      }
    }
    cp_async_commit();
  };

  // a raw tile [rows][RAW] into the k-major [BK][rows]: a float4 of 4 k a
  // lane, lanes on consecutive rows (the 48-byte rows put 8 lanes' reads on
  // distinct banks)
  auto transpose = [&](int t) {
    if (t >= nk) return;
    if constexpr (AM != A_RES) {
      const float* raw = c.araw + (t & 1) * HF_ROWS * HF_RAW;
      float* km = c.akm + (t & 1) * HF_BK * HF_ROWS;
      for (int i = c.tid; i < HF_ROWS * HF_BK / 4; i += c.nthr) {
        const int r = i % HF_ROWS, k = (i / HF_ROWS) * 4;
        const float4 v = *reinterpret_cast<const float4*>(raw + r * HF_RAW + k);
        float e[4] = {v.x, v.y, v.z, v.w};
        if constexpr (AM == A_LN) {
          const int row = c.m0 + r, gk = t * HF_BK + k;
          const float mu = c.mu[r], inv = c.inv[r];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            e[q] = row < c.M && gk + q < K
                       ? (e[q] - mu) * inv * c.lns[gk + q] + c.lnb[gk + q]
                       : 0.f;
          if (y2out && row < c.M) {
            float* yr = y2out + (size_t)row * K + gk;
            if (VEC == 4 && gk + 3 < K) {
              *reinterpret_cast<float4*>(yr) = make_float4(e[0], e[1], e[2], e[3]);
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q)
                if (gk + q < K) yr[q] = e[q];
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) km[(k + q) * HF_ROWS + r] = e[q];
      }
    }
    if constexpr (BROW) {
      const float* raw = b_raw + (t & 1) * nb * HF_RAW;
      float* km = b_tile(t);
      for (int i = c.tid; i < nb * HF_BK / 4; i += c.nthr) {
        const int r = i % nb, k = (i / nb) * 4;
        const float4 v = *reinterpret_cast<const float4*>(raw + r * HF_RAW + k);
        km[k * nb + r] = v.x;
        km[(k + 1) * nb + r] = v.y;
        km[(k + 2) * nb + r] = v.z;
        km[(k + 3) * nb + r] = v.w;
      }
    }
  };

  const int col0 = TN == 12 ? 48 * c.warp + 4 * c.ni : 24 * c.warp + 6 * c.ni;
  load(0);
  load(1);
  cp_async_wait<1>();
  __syncthreads();
  transpose(0);
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    load(t + 2);
    transpose(t + 1);
    const float* as = AM == A_RES ? c.ares + t * HF_BK * HF_ROWS
                                  : c.akm + (t & 1) * HF_BK * HF_ROWS;
    const float* bs = b_tile(t) + col0;
#pragma unroll
    for (int k = 0; k < HF_BK; ++k) {
      float av[8], bv[TN];
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(as + k * HF_ROWS + 32 * g + 4 * c.mi);
        av[4 * g] = v.x;
        av[4 * g + 1] = v.y;
        av[4 * g + 2] = v.z;
        av[4 * g + 3] = v.w;
      }
      if constexpr (TN == 12) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(bs + k * nb + 16 * j);
          bv[4 * j] = v.x;
          bv[4 * j + 1] = v.y;
          bv[4 * j + 2] = v.z;
          bv[4 * j + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float2 v = *reinterpret_cast<const float2*>(bs + k * nb + 2 * j);
          bv[2 * j] = v.x;
          bv[2 * j + 1] = v.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) a[i][j] = 0.f;
}

// v[i][q] (the 8 x 6 chunk tile of a thread) into the k-major chunk tile
// ares[f][64], rows 4 mi + (0..3) of each half as one float4.
__device__ __forceinline__ void store_chunk_tile(const Ctx& c, const float (&v)[8][6]) {
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const int f = 24 * c.warp + 6 * c.ni + q;
      *reinterpret_cast<float4*>(c.ares + f * HF_ROWS + 32 * g + 4 * c.mi) =
          make_float4(v[4 * g][q], v[4 * g + 1][q], v[4 * g + 2][q], v[4 * g + 3][q]);
    }
}

// v[i][q] into rows m0 + row_of(i), columns f0 + 24 warp + 6 ni + q (< f0 +
// fn) of an [M][F] tensor, in pairs where aligned.
template <int VEC>
__device__ __forceinline__ void store_chunk_rows(const Ctx& c, float* __restrict__ dst, int F,
                                                 int f0, int fn, const float (&v)[8][6]) {
  const int fl = 24 * c.warp + 6 * c.ni;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = c.m0 + row_of(c, i);
    if (m >= c.M) continue;
    float* row = dst + (size_t)m * F + f0 + fl;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int f = fl + 2 * j;
      if (VEC == 4 && f + 1 < fn) {
        *reinterpret_cast<float2*>(row + 2 * j) = make_float2(v[i][2 * j], v[i][2 * j + 1]);
      } else {
        if (f < fn) row[2 * j] = v[i][2 * j];
        if (f + 1 < fn) row[2 * j + 1] = v[i][2 * j + 1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <int WN, int VEC>
__global__ void __launch_bounds__(32 * WN, hf_min_blocks(WN))
    mlp_half_f32_fwd_kernel(const HalfF32Args p) {
  constexpr int FC = 24 * WN;
  extern __shared__ float4 hf_smem[];
  const Ctx c = make_ctx(reinterpret_cast<float*>(hf_smem), WN, p.M);
  ln_stats(c, p.x, p.ln_s, p.ln_b, p.D);
  float acc[8][12];
  zero(acc);
  for (int f0 = 0; f0 < p.F; f0 += FC) {
    const int fn = min(FC, p.F - f0);
    float z[8][6];
    zero(z);
    // z = y2 W1c^T, W1's rows f0.. (k-contiguous)
    product<VEC, 6, A_LN, true>(z, c, p.x, p.D, nullptr, p.w1 + (size_t)f0 * p.D, p.D, fn,
                                FC, p.D);
    // h = gelu(z + b1), F_BIAS_GELU's expression; 0 past F
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const int f = 24 * c.warp + 6 * c.ni + q;
      const float bb = f < fn ? p.b1[f0 + f] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float x = z[i][q];
        x += bb;
        z[i][q] = f < fn ? gelu_erf(x) : 0.f;
      }
    }
    store_chunk_tile(c, z);
    // out += h W2c^T: W2's rows (n = d) over k = f0 .. f0 + fn
    product<VEC, 12, A_RES, true>(acc, c, nullptr, 0, nullptr, p.w2 + f0, p.F, p.D, 48 * WN,
                                  fn);
  }
  // out = x + (acc + b2), F_BIAS_RESID's expression
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = c.m0 + row_of(c, i);
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int n = 48 * c.warp + 16 * j + 4 * c.ni;
      if (n >= p.D) continue;
      const size_t o = (size_t)m * p.D + n;
      float r[4] = {0.f, 0.f, 0.f, 0.f}, bb[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (VEC == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p.x + o);
        const float4 u = *reinterpret_cast<const float4*>(p.b2 + n);
        r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
        bb[0] = u.x; bb[1] = u.y; bb[2] = u.z; bb[3] = u.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (n + q < p.D) {
            r[q] = p.x[o + q];
            bb[q] = p.b2[n + q];
          }
      }
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float x = acc[i][4 * j + q];
        x += bb[q];
        v[q] = r[q] + x;
      }
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(p.out + o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (n + q < p.D) p.out[o + q] = v[q];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

template <int WN, int VEC>
__global__ void __launch_bounds__(32 * WN, hf_min_blocks(WN))
    mlp_half_f32_bwd_kernel(const HalfF32Args p) {
  constexpr int FC = 24 * WN;
  extern __shared__ float4 hf_smem[];
  const Ctx c = make_ctx(reinterpret_cast<float*>(hf_smem), WN, p.M);
  ln_stats(c, p.x, p.ln_s, p.ln_b, p.D);
  float acc[8][12];  // dy2
  zero(acc);
  for (int f0 = 0; f0 < p.F; f0 += FC) {
    const int fn = min(FC, p.F - f0);
    float t[8][6];
    zero(t);
    // z = y2 W1c^T again (y2 written in the first chunk)
    product<VEC, 6, A_LN, true>(t, c, p.x, p.D, f0 == 0 ? p.y2 : nullptr,
                                p.w1 + (size_t)f0 * p.D, p.D, fn, FC, p.D);
    // h = gelu(z) out for dW2; gelu'(z) parked in the chunk tile, thread-major
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const int f = 24 * c.warp + 6 * c.ni + q;
      const float bb = f < fn ? p.b1[f0 + f] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float z = t[i][q];
        z += bb;
        c.ares[(i * 6 + q) * c.nthr + c.tid] = gelu_erf_grad(z);
        t[i][q] = gelu_erf(z);
      }
    }
    store_chunk_rows<VEC>(c, p.h, p.F, f0, fn, t);
    zero(t);
    // dh = g W2c: W2's rows d (k) over columns f0 .. f0 + fn (n), k-major
    product<VEC, 6, A_ROWS, false>(t, c, p.g, p.D, nullptr, p.w2 + f0, p.F, fn, FC, p.D);
    // dz = dh gelu'(z) (F_GELU_BWD's expression); 0 past F and M
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const int f = 24 * c.warp + 6 * c.ni + q;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float x = t[i][q];
        x *= c.ares[(i * 6 + q) * c.nthr + c.tid];
        x = f < fn && c.m0 + row_of(c, i) < p.M ? x : 0.f;
        t[i][q] = x;
        s += x;
      }
      // db1: the block's column sums, rows in one fixed order
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      if (c.mi == 0 && f < fn) p.colpart[(size_t)blockIdx.x * p.F + f0 + f] = s;
    }
    store_chunk_rows<VEC>(c, p.dz, p.F, f0, fn, t);
    __syncthreads();  // every thread has read its gelu'(z)
    store_chunk_tile(c, t);
    // dy2 += dz W1c: W1's rows f0 .. f0 + fn (k) over columns d (n), k-major
    product<VEC, 12, A_RES, false>(acc, c, nullptr, 0, nullptr, p.w1 + (size_t)f0 * p.D, p.D,
                                   p.D, 48 * WN, fn);
  }

  // The LN2 backward on the dy2 tile: dx = g + (g0 - m1 - xhat m2) inv, g0 =
  // dy2 s, m1 and m2 the row means of g0 and g0 xhat; the row sums go
  // through shared memory (per warp, then the warps in order).
  __syncthreads();  // the rings are free
  float* red = c.bring;  // [wn][64][2]
  const int D = p.D;
  float sc[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const int n = 48 * c.warp + 16 * (j >> 2) + 4 * c.ni + (j & 3);
    sc[j] = c.lns[n];  // 0 past D
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row_of(c, i), m = c.m0 + r;
    float s1 = 0.f, s2 = 0.f;
    if (m < p.M) {
      const float mu = c.mu[r], inv = c.inv[r];
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int n = 48 * c.warp + 16 * (j >> 2) + 4 * c.ni + (j & 3);
        if (n < D) {
          const float xh = (p.x[(size_t)m * D + n] - mu) * inv;
          const float g0 = acc[i][j] * sc[j];
          s1 += g0;
          s2 += g0 * xh;
        }
      }
    }
    s1 += __shfl_xor_sync(0xffffffffu, s1, 8);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 16);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 8);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 16);
    if (c.ni == 0) {
      red[(c.warp * HF_ROWS + r) * 2] = s1;
      red[(c.warp * HF_ROWS + r) * 2 + 1] = s2;
    }
  }
  __syncthreads();
  float cs[12], cb[12], cg[12];  // column partials: dy2 xhat, dy2, g
#pragma unroll
  for (int j = 0; j < 12; ++j) cs[j] = cb[j] = cg[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row_of(c, i), m = c.m0 + r;
    if (m >= p.M) continue;
    float m1 = 0.f, m2 = 0.f;
    for (int w = 0; w < WN; ++w) {
      m1 += red[(w * HF_ROWS + r) * 2];
      m2 += red[(w * HF_ROWS + r) * 2 + 1];
    }
    m1 /= (float)D;
    m2 /= (float)D;
    const float mu = c.mu[r], inv = c.inv[r];
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int n = 48 * c.warp + 16 * (j >> 2) + 4 * c.ni + (j & 3);
      if (n < D) {
        const size_t o = (size_t)m * D + n;
        const float xh = (p.x[o] - mu) * inv;
        const float gv = p.g[o];
        const float g0 = acc[i][j] * sc[j];
        p.dx[o] = gv + (g0 - m1 - xh * m2) * inv;
        cs[j] += acc[i][j] * xh;
        cb[j] += acc[i][j];
        cg[j] += gv;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 12; ++j) {
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      cs[j] += __shfl_xor_sync(0xffffffffu, cs[j], o);
      cb[j] += __shfl_xor_sync(0xffffffffu, cb[j], o);
      cg[j] += __shfl_xor_sync(0xffffffffu, cg[j], o);
    }
    const int n = 48 * c.warp + 16 * (j >> 2) + 4 * c.ni + (j & 3);
    if (c.mi == 0 && n < D) {
      float* lp = p.lnpart + (size_t)blockIdx.x * 3 * D;
      lp[n] = cs[j];
      lp[D + n] = cb[j];
      lp[2 * D + n] = cg[j];
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The kernel for D's warps, launched on a block per 64 rows: the model's
// widths (96, 144, 192) at WN = D / 48, a narrower D at 2 warps and a wider
// one at HF_MAXW, and rows not 16-byte aligned in the 4-byte copies of the
// HF_MAXW kernel (the columns past D masked), so that the build holds ten
// kernels.
template <int WN, int VEC, template <int, int> class Kernel>
cudaError_t hf_launch_wn(const HalfF32Args& a, cudaStream_t st) {
  constexpr int smem = (int)sizeof(float) * hf_smem_floats(WN);
  auto kernel = Kernel<WN, VEC>::fn;
  SSRL_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  kernel<<<cdiv(a.M, HF_ROWS), 32 * WN, smem, st>>>(a);
  return cudaGetLastError();
}

template <template <int, int> class Kernel>
cudaError_t hf_launch(const HalfF32Args& a, bool vec, cudaStream_t st) {
  if (!vec) return hf_launch_wn<HF_MAXW, 1, Kernel>(a, st);
  switch (cdiv(a.D, 48)) {
    case 1:
    case 2: return hf_launch_wn<2, 4, Kernel>(a, st);
    case 3: return hf_launch_wn<3, 4, Kernel>(a, st);
    case 4: return hf_launch_wn<4, 4, Kernel>(a, st);
    default: return hf_launch_wn<HF_MAXW, 4, Kernel>(a, st);
  }
}

template <int WN, int VEC>
struct HalfFwd {
  static constexpr auto fn = mlp_half_f32_fwd_kernel<WN, VEC>;
};
template <int WN, int VEC>
struct HalfBwd {
  static constexpr auto fn = mlp_half_f32_bwd_kernel<WN, VEC>;
};

struct HalfF32Ws {
  float *y2, *h, *dz, *colpart, *lnpart, *part, *tmp;
};

size_t hf_bwd_carve(Carver& c, int M, int D, int F, HalfF32Ws* w) {
  const int blocks = cdiv(M, HF_ROWS);
  size_t part = ssrl::gemm_tn_f32_part_floats(D, F, M);  // dW2 (D, F), then dW1 (F, D)
  const size_t other = ssrl::gemm_tn_f32_part_floats(F, D, M);
  part = other > part ? other : part;
  w->y2 = c.take<float>((size_t)M * D);
  w->h = c.take<float>((size_t)M * F);
  w->dz = c.take<float>((size_t)M * F);
  w->colpart = c.take<float>((size_t)blocks * F);
  w->lnpart = c.take<float>((size_t)blocks * 3 * D);
  w->part = c.take<float>(part);
  w->tmp = c.take<float>((size_t)64 * (F > 3 * D ? F : 3 * D));
  return c.off;
}

}  // namespace

namespace ssrl {

cudaError_t mlp_half_f32_fwd(const float* x, const BranchParamsF32& p, float* out, int M,
                             int D, int F, cudaStream_t st) {
  if (!mlp_f32_ok(M, D, F)) return cudaErrorInvalidValue;
  HalfF32Args a{};
  a.x = x; a.ln_s = p.ln_s; a.ln_b = p.ln_b; a.w1 = p.wa; a.b1 = p.ba; a.w2 = p.wb; a.b2 = p.bb;
  a.out = out;
  a.M = M; a.D = D; a.F = F;
  const bool vec = D % 4 == 0 && F % 4 == 0 && aligned16(x) && aligned16(p.wa) &&
                   aligned16(p.wb) && aligned16(p.bb) && aligned16(out);
  return hf_launch<HalfFwd>(a, vec, st);
}

size_t mlp_half_f32_bwd_workspace(int M, int D, int F) {
  Carver c{nullptr};
  HalfF32Ws w;
  return hf_bwd_carve(c, M, D, F, &w);
}

cudaError_t mlp_half_f32_bwd(const float* x, const BranchParamsF32& p, const float* g,
                             float* dx, const BranchGrads& d, void* ws, int M, int D, int F,
                             cudaStream_t st) {
  if (!mlp_f32_ok(M, D, F)) return cudaErrorInvalidValue;
  Carver c{static_cast<char*>(ws)};
  HalfF32Ws w;
  hf_bwd_carve(c, M, D, F, &w);
  HalfF32Args a{};
  a.x = x; a.ln_s = p.ln_s; a.ln_b = p.ln_b; a.w1 = p.wa; a.b1 = p.ba; a.w2 = p.wb;
  a.g = g; a.dx = dx; a.y2 = w.y2; a.h = w.h; a.dz = w.dz;
  a.colpart = w.colpart; a.lnpart = w.lnpart;
  a.M = M; a.D = D; a.F = F;
  const bool vec = D % 4 == 0 && F % 4 == 0 && aligned16(x) && aligned16(p.wa) &&
                   aligned16(p.wb) && aligned16(g);
  SSRL_TRY(hf_launch<HalfBwd>(a, vec, st));
  const int blocks = cdiv(M, HF_ROWS);
  // db1, and d ln_s, d ln_b, d b2, from the per-block partials
  reduce_rows(w.colpart, blocks, F, d.dba, w.tmp, st);
  reduce_rows(w.lnpart, blocks, 3 * D, d.dln3, w.tmp, st);
  SSRL_TRY(cudaGetLastError());
  // dW2 = g^T h, dW1 = dz^T y2 (split over the M rows, folded in one order)
  SSRL_TRY(gemm_tn_f32(g, w.h, d.dwb, w.part, D, F, M, st));
  return gemm_tn_f32(w.dz, w.y2, d.dwa, w.part, F, D, M, st);
}

}  // namespace ssrl

extern "C" {

// x, out: [M][D] f32; ln_s, ln_b: [D]; w1: [F][D], b1: [F], w2: [D][F], b2:
// [D], all f32 (torch Linear layout).
int ssrl_mlp_half_fwd_f32(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                          const void* b1, const void* w2, const void* b2, void* out, int M,
                          int D, int F, void* stream) {
  const void* p[6] = {ln_s, ln_b, w1, b1, w2, b2};
  return (int)ssrl::mlp_half_f32_fwd(static_cast<const float*>(x), ssrl::branch_params_f32(p),
                                     static_cast<float*>(out), M, D, F,
                                     static_cast<cudaStream_t>(stream));
}

long long ssrl_mlp_half_bwd_f32_workspace(int M, int D, int F) {
  return (long long)ssrl::mlp_half_f32_bwd_workspace(M, D, F);
}

// From x and the gradient at out (g, [M][D] f32): dx = g + the half's input
// gradient [M][D]; dln3 [3][D] = (d ln_s, d ln_b, d b2); dw1 [F][D]; db1
// [F]; dw2 [D][F]; all f32.
int ssrl_mlp_half_bwd_f32(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                          const void* b1, const void* w2, const void* g, void* dx, void* dln3,
                          void* dw1, void* db1, void* dw2, void* ws, int M, int D, int F,
                          void* stream) {
  const void* p[6] = {ln_s, ln_b, w1, b1, w2, nullptr};
  const ssrl::BranchGrads d{static_cast<float*>(dln3), static_cast<float*>(dw1),
                            static_cast<float*>(db1), static_cast<float*>(dw2)};
  return (int)ssrl::mlp_half_f32_bwd(static_cast<const float*>(x), ssrl::branch_params_f32(p),
                                     static_cast<const float*>(g), static_cast<float*>(dx), d,
                                     ws, M, D, F, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
