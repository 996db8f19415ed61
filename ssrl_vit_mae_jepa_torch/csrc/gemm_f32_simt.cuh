// The f32 GEMM of csrc/gemm_f32.cuh on Hopper (sm_90a): a register-tiled
// SIMT kernel, FFMA on the CUDA cores, fed by a ring of cp.async stages.
//
// Replaces the f32 instantiation of the products inside the TPU kernels of
// ssrl_vit_mae_jepa_tpu/ops/block_pallas.py (_ab_fwd :722, _ab_fwd_only
// :692, _ab_bwd :752, _mb_fwd :807, _mb_bwd :831, and through them
// _fb_fwd_impl :408 / _fb_vjp_bwd :442 and block_chain.py :235-:288 at f32).
// Its numerics contract is branch_f32.cu's: f32 operands, f32 FFMA
// accumulation in ascending k, no TF32 or tensor-core emulation, exact erff
// GELU and its derivative in the epilogues, every sum in one fixed order.
//
// What bounds it on the H100: operations. The port's products have K = 96 to
// 768 and M = B*L = 28k-111k rows, a few hundred FLOP per f32 byte moved, far
// above the card's ~20 FLOP/byte f32 ridge (67 TFLOP/s CUDA cores, 3.35 TB/s),
// so the FFMA rate is the ceiling -- reached only if shared memory, the
// registers and the tile edges keep out of its way. Counting a warp's
// shared read as one cycle of the SM's 128-byte shared port per 128 bytes
// it hands the lanes (broadcast or not), a thread's tile of TM x TN outputs
// costs TM + TN port cycles a k step against TM * TN / 4 of FFMA: the first
// version's 4 x 4 tile could run at most at half the FFMA rate.
//
// What this design does about it:
//   - 8 x 12 outputs a thread (96 accumulators, warp tile 64 x 48 as 8 x 4
//     lanes, lane % 8 on m): 20 port cycles for 24 of FFMA a k step, every
//     read a float4 of a k-major tile free of bank conflicts;
//   - k-major operands (B of NN, both of TN) land by 16-byte cp.async
//     straight in their tile; k-contiguous ones (A of NT and NN, B of NT)
//     land the same way in a raw tile of rows padded to 20 floats, which the
//     block transposes into a k-major tile one tile ahead of the FFMAs (a
//     float4 read and four conflict-free writes a lane);
//   - copies run two tiles ahead: one barrier a 16-deep tile, and tile t + 2
//     arrives while tile t is multiplied;
//   - the register cap (168 at two or three blocks an SM) keeps blocks in
//     flight to overlap one block's epilogue with another's FFMAs; the
//     epilogue is a template parameter, so each kernel holds only its own;
//   - the block is 64 or 128 rows by 48-192 columns, chosen per product
//     (f32_plan_mn, f32_plan_tn, from timings of every shape at the port's
//     products):
//     the port's widths are multiples of 48, so columns pad little, and a
//     row tile's blocks are adjacent, so A comes from device memory once;
//   - the epilogues (bias, GELU, its derivative, the residual) work on the
//     registers and store 16 bytes a lane; the residual or pre-activation
//     tile they read is asked into L2 as the block starts;
//   - TN splits K into chunks that fill the SMs once and picks out or its
//     transpose as the block's orientation, whichever pads less; a second
//     pass folds the partials in one fixed order, so two calls give the
//     same bits.
// Shapes whose rows are not 16-byte aligned take 4-byte copies and scalar
// stores (a 64 x 48 block); every edge is masked.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "gemm_f32.cuh"

namespace {

using ssrl::F_BIAS;
using ssrl::F_BIAS_GELU;
using ssrl::F_BIAS_GELU_Z;
using ssrl::F_BIAS_RESID;
using ssrl::F_GELU_BWD;
using ssrl::F_NONE;

constexpr int F32_BK = 16;       // k values a stage
constexpr int F32_RAW = F32_BK + 4;  // a k-contiguous raw tile's row, padded
constexpr int F32_SMS = 132;     // the H100's SMs, for the tiling plans

__device__ __forceinline__ float gelu_erf(float z) {
  return 0.5f * z * (1.f + erff(z * kInvSqrt2));
}

// d gelu / dz = Phi(z) + z * phi(z), with the exact erf
__device__ __forceinline__ float gelu_erf_grad(float z) {
  return 0.5f * (1.f + erff(z * kInvSqrt2)) + z * expf(-0.5f * z * z) * kInvSqrt2Pi;
}

// The 128-byte lines of rows [r0, rlim) x columns [c0, c0 + COLS) of
// g[r][ld] into L2 (the epilogue's residual or pre-activation tile, asked
// for as the block starts, so the epilogue's loads find it there).
template <int ROWS, int COLS, int NTHR>
__device__ __forceinline__ void prefetch_l2(const float* g, int ld, int r0, int rlim, int c0,
                                            int tid) {
  constexpr int LINES = (COLS * 4 + 127) / 128 + 1;  // a row's span, however it is aligned
#pragma unroll
  for (int i = 0; i < (ROWS * LINES + NTHR - 1) / NTHR; ++i) {
    const int l = tid + i * NTHR, r = l / LINES;
    if (l < ROWS * LINES && r0 + r < rlim) {
      const uintptr_t row = reinterpret_cast<uintptr_t>(g + (size_t)(r0 + r) * ld + c0);
      const uintptr_t line = (row & ~(uintptr_t)127) + (uintptr_t)(l % LINES) * 128;
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(line));
    }
  }
}

// VEC floats from global to shared memory, or zeros where !ok
template <int VEC>
__device__ __forceinline__ void cp_async_f32(float* smem, const float* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(ok ? 4 : 0));
  }
}

// One operand's tile: ROWS rows (of m or n) by F32_BK values of k, from
// rows [r0, rlim) and k in [k0, klim), VEC floats a copy. KROW: g[r][k] (row
// length ld), copied as it lies into raw[r][F32_RAW]; else g[k][r], copied
// straight into the k-major s[k][ROWS].
template <bool KROW, int ROWS, int VEC, int NTHR>
__device__ __forceinline__ void load_tile(float* s, const float* g, int ld, int r0, int rlim,
                                          int k0, int klim, int tid) {
  constexpr int PER = (KROW ? F32_BK : ROWS) / VEC;  // copies a source row
  constexpr int COPIES = ROWS * F32_BK / VEC;
#pragma unroll
  for (int i = 0; i < (COPIES + NTHR - 1) / NTHR; ++i) {
    const int c = tid + i * NTHR;
    if (COPIES % NTHR == 0 || c < COPIES) {
      const int outer = c / PER, inner = (c % PER) * VEC;
      const int r = KROW ? outer : inner, k = KROW ? inner : outer;
      const int gr = r0 + r, gk = k0 + k;
      const bool ok = gr < rlim && gk < klim;
      const size_t off = KROW ? (size_t)gr * ld + gk : (size_t)gk * ld + gr;
      cp_async_f32<VEC>(s + (KROW ? r * F32_RAW + k : k * ROWS + r), ok ? g + off : g, ok);
    }
  }
}

// A k-contiguous tile raw[r][F32_RAW] into the k-major t[k][ROWS]: a float4
// of 4 k a lane, lanes on consecutive rows (the padded rows put 8 lanes'
// reads on distinct banks; each k row's writes are 32 consecutive floats).
template <int ROWS, int NTHR>
__device__ __forceinline__ void transpose_tile(float* t, const float* raw, int tid) {
  constexpr int QUADS = ROWS * F32_BK / 4;
#pragma unroll
  for (int i = 0; i < (QUADS + NTHR - 1) / NTHR; ++i) {
    const int c = tid + i * NTHR;
    if (QUADS % NTHR == 0 || c < QUADS) {
      const int r = c % ROWS, k = (c / ROWS) * 4;
      const float4 v = *reinterpret_cast<const float4*>(raw + r * F32_RAW + k);
      t[k * ROWS + r] = v.x;
      t[(k + 1) * ROWS + r] = v.y;
      t[(k + 2) * ROWS + r] = v.z;
      t[(k + 3) * ROWS + r] = v.w;
    }
  }
}

// A product's tiling: a block of 64 wm rows by 48 wn columns (wm warps by
// wn warps, each 64 x 48), and for TN whether A and B trade places (the
// block's rows are then out's columns) and the split of K into `splits`
// chunks of `chunk` rows (NT, NN: one split of all K).
struct F32Plan {
  int wm, wn, swap, splits, chunk;
};

struct F32Args {
  const float* A;
  const float* B;
  const float* bias;
  const float* R;
  float* C;  // TN: the partials, split z at C + z * M * N
  float* Z;
  int M, N, K;
  int k_chunk;  // k rows a split (K for NT and NN)
};

__host__ __device__ constexpr int f32_threads(int wm, int wn) { return 32 * wm * wn; }
// blocks an SM the register cap allows: 384 threads' worth (170 registers a
// thread), one block at 256 threads
__host__ __device__ constexpr int f32_min_blocks(int nthr) { return nthr >= 256 ? 1 : 384 / nthr; }

// Shared memory of one operand: a k-major operand keeps a ring of three
// tiles (t multiplied, t + 1 landed, t + 2 in flight); a k-contiguous one
// two raw tiles (t + 1 being transposed, t + 2 in flight) and two k-major
// ones (t, t + 1).
template <bool KROW, int ROWS>
__host__ __device__ constexpr int f32_operand_floats() {
  return KROW ? 2 * ROWS * F32_RAW + 2 * F32_BK * ROWS : 3 * F32_BK * ROWS;
}

template <bool AK, bool BK, int WM, int WN>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (f32_operand_floats<AK, 64 * WM>() + f32_operand_floats<BK, 48 * WN>());
}

// The k-major tile t of an operand in its shared region, and where tile t's
// copies land.
template <bool KROW, int ROWS>
__device__ __forceinline__ float* kmajor_tile(float* base, int t) {
  return KROW ? base + 2 * ROWS * F32_RAW + (t & 1) * F32_BK * ROWS
              : base + (t % 3) * F32_BK * ROWS;
}
template <bool KROW, int ROWS>
__device__ __forceinline__ float* landing_tile(float* base, int t) {
  return KROW ? base + (t & 1) * ROWS * F32_RAW : base + (t % 3) * F32_BK * ROWS;
}

// AK: A is k-contiguous (NT, NN), else k-major (TN); BK: B is k-contiguous
// (NT), else k-major (NN, TN). Grid: x = M tiles x N tiles (N fastest), z =
// the splits of K. Iteration t: a barrier (tile t + 1 has landed, tile t is
// k-major, every warp is done with tile t - 1), then tile t + 2's copies are
// issued, tile t + 1 is transposed where it came in k-contiguous, and tile
// t is multiplied.
template <bool AK, bool BK, int WM, int WN, int VEC, int EPI>
__global__ void __launch_bounds__(f32_threads(WM, WN), f32_min_blocks(f32_threads(WM, WN)))
    gemm_f32_kernel(const F32Args p) {
  constexpr int NTHR = f32_threads(WM, WN), BM = 64 * WM, BN = 48 * WN;
  extern __shared__ float4 f32_smem[];
  float* const sa = reinterpret_cast<float*>(f32_smem);
  float* const sb = sa + f32_operand_floats<AK, BM>();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mi = lane & 7, ni = lane >> 3;
  const int wm0 = (warp % WM) * 64, wn0 = (warp / WM) * 48;
  const int n_tiles = (p.N + BN - 1) / BN;
  const int m0 = (int)(blockIdx.x / n_tiles) * BM, n0 = (int)(blockIdx.x % n_tiles) * BN;
  const int kb = blockIdx.z * p.k_chunk;
  const int ke = min(p.K, kb + p.k_chunk);
  const int lda = AK ? p.K : p.M, ldb = BK ? p.K : p.N;
  const int nk = (ke - kb + F32_BK - 1) / F32_BK;

  auto load = [&](int t) {
    if (t < nk) {
      load_tile<AK, BM, VEC, NTHR>(landing_tile<AK, BM>(sa, t), p.A, lda, m0, p.M,
                                   kb + t * F32_BK, ke, tid);
      load_tile<BK, BN, VEC, NTHR>(landing_tile<BK, BN>(sb, t), p.B, ldb, n0, p.N,
                                   kb + t * F32_BK, ke, tid);
    }
    cp_async_commit();
  };
  auto transpose = [&](int t) {
    if (t < nk) {
      if constexpr (AK)
        transpose_tile<BM, NTHR>(kmajor_tile<AK, BM>(sa, t), landing_tile<AK, BM>(sa, t), tid);
      if constexpr (BK)
        transpose_tile<BN, NTHR>(kmajor_tile<BK, BN>(sb, t), landing_tile<BK, BN>(sb, t), tid);
    }
  };

  float acc[8][12];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j) acc[i][j] = 0.f;

  load(0);
  load(1);
  if constexpr (EPI == F_BIAS_RESID || EPI == F_GELU_BWD)
    prefetch_l2<BM, BN, NTHR>(p.R, p.N, m0, p.M, n0, tid);
  cp_async_wait<1>();
  __syncthreads();
  transpose(0);
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    load(t + 2);
    transpose(t + 1);
    const float* as = kmajor_tile<AK, BM>(sa, t);
    const float* bs = kmajor_tile<BK, BN>(sb, t);
#pragma unroll
    for (int k = 0; k < F32_BK; ++k) {
      // rows wm0 + 32g + 4mi + (0..3), columns wn0 + 16j + 4ni + (0..3)
      float a[8], b[12];
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(as + k * BM + wm0 + 32 * g + 4 * mi);
        a[4 * g] = v.x;
        a[4 * g + 1] = v.y;
        a[4 * g + 2] = v.z;
        a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(bs + k * BN + wn0 + 16 * j + 4 * ni);
        b[4 * j] = v.x;
        b[4 * j + 1] = v.y;
        b[4 * j + 2] = v.z;
        b[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 12; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  float* const C = p.C + (size_t)blockIdx.z * p.M * p.N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + wm0 + 32 * (i >> 2) + 4 * mi + (i & 3);
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int n = n0 + wn0 + 16 * j + 4 * ni;
      if (n >= p.N) continue;
      const size_t o = (size_t)m * p.N + n;
      float v[4], r[4] = {0.f, 0.f, 0.f, 0.f}, bb[4] = {0.f, 0.f, 0.f, 0.f};
      constexpr bool reads_r = EPI == F_GELU_BWD || EPI == F_BIAS_RESID;
      constexpr bool has_bias = EPI != F_NONE && EPI != F_GELU_BWD;
      if constexpr (VEC == 4) {
        if (reads_r) {
          const float4 t = *reinterpret_cast<const float4*>(p.R + o);
          r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
        }
        if (has_bias) {
          const float4 t = *reinterpret_cast<const float4*>(p.bias + n);
          bb[0] = t.x; bb[1] = t.y; bb[2] = t.z; bb[3] = t.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (n + c < p.N) {
            if (reads_r) r[c] = p.R[o + c];
            if (has_bias) bb[c] = p.bias[n + c];
          }
      }
      float z[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = acc[i][4 * j + c];
        if (EPI == F_GELU_BWD) x *= gelu_erf_grad(r[c]);
        if (has_bias) x += bb[c];
        z[c] = x;
        if (EPI == F_BIAS_GELU || EPI == F_BIAS_GELU_Z) x = gelu_erf(x);
        if (EPI == F_BIAS_RESID) x = r[c] + x;
        v[c] = x;
      }
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(C + o) = make_float4(v[0], v[1], v[2], v[3]);
        if (EPI == F_BIAS_GELU_Z)
          *reinterpret_cast<float4*>(p.Z + o) = make_float4(z[0], z[1], z[2], z[3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (n + c < p.N) {
            C[o + c] = v[c];
            if (EPI == F_BIAS_GELU_Z) p.Z[o + c] = z[c];
          }
      }
    }
  }
}

template <bool AK, bool BK, int WM, int WN, int VEC, int EPI>
cudaError_t launch_f32(const F32Args& p, int splits, cudaStream_t st) {
  constexpr size_t smem = f32_smem_bytes<AK, BK, WM, WN>();
  auto fn = gemm_f32_kernel<AK, BK, WM, WN, VEC, EPI>;
  SSRL_TRY(cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  const long long tiles = (long long)cdiv(p.M, 64 * WM) * cdiv(p.N, 48 * WN);
  fn<<<dim3((unsigned)tiles, 1, splits), f32_threads(WM, WN), smem, st>>>(p);
  return cudaGetLastError();
}

// The plan's (wm, wn) as a template instantiation: NT and NN take the two
// shapes of f32_plan_mn, TN every shape; rows not 16-byte aligned take the
// 64 x 48 block with 4-byte copies.
template <bool AK, bool BK, int EPI>
cudaError_t launch_plan(const F32Args& p, int wm, int wn, bool vec, int splits,
                        cudaStream_t st) {
  if (!vec) return launch_f32<AK, BK, 1, 1, 1, EPI>(p, splits, st);
  if constexpr (AK) {
    if (wm == 2 && wn == 3) return launch_f32<AK, BK, 2, 3, 4, EPI>(p, splits, st);
    if (wm == 2 && wn == 2) return launch_f32<AK, BK, 2, 2, 4, EPI>(p, splits, st);
    return cudaErrorInvalidValue;
  } else {
    switch (wm * 10 + wn) {
      case 11: return launch_f32<AK, BK, 1, 1, 4, EPI>(p, splits, st);
      case 12: return launch_f32<AK, BK, 1, 2, 4, EPI>(p, splits, st);
      case 13: return launch_f32<AK, BK, 1, 3, 4, EPI>(p, splits, st);
      case 14: return launch_f32<AK, BK, 1, 4, 4, EPI>(p, splits, st);
      case 21: return launch_f32<AK, BK, 2, 1, 4, EPI>(p, splits, st);
      case 22: return launch_f32<AK, BK, 2, 2, 4, EPI>(p, splits, st);
      case 23: return launch_f32<AK, BK, 2, 3, 4, EPI>(p, splits, st);
      case 24: return launch_f32<AK, BK, 2, 4, 4, EPI>(p, splits, st);
      default: return cudaErrorInvalidValue;
    }
  }
}

// NT and NN (measured on an H100 at the port's products, every block
// shape timed): blocks of 128 rows by 96 columns (three an SM), unless they
// would pad N by over 15% more than 128 x 144 blocks (two an SM) do, as at
// N = 144. K is never split.
F32Plan f32_plan_mn(int N, int K) {
  const bool wide = cdiv(N, 96) * 96 * 100 > cdiv(N, 144) * 144 * 115;
  return {2, wide ? 3 : 2, 0, 1, K};
}

// TN: the block shape and orientation that cost least, by padded outputs
// over each shape's measured relative rate (in thousandths of the 128 x
// 192 block's, H100: the rates of the other shapes fall with their warps
// and registers a block), then as many splits of K as fill the SMs once
// (one 128 x 192 block an SM, two of any other shape), each split >= 256
// rows; its partials cost ~40 FFMA slots an output element.
constexpr int F32_TN_RATE[2][4] = {{420, 720, 620, 880}, {650, 950, 900, 1000}};

F32Plan f32_plan_tn(int M, int N, int K) {
  F32Plan best{1, 1, 0, 1, K};
  double best_cost = -1;
  const int max_splits = cdiv(K, 256);
  for (int swap = 0; swap < 2; ++swap)
    for (int wm = 2; wm >= 1; --wm)
      for (int wn = 4; wn >= 1; --wn) {
        const int rows = swap ? N : M, cols = swap ? M : N;
        const long long tiles = (long long)cdiv(rows, 64 * wm) * cdiv(cols, 48 * wn);
        const long long target = wm * wn == 8 ? F32_SMS : 2 * F32_SMS;
        int s = (int)(target / tiles);
        s = s < 1 ? 1 : (s > max_splits ? max_splits : s);
        const int chunk = cdiv(cdiv(K, s), F32_BK) * F32_BK;
        const int splits = cdiv(K, chunk);
        const double waves = (double)((tiles * splits + target - 1) / target);
        const double cost = waves * (64.0 * wm * 48 * wn) * chunk * target / F32_SMS * 1000.0 /
                                F32_TN_RATE[wm - 1][wn - 1] +
                            40.0 * splits * M * N / F32_SMS;
        if (best_cost < 0 || cost < best_cost) {
          best = {wm, wn, swap, splits, chunk};
          best_cost = cost;
        }
      }
  return best;
}

// NT and NN: the plan's block over all K, with the epilogue EPI.
template <bool BK, int EPI>
cudaError_t gemm_f32_mn(const float* A, const float* B, const float* bias, const float* R,
                        float* C, float* Z, int M, int N, int K, cudaStream_t st) {
  constexpr bool needs_bias = EPI != F_NONE && EPI != F_GELU_BWD;
  if (M < 1 || N < 1 || K < 1 || (needs_bias && !bias) ||
      ((EPI == F_BIAS_RESID || EPI == F_GELU_BWD) && !R) || (EPI == F_BIAS_GELU_Z && !Z))
    return cudaErrorInvalidValue;
  const bool vec = K % 4 == 0 && N % 4 == 0 && aligned16(A) && aligned16(B) && aligned16(C) &&
                   aligned16(bias) && aligned16(R) && aligned16(Z);
  const F32Plan plan = f32_plan_mn(N, K);
  const F32Args p{A, B, bias, R, C, Z, M, N, K, K};
  return launch_plan<true, BK, EPI>(p, plan.wm, plan.wn, vec, 1, st);
}

}  // namespace
