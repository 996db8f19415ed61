// Shared device code for the transformer-branch kernels (sm_90a).
//
// One tiled bf16 GEMM (WMMA 16x16x16 fragments, f32 accumulation) with the
// epilogues the two branches need, a warp-per-row LayerNorm forward and
// backward, and a deterministic two-pass column reduction that turns
// per-block f32 partial sums into weight and bias gradients.
//
// Numerics follow the TPU kernels in ssrl_vit_mae_jepa_tpu/ops/block_pallas.py
// (:28-32, :501-533, :573-651): bf16 operands with f32 accumulation, LayerNorm
// statistics in f32 (two-pass, eps 1e-6), bias added in f32 before the single
// rounding to bf16, exact-erf GELU on the bf16-rounded pre-activation (or, for
// the whole-block kernel, on the f32 one: block_pallas.py:271).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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

__device__ __forceinline__ float gelu_f(float z) {
  return 0.5f * z * (1.f + erff(z * kInvSqrt2));
}

// d gelu / dz = Phi(z) + z * phi(z)
__device__ __forceinline__ float gelu_grad(float z) {
  const float cdf = 0.5f * (1.f + erff(z * kInvSqrt2));
  const float pdf = expf(-0.5f * z * z) * kInvSqrt2Pi;
  return cdf + z * pdf;
}

// ---------------------------------------------------------------------------
// Tiled GEMM: C[m][n] = sum_k A(m,k) * B(k,n), bf16 in, f32 accumulate.
//   A(m,k) = AT ? A[k*lda + m] : A[m*lda + k]
//   B(k,n) = BT ? B[n*ldb + k] : B[k*ldb + n]
// The three uses: NT (x @ W^T, W in torch's (out, in) layout), NN (dY @ W)
// and TN (dY^T @ X, the weight gradient, split over K = the B*L rows).
// Ragged edges (M = B*L, and K chunks of split-K) are zero-filled on load and
// masked on store.
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 32, GEMM_THREADS = 128;

enum Epi : int {
  EPI_F32 = 0,         // C f32 (split-K partials: + blockIdx.z * c_split)
  EPI_BF16 = 1,        // C = bf16(acc)
  EPI_BIAS_BF16 = 2,   // C = bf16(acc + bias)
  EPI_BIAS_RESID = 3,  // C = bf16(R + bf16(acc + bias))
  EPI_BIAS_GELU = 4,   // z = bf16(acc + bias); C = bf16(gelu(z)); Zout = z
  EPI_GELU_BWD = 5,    // dz = acc * gelu'(Zin); C = bf16(dz); colpart += dz
  EPI_BIAS_GELU32 = 6, // z = acc + bias in f32; C = bf16(gelu(z)); Zout32 = z
  EPI_GELU32_BWD = 7,  // EPI_GELU_BWD with the f32 pre-activation Zin32
};

struct GemmArgs {
  const bf16* A;
  const bf16* B;
  int lda, ldb;
  int M, N, K;
  int k_chunk;             // split-K chunk, a multiple of BK
  void* C;
  int ldc;
  long long c_split;       // element stride between split-K partials
  const bf16* bias;        // [N]
  const bf16* R;           // residual, [M][ldc]
  const bf16* Zin;         // gelu pre-activation, [M][ldc]
  bf16* Zout;              // gelu pre-activation out, [M][ldc] (may be null)
  const float* Zin32;      // f32 forms of Zin and Zout (EPI_*GELU32*)
  float* Zout32;
  float* colpart;          // [gridDim.y][N] column sums of dz
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// rows x cols tile (cols a multiple of 8) from a row-major matrix with leading
// dimension gld, element (r0 + r, c0 + c), zero outside [0,rmax) x [0,cmax).
// Aligned in-bounds 16-byte chunks go by cp.async (complete after the next
// cp_async_wait_one + __syncthreads); ragged or unaligned ones are stored
// directly.
__device__ __forceinline__ void load_tile(bf16* s, int sld, const bf16* g,
                                          int gld, int rows, int cols, int r0,
                                          int c0, int rmax, int cmax) {
  const int cpr = cols / 8;
  const int total = rows * cpr;
  const bool vec_ok =
      ((gld & 7) == 0) && ((reinterpret_cast<uintptr_t>(g) & 15) == 0);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / cpr;
    const int c = (i - r * cpr) * 8;
    const int gr = r0 + r, gc = c0 + c;
    union {
      uint4 u;
      bf16 h[8];
    } v;
    if (gr < rmax && vec_ok && gc + 8 <= cmax) {
      cp_async16(s + r * sld + c, g + (size_t)gr * gld + gc);
      continue;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v.h[e] = (gr < rmax && gc + e < cmax) ? g[(size_t)gr * gld + gc + e]
                                            : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(s + r * sld + c) = v.u;
  }
}

template <bool AT, bool BT, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs p) {
  using namespace nvcuda;
  constexpr int A_LD = AT ? BM + 8 : BK + 8;
  constexpr int B_LD = BT ? BK + 8 : BN + 8;
  constexpr int C_LD = BN + 4;
  // two stages of A and B tiles: the next K step loads while this one computes
  __shared__ __align__(128) bf16 As[2][AT ? BK * (BM + 8) : BM * (BK + 8)];
  __shared__ __align__(128) bf16 Bs[2][BT ? BN * (BK + 8) : BK * (BN + 8)];
  __shared__ __align__(128) float Cs[BM * C_LD];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * p.k_chunk;
  const int ke = min(p.K, kb + p.k_chunk);
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps, 32 x 32 each

  using LayoutA = typename std::conditional<AT, wmma::col_major, wmma::row_major>::type;
  using LayoutB = typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  auto load_stage = [&](int buf, int k0) {
    if (!AT) load_tile(As[buf], A_LD, p.A, p.lda, BM, BK, m0, k0, p.M, ke);
    else     load_tile(As[buf], A_LD, p.A, p.lda, BK, BM, k0, m0, ke, p.M);
    if (!BT) load_tile(Bs[buf], B_LD, p.B, p.ldb, BK, BN, k0, n0, ke, p.N);
    else     load_tile(Bs[buf], B_LD, p.B, p.ldb, BN, BK, n0, k0, p.N, ke);
  };
  if (kb < ke) load_stage(0, kb);
  cp_async_commit();
  int buf = 0;
  for (int k0 = kb; k0 < ke; k0 += BK, buf ^= 1) {
    if (k0 + BK < ke) load_stage(buf ^ 1, k0 + BK);
    cp_async_commit();
    cp_async_wait_one();  // this step's tiles have landed
    __syncthreads();
    const bf16* Ab = As[buf];
    const bf16* Bb = Bs[buf];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int mo = wm * 32 + i * 16;
        const bf16* pa = AT ? Ab + kk * A_LD + mo : Ab + mo * A_LD + kk;
        wmma::load_matrix_sync(fa[i], pa, A_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int no = wn * 32 + j * 16;
        const bf16* pb = BT ? Bb + no * B_LD + kk : Bb + kk * B_LD + no;
        wmma::load_matrix_sync(fb[j], pb, B_LD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * BN; idx += GEMM_THREADS) {
    const int r = idx / BN, c = idx - (idx / BN) * BN;
    const int m = m0 + r, n = n0 + c;
    const bool in = (m < p.M) && (n < p.N);
    const float v = Cs[r * C_LD + c];
    const size_t o = (size_t)m * p.ldc + n;
    if (EPI == EPI_GELU_BWD || EPI == EPI_GELU32_BWD) {
      float dz = 0.f;
      if (in) {
        dz = v * gelu_grad(EPI == EPI_GELU_BWD ? bf(p.Zin[o]) : p.Zin32[o]);
        static_cast<bf16*>(p.C)[o] = tobf(dz);
      }
      Cs[r * C_LD + c] = dz;  // own element only; summed per column below
      continue;
    }
    if (!in) continue;
    if (EPI == EPI_F32) {
      static_cast<float*>(p.C)[(size_t)blockIdx.z * p.c_split + o] = v;
    } else if (EPI == EPI_BF16) {
      static_cast<bf16*>(p.C)[o] = tobf(v);
    } else if (EPI == EPI_BIAS_BF16) {
      static_cast<bf16*>(p.C)[o] = tobf(v + bf(p.bias[n]));
    } else if (EPI == EPI_BIAS_RESID) {
      static_cast<bf16*>(p.C)[o] = tobf(bf(p.R[o]) + rbf(v + bf(p.bias[n])));
    } else if (EPI == EPI_BIAS_GELU) {
      const bf16 z = tobf(v + bf(p.bias[n]));
      if (p.Zout) p.Zout[o] = z;
      static_cast<bf16*>(p.C)[o] = tobf(gelu_f(bf(z)));
    } else if (EPI == EPI_BIAS_GELU32) {
      const float z = v + bf(p.bias[n]);
      if (p.Zout32) p.Zout32[o] = z;
      static_cast<bf16*>(p.C)[o] = tobf(gelu_f(z));
    }
  }
  if (EPI == EPI_GELU_BWD || EPI == EPI_GELU32_BWD) {
    __syncthreads();
    for (int c = threadIdx.x; c < BN; c += GEMM_THREADS) {
      const int n = n0 + c;
      if (n >= p.N) continue;
      float s = 0.f;
      for (int r = 0; r < BM; ++r) s += Cs[r * C_LD + c];
      p.colpart[(size_t)blockIdx.y * p.N + n] = s;
    }
  }
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// Split-K factor for a weight-gradient GEMM: enough blocks to fill the card
// (~8 per SM) while each split still covers >= 256 rows of the reduction.
inline int splitk_chunk(int tiles_mn, int K, int* splits) {
  int s = cdiv(1056, tiles_mn);
  s = s < cdiv(K, 256) ? s : cdiv(K, 256);
  if (s < 1) s = 1;
  if (s > 64) s = 64;
  int chunk = cdiv(K, s);
  chunk = cdiv(chunk, BK) * BK;
  *splits = cdiv(K, chunk);
  return chunk;
}

template <bool AT, bool BT, int EPI>
void launch_gemm(GemmArgs p, int splits, cudaStream_t st) {
  if (splits <= 1) {
    splits = 1;
    p.k_chunk = cdiv(p.K, BK) * BK;
  }
  dim3 grid(cdiv(p.N, BN), cdiv(p.M, BM), splits);
  gemm_kernel<AT, BT, EPI><<<grid, GEMM_THREADS, 0, st>>>(p);
}

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
