// f32 forward of the two residual branches of a pre-LN transformer block on
// Hopper (sm_90a), for the callers that run a model in f32 without a gradient
// (the feature, k-NN and reconstruction entry points):
//   attn: out = x + (MHA(LN1(x) @ Wqkv^T + bqkv) @ Wp^T + bp)
//   mlp:  out = x + (gelu(LN2(x) @ W1^T + b1) @ W2^T + b2)
//
// Replaces the f32 instantiation of the TPU kernels of
// ssrl_vit_mae_jepa_tpu/ops/block_pallas.py: _ab_fwd_only (:692, the
// stash-free attention-branch forward, body _attn_branch_fwd_only_kernel) and
// _mb_fwd (:807, body _mlp_branch_fwd_kernel). The bf16 kernels of the same
// functions are attn_branch.cu and mlp_branch.cu.
//
// Numerics contract (block_pallas.py:28-32 at f32): f32 operands, f32
// accumulation, no TF32 and no rounding point anywhere; LayerNorm statistics
// two-pass with eps 1e-6; q scaled by d^-1/2 before the scores; softmax in
// f32 (max-subtracted, expf); exact erf GELU (erff). The plain versions are
// ops/block_fused.py::attn_branch_ref and mlp_branch_ref at f32.
//
// What bounds it on the H100: the f32 products run on the CUDA cores (67
// TFLOP/s, no tensor-core path without TF32). At B=256, L=145, D=144 a block
// does ~20 GFLOP against ~0.2 GB of f32 activations, so it is bound by
// operations (~0.3 ms a block at peak).
//
// What this design does about it: little, on purpose -- it is the first,
// simple version. A warp-per-row LayerNorm pass; a 64x64x16 shared-memory
// SIMT GEMM (256 threads, 4x4 outputs each, float4 reads from shared memory)
// whose epilogue adds the bias and applies the GELU or the residual from
// registers; and an attention core with one block per (image, head, 32 query
// rows) that keeps K, V, the scaled Q rows and their f32 scores (32 x L) in
// shared memory. Intermediates (y, qkv, a, h) go through device memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-6f;
constexpr float kInvSqrt2 = 0.7071067811865476f;

enum Epi { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RESID = 2 };

inline int cdiv_i(long long a, long long b) { return (int)((a + b - 1) / b); }
inline size_t align256(size_t b) { return (b + 255) & ~(size_t)255; }

__device__ __forceinline__ float wsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float wmax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// LayerNorm, one warp per row, any D
// ---------------------------------------------------------------------------

constexpr int LN_WARPS = 8;

__global__ void ln_f32_kernel(const float* __restrict__ x, const float* __restrict__ s,
                              const float* __restrict__ b, float* __restrict__ y, int M,
                              int D) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (row >= M) return;
  const float* xr = x + (size_t)row * D;
  float t = 0.f;
  for (int c = lane; c < D; c += 32) t += xr[c];
  const float mu = wsum(t) / (float)D;
  float q = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = xr[c] - mu;
    q += d * d;
  }
  const float inv = 1.f / sqrtf(wsum(q) / (float)D + kEps);
  float* yr = y + (size_t)row * D;
  for (int c = lane; c < D; c += 32) yr[c] = (xr[c] - mu) * inv * s[c] + b[c];
}

// ---------------------------------------------------------------------------
// C[M][N] = epi(A[M][K] @ W[N][K]^T + bias[N]) (W in torch Linear layout)
// ---------------------------------------------------------------------------

constexpr int GBM = 64, GBN = 64, GBK = 16, GTHREADS = 256;

template <int EPI>
__global__ void __launch_bounds__(GTHREADS)
    gemm_nt_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                       const float* __restrict__ bias, const float* __restrict__ R,
                       float* __restrict__ C, int M, int N, int K) {
  // +4 keeps each row 16-byte aligned for the float4 reads
  __shared__ __align__(16) float As[GBK][GBM + 4];
  __shared__ __align__(16) float Ws[GBK][GBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GBK) {
#pragma unroll
    for (int i = 0; i < (GBM * GBK) / GTHREADS; ++i) {
      const int idx = tid + GTHREADS * i;
      const int r = idx / GBK, kk = idx % GBK;
      const int gk = k0 + kk;
      const int gm = m0 + r, gn = n0 + r;
      As[kk][r] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
      Ws[kk][r] = (gn < N && gk < K) ? W[(size_t)gn * K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float v = acc[i][j] + bias[n];
      if (EPI == EPI_BIAS_GELU) v = 0.5f * v * (1.f + erff(v * kInvSqrt2));
      if (EPI == EPI_BIAS_RESID) v = R[(size_t)m * N + n] + v;
      C[(size_t)m * N + n] = v;
    }
  }
}

template <int EPI>
cudaError_t gemm_nt_f32(const float* A, const float* W, const float* bias, const float* R,
                        float* C, int M, int N, int K, cudaStream_t st) {
  const dim3 grid(cdiv_i(N, GBN), cdiv_i(M, GBM));
  gemm_nt_f32_kernel<EPI><<<grid, GTHREADS, 0, st>>>(A, W, bias, R, C, M, N, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Attention core: a[b, l, h*d + c] = softmax(q k^T * scale) v, from the
// (B*L, 3D) qkv rows (q | k | v, head h at columns h*d of each)
// ---------------------------------------------------------------------------

constexpr int ATT_QR = 32;  // query rows a block
constexpr int ATT_THREADS = 256;
constexpr size_t kMaxShared = 232448;  // the H100's 227 KB a block

size_t attn_shared_bytes(int L, int d) {
  const size_t dp = d + 1, lp = L + 1;
  return sizeof(float) * ((size_t)L * dp + (size_t)L * d + ATT_QR * dp + ATT_QR * lp);
}

__global__ void __launch_bounds__(ATT_THREADS)
    attn_f32_kernel(const float* __restrict__ qkv, float* __restrict__ a, int L, int D,
                    int H, float scale) {
  extern __shared__ float sm[];
  const int d = D / H, dp = d + 1, lp = L + 1;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int r0 = blockIdx.y * ATT_QR;
  const int nr = min(ATT_QR, L - r0);
  float* Ks = sm;                  // [L][d + 1]: conflict-free column walks
  float* Vs = Ks + (size_t)L * dp;  // [L][d]
  float* Qs = Vs + (size_t)L * d;   // [ATT_QR][d + 1]
  float* Ss = Qs + ATT_QR * dp;     // [ATT_QR][L + 1]
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t ld = 3 * (size_t)D;
  const float* base = qkv + (size_t)b * L * ld;

  for (int i = tid; i < L * d; i += nt) {
    const int j = i / d, c = i - j * d;
    Ks[j * dp + c] = base[j * ld + D + h * d + c];
    Vs[j * d + c] = base[j * ld + 2 * D + h * d + c];
  }
  for (int i = tid; i < nr * d; i += nt) {
    const int r = i / d, c = i - r * d;
    Qs[r * dp + c] = base[(r0 + r) * ld + h * d + c] * scale;
  }
  __syncthreads();

  for (int i = tid; i < nr * L; i += nt) {
    const int r = i / L, j = i - r * L;
    float s = 0.f;
    for (int c = 0; c < d; ++c) s = fmaf(Qs[r * dp + c], Ks[j * dp + c], s);
    Ss[r * lp + j] = s;
  }
  __syncthreads();

  const int lane = tid & 31;
  for (int r = tid >> 5; r < nr; r += nt >> 5) {
    float* sr = Ss + r * lp;
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, sr[j]);
    m = wmax(m);
    float t = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(sr[j] - m);
      sr[j] = e;
      t += e;
    }
    const float sum = wsum(t);
    for (int j = lane; j < L; j += 32) sr[j] = sr[j] / sum;
  }
  __syncthreads();

  for (int i = tid; i < nr * d; i += nt) {
    const int r = i / d, c = i - r * d;
    const float* pr = Ss + r * lp;
    float o = 0.f;
    for (int j = 0; j < L; ++j) o = fmaf(pr[j], Vs[j * d + c], o);
    a[((size_t)b * L + r0 + r) * D + h * d + c] = o;
  }
}

struct AttnWs {
  float *y1, *qkv, *a;
};

size_t attn_carve(char* p, int B, int L, int D, AttnWs* w) {
  const size_t M = (size_t)B * L;
  size_t off = 0;
  auto take = [&](size_t n) {
    float* r = p ? reinterpret_cast<float*>(p + off) : nullptr;
    off += align256(n * sizeof(float));
    return r;
  };
  w->y1 = take(M * D);
  w->qkv = take(M * 3 * D);
  w->a = take(M * D);
  return off;
}

size_t mlp_carve(char* p, int M, int D, int F, float** y2, float** h) {
  size_t off = 0;
  auto take = [&](size_t n) {
    float* r = p ? reinterpret_cast<float*>(p + off) : nullptr;
    off += align256(n * sizeof(float));
    return r;
  };
  *y2 = take((size_t)M * D);
  *h = take((size_t)M * F);
  return off;
}

}  // namespace

extern "C" {

// whether the attention core takes (L, d): K, V, 32 query rows and their
// scores in one block's shared memory
int ssrl_attn_f32_fits(int L, int d) {
  return L >= 1 && d >= 1 && attn_shared_bytes(L, d) <= kMaxShared;
}

long long ssrl_attn_branch_fwd_f32_workspace(int B, int L, int D) {
  AttnWs w;
  return (long long)attn_carve(nullptr, B, L, D, &w);
}

// x, out: [B][L][D] f32; ln_s, ln_b: [D]; wqkv: [3D][D], bqkv: [3D], wp:
// [D][D], bp: [D], all f32 (torch Linear layout).
int ssrl_attn_branch_fwd_f32(const void* x, const void* ln_s, const void* ln_b,
                             const void* wqkv, const void* bqkv, const void* wp,
                             const void* bp, void* out, void* ws, int B, int L, int D,
                             int H, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H < 1 || D % H || !ssrl_attn_f32_fits(L, D / H)) return (int)cudaErrorInvalidValue;
  AttnWs w;
  attn_carve(static_cast<char*>(ws), B, L, D, &w);
  const int M = B * L;
  const float* xf = static_cast<const float*>(x);
  ln_f32_kernel<<<cdiv_i(M, LN_WARPS), 32 * LN_WARPS, 0, st>>>(
      xf, static_cast<const float*>(ln_s), static_cast<const float*>(ln_b), w.y1, M, D);
  cudaError_t e = gemm_nt_f32<EPI_BIAS>(w.y1, static_cast<const float*>(wqkv),
                                        static_cast<const float*>(bqkv), nullptr, w.qkv, M,
                                        3 * D, D, st);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = attn_shared_bytes(L, D / H);
  e = cudaFuncSetAttribute(attn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  attn_f32_kernel<<<dim3(B * H, cdiv_i(L, ATT_QR)), ATT_THREADS, smem, st>>>(w.qkv, w.a, L,
                                                                            D, H, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)gemm_nt_f32<EPI_BIAS_RESID>(w.a, static_cast<const float*>(wp),
                                          static_cast<const float*>(bp), xf,
                                          static_cast<float*>(out), M, D, D, st);
}

long long ssrl_mlp_branch_fwd_f32_workspace(int M, int D, int F) {
  float *y2, *h;
  return (long long)mlp_carve(nullptr, M, D, F, &y2, &h);
}

// x, out: [M][D] f32; ln_s, ln_b: [D]; w1: [F][D], b1: [F], w2: [D][F], b2:
// [D], all f32 (torch Linear layout).
int ssrl_mlp_branch_fwd_f32(const void* x, const void* ln_s, const void* ln_b,
                            const void* w1, const void* b1, const void* w2, const void* b2,
                            void* out, void* ws, int M, int D, int F, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *y2, *h;
  mlp_carve(static_cast<char*>(ws), M, D, F, &y2, &h);
  const float* xf = static_cast<const float*>(x);
  ln_f32_kernel<<<cdiv_i(M, LN_WARPS), 32 * LN_WARPS, 0, st>>>(
      xf, static_cast<const float*>(ln_s), static_cast<const float*>(ln_b), y2, M, D);
  cudaError_t e = gemm_nt_f32<EPI_BIAS_GELU>(y2, static_cast<const float*>(w1),
                                             static_cast<const float*>(b1), nullptr, h, M, F,
                                             D, st);
  if (e != cudaSuccess) return (int)e;
  return (int)gemm_nt_f32<EPI_BIAS_RESID>(h, static_cast<const float*>(w2),
                                          static_cast<const float*>(b2), xf,
                                          static_cast<float*>(out), M, D, F, st);
}

}  // extern "C"
