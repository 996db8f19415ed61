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
// f32 operands and accumulation, no TF32; pre-scaled: q * scale in f32,
// then QK^T; post-scaled: QK^T, then * scale; softmax in f32 with the row
// max subtracted (expf, division by the row sum); dS = P o (dP -
// rowsum(dP o P)); dq = (dS K) * scale; dk = dS^T q_s (pre) or (dS^T q) *
// scale (post); dv = P^T dO. The plain versions are ops/attention_core.py::
// plain_fwd / plain_bwd_f32 at f32.
//
// What bounds it on the H100: the products run on the CUDA cores (67
// TFLOP/s without TF32). A head does 4 L^2 d operations forward and 10 L^2
// d backward against 16 L d bytes (forward) and 28 L d (backward) of f32
// q, k, v, o (dO, dq, dk, dv): ~9 operations a byte forward at L = 145,
// below the card's f32 ridge of 67e12 / 3.35e12 = 20, so the floor is the
// bytes, and what keeps a kernel from it is latency, as in mha.cu.
//
// What this design does about it: little, on purpose -- it is the first,
// simple version, right before fast. Forward: one block per (image, head,
// 32 query rows) keeps K, V, the scaled Q rows and their f32 scores (32 x L)
// in shared memory. Backward: one block per (image, head) keeps K, V and
// the dK, dV accumulators (L x d each) in shared memory and walks the
// queries in strips of 16 rows: S and dP for the strip, P and dS in place,
// dq written at once, dK += dS^T q and dV += P^T dO; dK and dV written at
// the end. Every sum has one fixed order and nothing is atomic, so two
// calls give the same bits (and a CUDA-graph replay the eager step's).
// Shared memory rows are padded to d + 1 and L + 1 floats, so that a warp
// walking rows or columns meets no bank conflict.
#include <math.h>

#include "common.cuh"
#include "mha.cuh"

namespace {

using Args = ssrl::MhaArgsT<float>;

constexpr int FQR = 32;   // query rows of a forward block
constexpr int BQR = 16;   // query rows of a backward strip
constexpr int THREADS = 256;
constexpr size_t kMaxShared = 232448;  // the H100's 227 KB a block

size_t fwd_smem(int L, int d) {
  const size_t dp = d + 1, lp = L + 1;
  return sizeof(float) * ((size_t)L * dp + (size_t)L * d + FQR * dp + FQR * lp);
}

size_t bwd_smem(int L, int d) {
  const size_t dp = d + 1, lp = L + 1;
  return sizeof(float) * (4 * (size_t)L * dp + 2 * BQR * dp + 2 * BQR * lp);
}

// Row r of a strip: softmax of the f32 scores in place, warp-wide (the row
// max subtracted, divided by the row sum).
__device__ __forceinline__ void softmax_row(float* sr, int L, int lane) {
  float m = -INFINITY;
  for (int j = lane; j < L; j += 32) m = fmaxf(m, sr[j]);
  m = warp_max(m);
  float t = 0.f;
  for (int j = lane; j < L; j += 32) {
    const float e = expf(sr[j] - m);
    sr[j] = e;
    t += e;
  }
  const float sum = warp_sum(t);
  for (int j = lane; j < L; j += 32) sr[j] = sr[j] / sum;
}

__global__ void __launch_bounds__(THREADS) mha_f32_fwd_kernel(const Args a) {
  extern __shared__ float sm[];
  const int L = a.L, d = a.d, dp = d + 1, lp = L + 1;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int r0 = blockIdx.y * FQR;
  const int nr = min(FQR, L - r0);
  float* Ks = sm;                   // [L][d + 1]
  float* Vs = Ks + (size_t)L * dp;  // [L][d]
  float* Qs = Vs + (size_t)L * d;   // [FQR][d + 1]
  float* Ss = Qs + FQR * dp;        // [FQR][L + 1]
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t ib = (size_t)b * a.in_b + (size_t)h * a.in_h;
  const float *q = a.q + ib, *k = a.k + ib, *v = a.v + ib;
  const float qscale = a.post ? 1.f : a.scale;
  const float sscale = a.post ? a.scale : 1.f;

  for (int i = tid; i < L * d; i += nt) {
    const int j = i / d, c = i - j * d;
    Ks[j * dp + c] = k[(size_t)j * a.in_r + c];
    Vs[j * d + c] = v[(size_t)j * a.in_r + c];
  }
  for (int i = tid; i < nr * d; i += nt) {
    const int r = i / d, c = i - r * d;
    Qs[r * dp + c] = q[(size_t)(r0 + r) * a.in_r + c] * qscale;
  }
  __syncthreads();

  for (int i = tid; i < nr * L; i += nt) {
    const int r = i / L, j = i - r * L;
    float s = 0.f;
    for (int c = 0; c < d; ++c) s = fmaf(Qs[r * dp + c], Ks[j * dp + c], s);
    Ss[r * lp + j] = s * sscale;
  }
  __syncthreads();

  const int lane = tid & 31;
  for (int r = tid >> 5; r < nr; r += nt >> 5) softmax_row(Ss + r * lp, L, lane);
  __syncthreads();

  float* o = a.o + (size_t)b * a.out_b + (size_t)h * a.out_h;
  for (int i = tid; i < nr * d; i += nt) {
    const int r = i / d, c = i - r * d;
    const float* pr = Ss + r * lp;
    float acc = 0.f;
    for (int j = 0; j < L; ++j) acc = fmaf(pr[j], Vs[j * d + c], acc);
    o[(size_t)(r0 + r) * a.out_r + c] = acc;
  }
}

__global__ void __launch_bounds__(THREADS) mha_f32_bwd_kernel(const Args a) {
  extern __shared__ float sm[];
  const int L = a.L, d = a.d, dp = d + 1, lp = L + 1;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  float* Ks = sm;                    // [L][d + 1]
  float* Vs = Ks + (size_t)L * dp;   // [L][d + 1]
  float* dKs = Vs + (size_t)L * dp;  // [L][d + 1], f32 accumulators
  float* dVs = dKs + (size_t)L * dp; // [L][d + 1]
  float* Qs = dVs + (size_t)L * dp;  // [BQR][d + 1]: q_s (pre) or q (post)
  float* dOs = Qs + BQR * dp;        // [BQR][d + 1]
  float* Ps = dOs + BQR * dp;        // [BQR][L + 1]: S, then P
  float* dSs = Ps + BQR * lp;        // [BQR][L + 1]: dP, then dS
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const size_t ib = (size_t)b * a.in_b + (size_t)h * a.in_h;
  const size_t ob = (size_t)b * a.out_b + (size_t)h * a.out_h;
  const float *q = a.q + ib, *k = a.k + ib, *v = a.v + ib, *dO = a.dO + ob;
  const float qscale = a.post ? 1.f : a.scale;
  const float sscale = a.post ? a.scale : 1.f;

  for (int i = tid; i < L * d; i += nt) {
    const int j = i / d, c = i - j * d;
    Ks[j * dp + c] = k[(size_t)j * a.in_r + c];
    Vs[j * dp + c] = v[(size_t)j * a.in_r + c];
    dKs[j * dp + c] = 0.f;
    dVs[j * dp + c] = 0.f;
  }

  for (int r0 = 0; r0 < L; r0 += BQR) {
    const int nr = min(BQR, L - r0);
    __syncthreads();  // the previous strip's readers of Qs, dOs, Ps, dSs are done
    for (int i = tid; i < nr * d; i += nt) {
      const int r = i / d, c = i - r * d;
      Qs[r * dp + c] = q[(size_t)(r0 + r) * a.in_r + c] * qscale;
      dOs[r * dp + c] = dO[(size_t)(r0 + r) * a.out_r + c];
    }
    __syncthreads();

    // S = q_s K^T (scaled after, if post) and dP = dO V^T
    for (int i = tid; i < nr * L; i += nt) {
      const int r = i / L, j = i - r * L;
      float s = 0.f, g = 0.f;
      for (int c = 0; c < d; ++c) {
        s = fmaf(Qs[r * dp + c], Ks[j * dp + c], s);
        g = fmaf(dOs[r * dp + c], Vs[j * dp + c], g);
      }
      Ps[r * lp + j] = s * sscale;
      dSs[r * lp + j] = g;
    }
    __syncthreads();

    // P, then dS = P o (dP - rowsum(dP o P)), a warp per row
    for (int r = tid >> 5; r < nr; r += nt >> 5) {
      float* pr = Ps + r * lp;
      float* gr = dSs + r * lp;
      softmax_row(pr, L, lane);
      float t = 0.f;
      for (int j = lane; j < L; j += 32) t = fmaf(gr[j], pr[j], t);
      const float di = warp_sum(t);
      for (int j = lane; j < L; j += 32) gr[j] = pr[j] * (gr[j] - di);
    }
    __syncthreads();

    // dq = (dS K) * scale, written once
    float* dq = a.dq + ib;
    for (int i = tid; i < nr * d; i += nt) {
      const int r = i / d, c = i - r * d;
      const float* gr = dSs + r * lp;
      float acc = 0.f;
      for (int j = 0; j < L; ++j) acc = fmaf(gr[j], Ks[j * dp + c], acc);
      dq[(size_t)(r0 + r) * a.in_r + c] = acc * a.scale;
    }
    // dK += dS^T q_s, dV += P^T dO, each element by one thread, rows in order
    for (int i = tid; i < L * d; i += nt) {
      const int j = i / d, c = i - j * d;
      float gk = dKs[j * dp + c], gv = dVs[j * dp + c];
      for (int r = 0; r < nr; ++r) {
        gk = fmaf(dSs[r * lp + j], Qs[r * dp + c], gk);
        gv = fmaf(Ps[r * lp + j], dOs[r * dp + c], gv);
      }
      dKs[j * dp + c] = gk;
      dVs[j * dp + c] = gv;
    }
  }
  __syncthreads();

  float *dk = a.dk + ib, *dv = a.dv + ib;
  for (int i = tid; i < L * d; i += nt) {
    const int j = i / d, c = i - j * d;
    dk[(size_t)j * a.in_r + c] = dKs[j * dp + c] * sscale;
    dv[(size_t)j * a.in_r + c] = dVs[j * dp + c];
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool args_ok(const Args& a, bool bwd) {
  return a.B >= 1 && a.H >= 1 && ssrl::mha_f32_fits(a.L, a.d, bwd);
}

}  // namespace

namespace ssrl {

bool mha_f32_fits(int L, int d, bool bwd) {
  if (L < 1 || d < 1) return false;
  return fwd_smem(L, d) <= kMaxShared && (!bwd || bwd_smem(L, d) <= kMaxShared);
}

cudaError_t mha_f32_fwd(const Args& a, cudaStream_t st) {
  if (!args_ok(a, false)) return cudaErrorInvalidValue;
  const size_t smem = fwd_smem(a.L, a.d);
  cudaError_t e = allow_smem(mha_f32_fwd_kernel, smem);
  if (e != cudaSuccess) return e;
  mha_f32_fwd_kernel<<<dim3(a.B * a.H, (a.L + FQR - 1) / FQR), THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t mha_f32_bwd(const Args& a, cudaStream_t st) {
  if (!args_ok(a, true)) return cudaErrorInvalidValue;
  const size_t smem = bwd_smem(a.L, a.d);
  cudaError_t e = allow_smem(mha_f32_bwd_kernel, smem);
  if (e != cudaSuccess) return e;
  mha_f32_bwd_kernel<<<a.B * a.H, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace ssrl

extern "C" {

// Whether the f32 core takes (L, d): its forward (bwd = 0), or its forward
// and backward (bwd = 1), in one block's shared memory.
int ssrl_attn_f32_fits(int L, int d, int bwd) {
  return ssrl::mha_f32_fits(L, d, bwd != 0) ? 1 : 0;
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
