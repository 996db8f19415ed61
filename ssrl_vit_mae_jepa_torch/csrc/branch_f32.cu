// f32 forward and backward of the two residual branches of a pre-LN
// transformer block on Hopper (sm_90a), for a model that runs in f32:
//   attn: out = x + (MHA(LN1(x) @ Wqkv^T + bqkv) @ Wp^T + bp)
//   mlp:  out = x + (gelu(LN2(x) @ W1^T + b1) @ W2^T + b2)
//
// Replaces the f32 instantiation of the TPU kernels of
// ssrl_vit_mae_jepa_tpu/ops/block_pallas.py: _ab_fwd (:722, the attention
// branch's training forward, which stashes the attention output `a`),
// _ab_fwd_only (:692, the same without the stash), _ab_bwd (:752, body
// _attn_branch_bwd_kernel :573-614), _mb_fwd (:807) and _mb_bwd (:831, body
// _mlp_branch_bwd_kernel :622-651). The bf16 kernels of the same functions
// are attn_branch.cu and mlp_branch.cu; the attention core is mha_f32.cu.
//
// Numerics contract (block_pallas.py:28-32 at f32, where every cast is a
// no-op): f32 operands, f32 accumulation, no TF32 and no rounding point
// anywhere; LayerNorm statistics two-pass with eps 1e-6; q scaled by d^-1/2
// before the scores; softmax in f32 (max-subtracted, expf); exact erf GELU
// (erff; the TPU kernels use a rational erf within 1.5e-7 of it). The plain
// versions are ops/block_fused.py::attn_branch_ref / mlp_branch_ref (forward)
// and attn_bwd_plain / mlp_bwd_plain (backward) at f32.
//
// Backward sequences (the TPU bodies', recomputing from x as they do):
//   attn: y1 = LN1(x); qkv = y1 Wqkv^T + bqkv; dWp = gy^T a; da = gy Wp;
//         (dq, dk, dv) = the attention backward of (qkv, da) into dqkv;
//         dWqkv = dqkv^T y1; dbqkv = colsum(dqkv); dy1 = dqkv Wqkv;
//         dx = gy + LN1'(dy1); d ln1 and dbp = colsum(gy) from the LN
//         backward's partials.
//   mlp:  y2 = LN2(x); z = y2 W1^T + b1, h = gelu(z); dW2 = gy^T h;
//         dz = (gy W2) o gelu'(z); dW1 = dz^T y2; db1 = colsum(dz);
//         dy2 = dz W1; dx = gy + LN2'(dy2); d ln2 and db2 as above.
// The kept variants (attn_f32_bwd_kept, mlp_f32_bwd_kept) take y1 and qkv,
// or y2, z and h, from a forward that kept them, and start after them.
// Weight gradients are TN products split over the B*L rows into f32
// partials, then folded in one fixed order (gemm_f32_tn.cu); bias sums go
// through common.cuh::reduce_rows or the LN backward's own fold; no atomic
// adds a sum, so two calls give the same bits and a CUDA-graph replay
// equals the eager step.
//
// What bounds it on the H100: the f32 products run on the CUDA cores (67
// TFLOP/s, no tensor-core path without TF32). At B=768, L=145, D=192 a
// branch forward does ~50-90 GFLOP and its backward ~2.5x that against
// well under 1 GB of f32 activations, so it is bound by operations: the
// products are ~90% of them, the attention core the rest.
//
// What this design does about it: every product is one register-tiled SIMT
// GEMM (csrc/gemm_f32.cuh, the kernel and its design note in
// csrc/gemm_f32_simt.cuh): 8 x 12 outputs a thread, so its shared-memory
// reads stay under the FFMA rate; 16-byte cp.async copies two tiles ahead
// of the FFMAs, k-contiguous tiles transposed in shared memory; 64- or
// 128-row blocks by 48-192 columns chosen per product from timings, so the
// port's widths (multiples of 48) pad little; the epilogue (bias, GELU, its
// derivative, the residual) a template parameter, applied on the registers;
// TN split over the B*L rows as far as fills the SMs once, its partials
// folded in one fixed order. Around it: a warp-per-row LayerNorm forward,
// common.cuh's LayerNorm backward (one launch, its column sums folded in
// it) and the attention core of mha_f32.cu. Intermediates (y, qkv, a, z, h
// and their gradients) go through device memory.
//
// Split over a model axis (Megatron, as csrc/attn_branch.cu and
// csrc/mlp_branch.cu split the bf16 branches): a shard runs qkv, the
// attention and proj's K at its attention width Da = (H/mp) d, or the MLP at
// its F/mp; proj and fc2 end in their f32 sums without bias or residual
// (F_NONE), the backward stops at the f32 dy = d(LN output) of the shard, and
// after the model-group all-reduce ssrl_branch_finish_f32 (out = x + (s + b))
// and ssrl_branch_ln_bwd_f32 (the LN backward) finish the branch.
#include <math.h>

#include "common.cuh"
#include "branch_f32.cuh"
#include "gemm_f32.cuh"
#include "mha.cuh"

namespace {

using ssrl::F_BIAS;
using ssrl::F_BIAS_GELU;
using ssrl::F_BIAS_GELU_Z;
using ssrl::F_BIAS_RESID;
using ssrl::F_GELU_BWD;
using ssrl::F_NONE;
using ssrl::gemm_f32;
using ssrl::gemm_tn_f32;
using ssrl::gemm_tn_f32_part_floats;

// ---------------------------------------------------------------------------
// LayerNorm forward, one warp per row, any D (the backward: common.cuh)
// ---------------------------------------------------------------------------

__global__ void ln_f32_kernel(const float* __restrict__ x, const float* __restrict__ s,
                              const float* __restrict__ b, float* __restrict__ y, int M,
                              int D) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (row >= M) return;
  const float* xr = x + (size_t)row * D;
  float t = 0.f;
  for (int c = lane; c < D; c += 32) t += xr[c];
  const float mu = warp_sum(t) / (float)D;
  float q = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = xr[c] - mu;
    q += d * d;
  }
  const float inv = 1.f / sqrtf(warp_sum(q) / (float)D + kLnEps);
  float* yr = y + (size_t)row * D;
  for (int c = lane; c < D; c += 32) yr[c] = (xr[c] - mu) * inv * s[c] + b[c];
}

void launch_ln(const float* x, const float* s, const float* b, float* y, int M, int D,
               cudaStream_t st) {
  ln_f32_kernel<<<cdiv(M, LN_WARPS), 32 * LN_WARPS, 0, st>>>(x, s, b, y, M, D);
}

// LN backward (common.cuh's one-launch design at f32, ln_f32_kernel's
// statistics): dx, and out3 = [d scale | d bias | sum gy].
cudaError_t launch_ln_bwd_f32(const float* x, const float* s, const float* dy,
                              const float* gy, float* dx, float* out3, float* part,
                              float* tmp, int M, int D, cudaStream_t st) {
  return ln_bwd<float, false, false>(x, s, dy, gy, nullptr, dx, nullptr, out3, part, tmp, M,
                                     D, st);
}

// ---------------------------------------------------------------------------
// The attention core's view of the fused (B*L, 3D) qkv buffer (q | k | v
// along the features), the attention output `a` (B*L, D) and, backward, the
// gradients: dqkv in qkv's layout, da in a's
// ---------------------------------------------------------------------------

// Da is the attention width: D itself, or a model-axis shard's (H/mp) d.
ssrl::MhaArgsT<float> qkv_args(const float* qkv, int B, int L, int Da, int H, float scale) {
  ssrl::MhaArgsT<float> m{};
  m.q = qkv;
  m.k = qkv + Da;
  m.v = qkv + 2 * Da;
  m.in_b = (long long)L * 3 * Da; m.in_h = Da / H; m.in_r = 3 * Da;
  m.out_b = (long long)L * Da; m.out_h = Da / H; m.out_r = Da;
  m.B = B; m.H = H; m.L = L; m.d = Da / H;
  m.scale = scale;
  m.post = ssrl::kPreScaled;
  return m;
}

bool attn_ok(int B, int L, int D, int Da, int H, bool bwd) {
  return B >= 1 && H >= 1 && Da >= 1 && Da <= D && Da % H == 0 &&
         ssrl::mha_f32_fits(L, Da / H, bwd) && (!bwd || D <= 256);
}

// With `kept`, y1 and qkv are the caller's (the whole block's backward keeps
// them for the attention backward) and take no workspace.
size_t attn_fwd_carve(Carver& c, size_t M, int D, int Da, bool stash, bool kept, float** y1,
                      float** qkv, float** a_scratch) {
  *y1 = kept ? nullptr : c.take<float>(M * D);
  *qkv = kept ? nullptr : c.take<float>(M * 3 * Da);
  *a_scratch = stash ? nullptr : c.take<float>(M * Da);
  return c.off;
}

// y1 = LN1(x); qkv = y1 Wqkv^T + bqkv, Wqkv (3Da, D)
cudaError_t ln_qkv(const float* x, const float* s, const float* b, const float* wqkv,
                   const float* bqkv, float* y1, float* qkv, int M, int D, int Da,
                   cudaStream_t st) {
  launch_ln(x, s, b, y1, M, D, st);
  return gemm_f32(ssrl::GEMM_NT, F_BIAS, y1, wqkv, bqkv, nullptr, qkv, nullptr, M, 3 * Da, D,
                  st);
}

struct AttnBwdWs {
  float *y1, *qkv, *da, *dqkv, *dy1, *part, *tmp;
};

// With `kept`, y1 and qkv come from the caller's recomputing forward.
size_t attn_bwd_carve(Carver& c, int B, int L, int D, int Da, bool kept, AttnBwdWs* w) {
  const int M = B * L;
  size_t part = gemm_tn_f32_part_floats(D, Da, M);
  const size_t cands[2] = {gemm_tn_f32_part_floats(3 * Da, D, M),
                           ln_bwd_part_floats(M, D)};
  for (size_t x : cands) part = x > part ? x : part;
  w->y1 = kept ? nullptr : c.take<float>((size_t)M * D);
  w->qkv = kept ? nullptr : c.take<float>((size_t)M * 3 * Da);
  w->da = c.take<float>((size_t)M * Da);
  w->dqkv = c.take<float>((size_t)M * 3 * Da);
  w->dy1 = c.take<float>((size_t)M * D);
  w->part = c.take<float>(part);
  w->tmp = c.take<float>((size_t)64 * 3 * D);
  return c.off;
}

struct MlpBwdWs {
  float *y2, *z, *h, *dz, *dy2, *part, *tmp;
};

// With `kept`, y2, z and h are the caller's (the chain's stash) and stay as
// they are: dz takes a buffer of its own. Without, dz goes over h's buffer
// (h is dead after dW2).
size_t mlp_bwd_carve(Carver& c, int M, int D, int F, bool kept, MlpBwdWs* w) {
  size_t part = gemm_tn_f32_part_floats(D, F, M);  // dW2 (D, F), then dW1 (F, D)
  const size_t cands[2] = {gemm_tn_f32_part_floats(F, D, M),
                           ln_bwd_part_floats(M, D)};
  for (size_t x : cands) part = x > part ? x : part;
  w->y2 = kept ? nullptr : c.take<float>((size_t)M * D);
  w->z = kept ? nullptr : c.take<float>((size_t)M * F);
  w->h = kept ? nullptr : c.take<float>((size_t)M * F);
  w->dz = kept ? c.take<float>((size_t)M * F) : w->h;
  w->dy2 = c.take<float>((size_t)M * D);
  w->part = c.take<float>(part);
  w->tmp = c.take<float>((size_t)64 * (F > 3 * D ? F : 3 * D));
  return c.off;
}

// With `kept`, y2, z and h are the caller's and take no workspace.
size_t mlp_fwd_carve(Carver& c, int M, int D, int F, bool kept, float** y2, float** h) {
  *y2 = kept ? nullptr : c.take<float>((size_t)M * D);
  *h = kept ? nullptr : c.take<float>((size_t)M * F);
  return c.off;
}

// The attention forward: out = x + (a Wp^T + bp); or, with `part` set (a
// model-axis shard), only part = a Wp^T, Wp (D, Da). With y1_keep and
// qkv_keep set, LN1(x) and the qkv product are written there.
cudaError_t attn_fwd_seq(const float* x, const ssrl::BranchParamsF32& p, float* out,
                         float* part, float* a, float* y1_keep, float* qkv_keep, void* ws, int B,
                         int L, int D, int Da, int H, float scale, cudaStream_t st) {
  if (!attn_ok(B, L, D, Da, H, false)) return cudaErrorInvalidValue;
  const int M = B * L;
  Carver c{static_cast<char*>(ws)};
  float *y1, *qkv, *a_scratch;
  attn_fwd_carve(c, M, D, Da, a != nullptr, y1_keep != nullptr, &y1, &qkv, &a_scratch);
  if (y1_keep) {
    y1 = y1_keep;
    qkv = qkv_keep;
  }
  float* abuf = a ? a : a_scratch;
  SSRL_TRY(ln_qkv(x, p.ln_s, p.ln_b, p.wa, p.ba, y1, qkv, M, D, Da, st));
  ssrl::MhaArgsT<float> m = qkv_args(qkv, B, L, Da, H, scale);
  m.o = abuf;
  SSRL_TRY(ssrl::mha_f32_fwd(m, st));
  if (part)
    return gemm_f32(ssrl::GEMM_NT, F_NONE, abuf, p.wb, nullptr, nullptr, part, nullptr, M, D,
                    Da, st);
  return gemm_f32(ssrl::GEMM_NT, F_BIAS_RESID, abuf, p.wb, p.bb, x, out, nullptr, M, D, Da,
                  st);
}

// The attention backward; with `dy1_out` set (a model-axis shard) it stops
// at dy1 = dqkv Wqkv, written there (no LN backward: dx and d.dln3 unused).
// With y1_kept and qkv_kept set (the forward's LN1(x) and qkv), it runs
// neither again.
cudaError_t attn_bwd_seq(const float* x, const ssrl::BranchParamsF32& p, const float* a,
                         const float* g, float* dx, const ssrl::BranchGrads& d, float* dy1_out,
                         const float* y1_kept, const float* qkv_kept, void* ws, int B, int L,
                         int D, int Da, int H, float scale, cudaStream_t st) {
  if (!attn_ok(B, L, D, Da, H, true)) return cudaErrorInvalidValue;
  const int M = B * L;
  Carver c{static_cast<char*>(ws)};
  AttnBwdWs w;
  attn_bwd_carve(c, B, L, D, Da, y1_kept != nullptr, &w);
  if (dy1_out) w.dy1 = dy1_out;
  if (y1_kept) {
    w.y1 = const_cast<float*>(y1_kept);
    w.qkv = const_cast<float*>(qkv_kept);
  } else {
    SSRL_TRY(ln_qkv(x, p.ln_s, p.ln_b, p.wa, p.ba, w.y1, w.qkv, M, D, Da, st));
  }
  // dWp = g^T a; da = g Wp
  SSRL_TRY(gemm_tn_f32(g, a, d.dwb, w.part, D, Da, M, st));
  SSRL_TRY(gemm_f32(ssrl::GEMM_NN, F_NONE, g, p.wb, nullptr, nullptr, w.da, nullptr, M, Da, D,
                    st));
  // the attention backward into dqkv (q | k | v columns, qkv's layout)
  ssrl::MhaArgsT<float> m = qkv_args(w.qkv, B, L, Da, H, scale);
  m.dO = w.da;
  m.dq = w.dqkv;
  m.dk = w.dqkv + Da;
  m.dv = w.dqkv + 2 * Da;
  SSRL_TRY(ssrl::mha_f32_bwd(m, st));
  // dWqkv = dqkv^T y1; dbqkv = colsum(dqkv); dy1 = dqkv Wqkv
  SSRL_TRY(gemm_tn_f32(w.dqkv, w.y1, d.dwa, w.part, 3 * Da, D, M, st));
  reduce_rows(w.dqkv, M, 3 * Da, d.dba, w.tmp, st);
  SSRL_TRY(cudaGetLastError());
  SSRL_TRY(gemm_f32(ssrl::GEMM_NN, F_NONE, w.dqkv, p.wa, nullptr, nullptr, w.dy1, nullptr, M,
                    D, 3 * Da, st));
  if (dy1_out) return cudaSuccess;
  return launch_ln_bwd_f32(x, p.ln_s, w.dy1, g, dx, d.dln3, w.part, w.tmp, M, D, st);
}

// The MLP forward: out = x + (h W2^T + b2); or, with `part` set (a model-axis
// shard, F its slice), only part = h W2^T. With y2_keep, z_keep and h_keep
// set, LN2(x), the pre-activation z and h = gelu(z) are written there (fc1
// through F_BIAS_GELU_Z, whose h has F_BIAS_GELU's bits: the same sum, bias
// and erf GELU on the registers).
cudaError_t mlp_fwd_seq(const float* x, const ssrl::BranchParamsF32& p, float* out,
                        float* part, float* y2_keep, float* z_keep, float* h_keep, void* ws,
                        int M, int D, int F, cudaStream_t st) {
  Carver c{static_cast<char*>(ws)};
  float *y2, *h;
  mlp_fwd_carve(c, M, D, F, y2_keep != nullptr, &y2, &h);
  if (y2_keep) {
    y2 = y2_keep;
    h = h_keep;
  }
  launch_ln(x, p.ln_s, p.ln_b, y2, M, D, st);
  SSRL_TRY(gemm_f32(ssrl::GEMM_NT, y2_keep ? F_BIAS_GELU_Z : F_BIAS_GELU, y2, p.wa, p.ba,
                    nullptr, h, z_keep, M, F, D, st));
  if (part)
    return gemm_f32(ssrl::GEMM_NT, F_NONE, h, p.wb, nullptr, nullptr, part, nullptr, M, D, F,
                    st);
  return gemm_f32(ssrl::GEMM_NT, F_BIAS_RESID, h, p.wb, p.bb, x, out, nullptr, M, D, F, st);
}

// The MLP backward; with `dy2_out` set it stops at dy2 = dz W1, written there.
// With y2_kept, z_kept and h_kept set (the forward's LN2(x), z and h), it
// runs neither LN2 nor the fc1 product and starts at dW2.
cudaError_t mlp_bwd_seq(const float* x, const ssrl::BranchParamsF32& p, const float* g,
                        float* dx, const ssrl::BranchGrads& d, float* dy2_out,
                        const float* y2_kept, const float* z_kept, const float* h_kept, void* ws,
                        int M, int D, int F, cudaStream_t st) {
  Carver c{static_cast<char*>(ws)};
  MlpBwdWs w;
  mlp_bwd_carve(c, M, D, F, y2_kept != nullptr, &w);
  if (dy2_out) w.dy2 = dy2_out;
  if (y2_kept) {
    w.y2 = const_cast<float*>(y2_kept);
    w.z = const_cast<float*>(z_kept);
    w.h = const_cast<float*>(h_kept);
  } else {
    launch_ln(x, p.ln_s, p.ln_b, w.y2, M, D, st);
    // z = y2 W1^T + b1, h = gelu(z)
    SSRL_TRY(gemm_f32(ssrl::GEMM_NT, F_BIAS_GELU_Z, w.y2, p.wa, p.ba, nullptr, w.h, w.z, M, F,
                      D, st));
  }
  // dW2 = g^T h; then dz = (g W2) o gelu'(z)
  SSRL_TRY(gemm_tn_f32(g, w.h, d.dwb, w.part, D, F, M, st));
  float* dz = w.dz;
  SSRL_TRY(gemm_f32(ssrl::GEMM_NN, F_GELU_BWD, g, p.wb, nullptr, w.z, dz, nullptr, M, F, D,
                    st));
  // dW1 = dz^T y2; db1 = colsum(dz); dy2 = dz W1
  SSRL_TRY(gemm_tn_f32(dz, w.y2, d.dwa, w.part, F, D, M, st));
  reduce_rows(dz, M, F, d.dba, w.tmp, st);
  SSRL_TRY(cudaGetLastError());
  SSRL_TRY(gemm_f32(ssrl::GEMM_NN, F_NONE, dz, p.wa, nullptr, nullptr, w.dy2, nullptr, M, D, F,
                    st));
  if (dy2_out) return cudaSuccess;
  return launch_ln_bwd_f32(x, p.ln_s, w.dy2, g, dx, d.dln3, w.part, w.tmp, M, D, st);
}

// out = x + (s + b): F_BIAS_RESID's contract on the all-reduced sum s of a
// row-parallel product (the branch outputs split over a model axis), b the
// output bias (D), 4 elements a thread.
__global__ void finish_f32_kernel(const float* __restrict__ x, const float* __restrict__ s,
                                  const float* __restrict__ b, float* __restrict__ out,
                                  long long n4, int D) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * 4;
    const float4 xv = *reinterpret_cast<const float4*>(x + e);
    const float4 sv = *reinterpret_cast<const float4*>(s + e);
    const int c = (int)(e % D);
    float4 o;
    o.x = xv.x + (sv.x + b[c]);
    o.y = xv.y + (sv.y + b[c + 1]);
    o.z = xv.z + (sv.z + b[c + 2]);
    o.w = xv.w + (sv.w + b[c + 3]);
    *reinterpret_cast<float4*>(out + e) = o;
  }
}

}  // namespace

namespace ssrl {

bool attn_f32_ok(int B, int L, int D, int H, bool bwd) { return attn_ok(B, L, D, D, H, bwd); }

size_t attn_f32_fwd_workspace(int B, int L, int D, bool stash) {
  Carver c{nullptr};
  float *y1, *qkv, *as;
  return attn_fwd_carve(c, (size_t)B * L, D, D, stash, false, &y1, &qkv, &as);
}

cudaError_t attn_f32_fwd(const float* x, const BranchParamsF32& p, float* out, float* a,
                         void* ws, int B, int L, int D, int H, float scale, cudaStream_t st) {
  return attn_fwd_seq(x, p, out, nullptr, a, nullptr, nullptr, ws, B, L, D, D, H, scale, st);
}

cudaError_t attn_f32_fwd_keep(const float* x, const BranchParamsF32& p, float* out, float* a,
                              float* y1, float* qkv, void* ws, int B, int L, int D, int H,
                              float scale, cudaStream_t st) {
  return attn_fwd_seq(x, p, out, nullptr, a, y1, qkv, ws, B, L, D, D, H, scale, st);
}

size_t attn_f32_bwd_workspace(int B, int L, int D) {
  Carver c{nullptr};
  AttnBwdWs w;
  return attn_bwd_carve(c, B, L, D, D, false, &w);
}

cudaError_t attn_f32_bwd(const float* x, const BranchParamsF32& p, const float* a,
                         const float* g, float* dx, const BranchGrads& d, void* ws, int B,
                         int L, int D, int H, float scale, cudaStream_t st) {
  return attn_bwd_seq(x, p, a, g, dx, d, nullptr, nullptr, nullptr, ws, B, L, D, D, H, scale,
                      st);
}

size_t attn_f32_bwd_kept_workspace(int B, int L, int D) {
  Carver c{nullptr};
  AttnBwdWs w;
  return attn_bwd_carve(c, B, L, D, D, true, &w);
}

cudaError_t attn_f32_bwd_kept(const float* x, const BranchParamsF32& p, const float* a,
                              const float* y1, const float* qkv, const float* g, float* dx,
                              const BranchGrads& d, void* ws, int B, int L, int D, int H,
                              float scale, cudaStream_t st) {
  return attn_bwd_seq(x, p, a, g, dx, d, nullptr, y1, qkv, ws, B, L, D, D, H, scale, st);
}

bool mlp_f32_ok(int M, int D, int F) { return M >= 1 && D >= 1 && D <= 256 && F >= 1; }

size_t mlp_f32_fwd_workspace(int M, int D, int F) {
  Carver c{nullptr};
  float *y2, *h;
  return mlp_fwd_carve(c, M, D, F, false, &y2, &h);
}

cudaError_t mlp_f32_fwd(const float* x, const BranchParamsF32& p, float* out, void* ws, int M,
                        int D, int F, cudaStream_t st) {
  return mlp_fwd_seq(x, p, out, nullptr, nullptr, nullptr, nullptr, ws, M, D, F, st);
}

cudaError_t mlp_f32_fwd_keep(const float* x, const BranchParamsF32& p, float* out, float* y2,
                             float* z, float* h, int M, int D, int F, cudaStream_t st) {
  return mlp_fwd_seq(x, p, out, nullptr, y2, z, h, nullptr, M, D, F, st);
}

size_t mlp_f32_bwd_workspace(int M, int D, int F) {
  Carver c{nullptr};
  MlpBwdWs w;
  return mlp_bwd_carve(c, M, D, F, false, &w);
}

cudaError_t mlp_f32_bwd(const float* x, const BranchParamsF32& p, const float* g, float* dx,
                        const BranchGrads& d, void* ws, int M, int D, int F, cudaStream_t st) {
  if (!mlp_f32_ok(M, D, F)) return cudaErrorInvalidValue;
  return mlp_bwd_seq(x, p, g, dx, d, nullptr, nullptr, nullptr, nullptr, ws, M, D, F, st);
}

size_t mlp_f32_bwd_kept_workspace(int M, int D, int F) {
  Carver c{nullptr};
  MlpBwdWs w;
  return mlp_bwd_carve(c, M, D, F, true, &w);
}

cudaError_t mlp_f32_bwd_kept(const float* x, const BranchParamsF32& p, const float* y2,
                             const float* z, const float* h, const float* g, float* dx,
                             const BranchGrads& d, void* ws, int M, int D, int F,
                             cudaStream_t st) {
  if (!mlp_f32_ok(M, D, F)) return cudaErrorInvalidValue;
  return mlp_bwd_seq(x, p, g, dx, d, nullptr, y2, z, h, ws, M, D, F, st);
}

}  // namespace ssrl

namespace {

ssrl::BranchParamsF32 params6(const void* ln_s, const void* ln_b, const void* wa,
                              const void* ba, const void* wb, const void* bb) {
  const void* const p[6] = {ln_s, ln_b, wa, ba, wb, bb};
  return ssrl::branch_params_f32(p);
}

}  // namespace

extern "C" {

long long ssrl_attn_branch_fwd_f32_workspace(int B, int L, int D, int stash) {
  return (long long)ssrl::attn_f32_fwd_workspace(B, L, D, stash != 0);
}

// x, out, a: [B][L][D] f32; ln_s, ln_b: [D]; wqkv: [3D][D], bqkv: [3D], wp:
// [D][D], bp: [D], all f32 (torch Linear layout). With `a` non-null the
// attention output is written there (the stash of the training forward);
// with `a` null it goes to the workspace.
int ssrl_attn_branch_fwd_f32(const void* x, const void* ln_s, const void* ln_b,
                             const void* wqkv, const void* bqkv, const void* wp,
                             const void* bp, void* out, void* a, void* ws, int B, int L, int D,
                             int H, float scale, void* stream) {
  return (int)ssrl::attn_f32_fwd(static_cast<const float*>(x),
                                 params6(ln_s, ln_b, wqkv, bqkv, wp, bp),
                                 static_cast<float*>(out), static_cast<float*>(a), ws, B, L, D,
                                 H, scale, static_cast<cudaStream_t>(stream));
}

long long ssrl_attn_branch_bwd_f32_workspace(int B, int L, int D) {
  return (long long)ssrl::attn_f32_bwd_workspace(B, L, D);
}

// From x, the stashed attention output a and the output gradient g (all
// [B][L][D] f32): dx [B][L][D]; dln3 [3][D] = (d ln_s, d ln_b, d bp); dwqkv
// [3D][D]; dbqkv [3D]; dwp [D][D]; all f32.
int ssrl_attn_branch_bwd_f32(const void* x, const void* ln_s, const void* ln_b,
                             const void* wqkv, const void* bqkv, const void* wp,
                             const void* a, const void* g, void* dx, void* dln3, void* dwqkv,
                             void* dbqkv, void* dwp, void* ws, int B, int L, int D, int H,
                             float scale, void* stream) {
  const ssrl::BranchGrads d{static_cast<float*>(dln3), static_cast<float*>(dwqkv),
                            static_cast<float*>(dbqkv), static_cast<float*>(dwp)};
  return (int)ssrl::attn_f32_bwd(static_cast<const float*>(x),
                                 params6(ln_s, ln_b, wqkv, bqkv, wp, nullptr),
                                 static_cast<const float*>(a), static_cast<const float*>(g),
                                 static_cast<float*>(dx), d, ws, B, L, D, H, scale,
                                 static_cast<cudaStream_t>(stream));
}

long long ssrl_mlp_branch_fwd_f32_workspace(int M, int D, int F) {
  return (long long)ssrl::mlp_f32_fwd_workspace(M, D, F);
}

// x, out: [M][D] f32; ln_s, ln_b: [D]; w1: [F][D], b1: [F], w2: [D][F], b2:
// [D], all f32 (torch Linear layout).
int ssrl_mlp_branch_fwd_f32(const void* x, const void* ln_s, const void* ln_b,
                            const void* w1, const void* b1, const void* w2, const void* b2,
                            void* out, void* ws, int M, int D, int F, void* stream) {
  return (int)ssrl::mlp_f32_fwd(static_cast<const float*>(x),
                                params6(ln_s, ln_b, w1, b1, w2, b2), static_cast<float*>(out),
                                ws, M, D, F, static_cast<cudaStream_t>(stream));
}

long long ssrl_mlp_branch_bwd_f32_workspace(int M, int D, int F) {
  return (long long)ssrl::mlp_f32_bwd_workspace(M, D, F);
}

// From x and the output gradient g ([M][D] f32): dx [M][D]; dln3 [3][D] =
// (d ln_s, d ln_b, d b2); dw1 [F][D]; db1 [F]; dw2 [D][F]; all f32.
int ssrl_mlp_branch_bwd_f32(const void* x, const void* ln_s, const void* ln_b,
                            const void* w1, const void* b1, const void* w2, const void* g,
                            void* dx, void* dln3, void* dw1, void* db1, void* dw2, void* ws,
                            int M, int D, int F, void* stream) {
  const ssrl::BranchGrads d{static_cast<float*>(dln3), static_cast<float*>(dw1),
                            static_cast<float*>(db1), static_cast<float*>(dw2)};
  return (int)ssrl::mlp_f32_bwd(static_cast<const float*>(x),
                                params6(ln_s, ln_b, w1, b1, w2, nullptr),
                                static_cast<const float*>(g), static_cast<float*>(dx), d, ws, M,
                                D, F, static_cast<cudaStream_t>(stream));
}

// ---- split over a model axis (the bf16 entries' arguments, at f32) ----

long long ssrl_attn_branch_part_fwd_f32_workspace(int B, int L, int D, int Da, int stash) {
  Carver c{nullptr};
  float *y1, *qkv, *as;
  return (long long)attn_fwd_carve(c, (size_t)B * L, D, Da, stash != 0, false, &y1, &qkv,
                                   &as);
}

int ssrl_attn_branch_part_fwd_f32(const void* x, const void* ln_s, const void* ln_b,
                                  const void* wqkv, const void* bqkv, const void* wp,
                                  void* part, void* a, void* ws, int B, int L, int D, int Da,
                                  int H, float scale, void* stream) {
  return (int)attn_fwd_seq(static_cast<const float*>(x),
                           params6(ln_s, ln_b, wqkv, bqkv, wp, nullptr), nullptr,
                           static_cast<float*>(part), static_cast<float*>(a), nullptr, nullptr,
                           ws, B, L, D, Da, H, scale, static_cast<cudaStream_t>(stream));
}

long long ssrl_attn_branch_part_bwd_f32_workspace(int B, int L, int D, int Da) {
  Carver c{nullptr};
  AttnBwdWs w;
  return (long long)attn_bwd_carve(c, B, L, D, Da, false, &w);
}

int ssrl_attn_branch_part_bwd_f32(const void* x, const void* ln_s, const void* ln_b,
                                  const void* wqkv, const void* bqkv, const void* wp,
                                  const void* a, const void* g, void* dy1, void* dwqkv,
                                  void* dbqkv, void* dwp, void* ws, int B, int L, int D, int Da,
                                  int H, float scale, void* stream) {
  const ssrl::BranchGrads d{nullptr, static_cast<float*>(dwqkv), static_cast<float*>(dbqkv),
                            static_cast<float*>(dwp)};
  return (int)attn_bwd_seq(static_cast<const float*>(x),
                           params6(ln_s, ln_b, wqkv, bqkv, wp, nullptr),
                           static_cast<const float*>(a), static_cast<const float*>(g), nullptr,
                           d, static_cast<float*>(dy1), nullptr, nullptr, ws, B, L, D, Da, H,
                           scale, static_cast<cudaStream_t>(stream));
}

long long ssrl_mlp_branch_part_fwd_f32_workspace(int M, int D, int F) {
  return (long long)ssrl::mlp_f32_fwd_workspace(M, D, F);
}

int ssrl_mlp_branch_part_fwd_f32(const void* x, const void* ln_s, const void* ln_b,
                                 const void* w1, const void* b1, const void* w2, void* part,
                                 void* ws, int M, int D, int F, void* stream) {
  return (int)mlp_fwd_seq(static_cast<const float*>(x), params6(ln_s, ln_b, w1, b1, w2, nullptr),
                          nullptr, static_cast<float*>(part), nullptr, nullptr, nullptr, ws, M, D,
                          F, static_cast<cudaStream_t>(stream));
}

long long ssrl_mlp_branch_part_bwd_f32_workspace(int M, int D, int F) {
  return (long long)ssrl::mlp_f32_bwd_workspace(M, D, F);
}

int ssrl_mlp_branch_part_bwd_f32(const void* x, const void* ln_s, const void* ln_b,
                                 const void* w1, const void* b1, const void* w2, const void* g,
                                 void* dy2, void* dw1, void* db1, void* dw2, void* ws, int M,
                                 int D, int F, void* stream) {
  if (!ssrl::mlp_f32_ok(M, D, F)) return (int)cudaErrorInvalidValue;
  const ssrl::BranchGrads d{nullptr, static_cast<float*>(dw1), static_cast<float*>(db1),
                            static_cast<float*>(dw2)};
  return (int)mlp_bwd_seq(static_cast<const float*>(x), params6(ln_s, ln_b, w1, b1, w2, nullptr),
                          static_cast<const float*>(g), nullptr, d, static_cast<float*>(dy2),
                          nullptr, nullptr, nullptr, ws, M, D, F,
                          static_cast<cudaStream_t>(stream));
}

// out = x + (s + b), x, s and out [M][D] f32, b [D]; D a multiple of 4.
int ssrl_branch_finish_f32(const void* x, const void* s, const void* b, void* out, int M, int D,
                           void* stream) {
  if (M < 1 || D < 4 || D % 4) return (int)cudaErrorInvalidValue;
  const long long n4 = (long long)M * D / 4;
  const int grid = (int)(n4 < 132LL * 16 * 256 ? cdiv(n4, 256) : 132 * 16);
  finish_f32_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(s), static_cast<const float*>(b),
      static_cast<float*>(out), n4, D);
  return (int)cudaGetLastError();
}

long long ssrl_branch_ln_bwd_f32_workspace(int M, int D) {
  Carver c{nullptr};
  c.take<float>(ln_bwd_part_floats(M, D));
  c.take<unsigned>(LNB_DONE);
  return (long long)c.off;
}

// dx = g + LN'(dy) from x, the all-reduced dy and the branch output
// gradient g ([M][D] f32); dln3 [3][D] = (d ln_s, d ln_b, sum g).
int ssrl_branch_ln_bwd_f32(const void* x, const void* ln_s, const void* dy, const void* g,
                           void* dx, void* dln3, void* ws, int M, int D, void* stream) {
  if (M < 1 || D < 1 || D > 256) return (int)cudaErrorInvalidValue;
  Carver c{static_cast<char*>(ws)};
  float* part = c.take<float>(ln_bwd_part_floats(M, D));
  float* tmp = c.take<float>(LNB_DONE);
  return (int)launch_ln_bwd_f32(static_cast<const float*>(x), static_cast<const float*>(ln_s),
                                static_cast<const float*>(dy), static_cast<const float*>(g),
                                static_cast<float*>(dx), static_cast<float*>(dln3), part, tmp, M,
                                D, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
