// The whole pre-LN transformer block in f32 on Hopper (sm_90a), forward and
// backward:
//   x_mid = x + MHA(LN1(x) @ Wqkv^T + bqkv) @ Wp^T + bp
//   out   = x_mid + gelu(LN2(x_mid) @ W1^T + b1) @ W2^T + b2
//
// Replaces the f32 instantiation of the TPU kernels of
// ssrl_vit_mae_jepa_tpu/ops/block_pallas.py: _fb_fwd_impl (:408 ->
// pallas_call :417) and _fb_vjp_bwd (:442 -> :453), the math of
// _block_fwd_one / _block_bwd_one (:256-317). The bf16 kernel of the same
// functions is fused_block.cu.
//
// At f32 every rounding point of _block_fwd_one / _block_bwd_one is a no-op
// (z in f32 into the GELU, dx_mid in f32 between the branches, dx rounded
// once), so the function is the f32 attention branch followed by the f32 MLP
// branch, and its backward is theirs in reverse with dx_mid in f32. The
// residuals are x and the parameters only (:439), so the backward recomputes
// the forward up to x_mid, as the TPU kernel does. Numerics are those of
// branch_f32.cu: f32 operands and accumulation, no TF32, two-pass LN
// statistics (eps 1e-6), softmax in f32, exact erf GELU, every weight
// gradient reduced in one fixed order with no atomics. The plain version is
// ops/block_fused.py::block_ref / block_bwd_plain at f32.
//
// What bounds it on the H100: the products of both branches on the CUDA
// cores (67 TFLOP/s, no TF32): ~24 M D^2 + 4 B L^2 D operations forward
// against 2 M D f32 activations, bound by operations. Run as the two split
// branches in turn, its backward also ran LN1 and the qkv product twice:
// once in the recomputing forward and once more in the attention backward
// (6 M D^2 operations a block, ~1.8 ms of a MAE step at f32).
//
// What this design does about it:
//   - the backward's recomputing forward keeps LN1(x) and qkv
//     (attn_f32_fwd_keep) and the attention backward takes them
//     (attn_f32_bwd_kept), so LN1 and the qkv product run once a call, with
//     the same bits as before;
//   - both halves stay on the f32 branch launches (csrc/branch_f32.cu: the
//     SIMT GEMM of csrc/gemm_f32_simt.cuh and the core of mha_f32.cu); x_mid,
//     a and dx_mid go through device memory, and the 12 gradients are
//     written straight into the packed buffer of ssrl::block_grads.
// The MLP half as one CUDA-core kernel each way (csrc/block_mlp_f32.cu) was
// measured in its place and ran 1.5-2.2x the split MLP sequence's device
// time (PERF.md), so the split sequence stays here.
#include "common.cuh"
#include "branch_f32.cuh"

namespace {

size_t max2(size_t a, size_t b) { return a > b ? a : b; }

// x_mid and one scratch region the two branch forwards take in turn.
size_t fwd_carve(Carver& c, int B, int L, int D, int F, float** mid, char** scratch) {
  const size_t M = (size_t)B * L;
  *mid = c.take<float>(M * D);
  *scratch = c.take<char>(max2(ssrl::attn_f32_fwd_workspace(B, L, D, false),
                               ssrl::mlp_f32_fwd_workspace((int)M, D, F)));
  return c.off;
}

// The recomputed a, x_mid, y1 and qkv, dx_mid, and one scratch region for
// the MLP branch's backward and then the attention backward (the
// recomputing forward needs none: its y1 and qkv are the kept ones).
struct BwdWs {
  float *a, *mid, *y1, *qkv, *gmid;
  char* scratch;
};

size_t bwd_carve(Carver& c, int B, int L, int D, int F, BwdWs* w) {
  const size_t M = (size_t)B * L;
  w->a = c.take<float>(M * D);
  w->mid = c.take<float>(M * D);
  w->y1 = c.take<float>(M * D);
  w->qkv = c.take<float>(M * 3 * D);
  w->gmid = c.take<float>(M * D);
  w->scratch = c.take<char>(max2(ssrl::mlp_f32_bwd_workspace((int)M, D, F),
                                 ssrl::attn_f32_bwd_kept_workspace(B, L, D)));
  return c.off;
}

}  // namespace

extern "C" {

long long ssrl_fused_block_fwd_f32_workspace(int B, int L, int D, int F) {
  Carver c{nullptr};
  float* mid;
  char* scratch;
  return (long long)fwd_carve(c, B, L, D, F, &mid, &scratch);
}

// x, out: [B*L][D] f32; params: the block's 12 f32 tensors in _BLOCK_TREE
// order (csrc/branch.cuh).
int ssrl_fused_block_fwd_f32(const void* x, const void* const* params, void* out, void* ws,
                             int B, int L, int D, int H, int F, float scale, void* stream) {
  if (!ssrl::block_f32_ok(B, L, D, H, F, false)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Carver c{static_cast<char*>(ws)};
  float* mid;
  char* scratch;
  fwd_carve(c, B, L, D, F, &mid, &scratch);
  SSRL_TRY(ssrl::attn_f32_fwd(static_cast<const float*>(x), ssrl::branch_params_f32(params),
                              mid, nullptr, scratch, B, L, D, H, scale, st));
  return (int)ssrl::mlp_f32_fwd(mid, ssrl::branch_params_f32(params + 6),
                                static_cast<float*>(out), scratch, B * L, D, F, st);
}

long long ssrl_fused_block_bwd_f32_workspace(int B, int L, int D, int F) {
  Carver c{nullptr};
  BwdWs w;
  return (long long)bwd_carve(c, B, L, D, F, &w);
}

// g, dx: [B*L][D] f32; grads: the block's f32 gradients in the packed layout
// of ssrl::block_grads, all written.
int ssrl_fused_block_bwd_f32(const void* x, const void* const* params, const void* g,
                             void* dx, void* grads, void* ws, int B, int L, int D, int H,
                             int F, float scale, void* stream) {
  if (!ssrl::block_f32_ok(B, L, D, H, F, true)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Carver c{static_cast<char*>(ws)};
  BwdWs w;
  bwd_carve(c, B, L, D, F, &w);
  ssrl::BranchGrads da, dm;
  ssrl::block_grads(static_cast<float*>(grads), D, F, &da, &dm);
  const float* xf = static_cast<const float*>(x);
  const ssrl::BranchParamsF32 pa = ssrl::branch_params_f32(params);

  // recompute a and x_mid, keeping LN1(x) and qkv
  SSRL_TRY(ssrl::attn_f32_fwd_keep(xf, pa, w.mid, w.a, w.y1, w.qkv, nullptr, B, L, D, H, scale,
                                   st));
  // MLP branch: dx_mid = g + LN2'(...)
  SSRL_TRY(ssrl::mlp_f32_bwd(w.mid, ssrl::branch_params_f32(params + 6),
                             static_cast<const float*>(g), w.gmid, dm, w.scratch, B * L, D, F,
                             st));
  // attention branch from dx_mid, on the kept LN1(x) and qkv
  return (int)ssrl::attn_f32_bwd_kept(xf, pa, w.a, w.y1, w.qkv, w.gmid, static_cast<float*>(dx),
                                      da, w.scratch, B, L, D, H, scale, st);
}

}  // extern "C"
