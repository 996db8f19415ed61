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
// against 2 M D f32 activations, bound by operations.
//
// What this design does about it: nothing beyond the branches' own design --
// the first version, right before fast. One host entry per pass launches the
// f32 branch sequences of branch_f32.cu (csrc/branch_f32.cuh) on the
// caller's stream; x_mid, the recomputed attention output `a` and dx_mid go
// through device memory, and the 12 gradients are written straight into the
// packed buffer of ssrl::block_grads.
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

// The recomputed a and x_mid, dx_mid, and one scratch region for the
// recomputing forward and the two branch backwards.
size_t bwd_carve(Carver& c, int B, int L, int D, int F, float** a, float** mid, float** gmid,
                 char** scratch) {
  const size_t M = (size_t)B * L;
  *a = c.take<float>(M * D);
  *mid = c.take<float>(M * D);
  *gmid = c.take<float>(M * D);
  *scratch = c.take<char>(max2(max2(ssrl::attn_f32_fwd_workspace(B, L, D, true),
                                    ssrl::mlp_f32_bwd_workspace((int)M, D, F)),
                               ssrl::attn_f32_bwd_workspace(B, L, D)));
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
  float *a, *mid, *gmid;
  char* scratch;
  return (long long)bwd_carve(c, B, L, D, F, &a, &mid, &gmid, &scratch);
}

// g, dx: [B*L][D] f32; grads: the block's f32 gradients in the packed layout
// of ssrl::block_grads, all written.
int ssrl_fused_block_bwd_f32(const void* x, const void* const* params, const void* g,
                             void* dx, void* grads, void* ws, int B, int L, int D, int H,
                             int F, float scale, void* stream) {
  if (!ssrl::block_f32_ok(B, L, D, H, F, true)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Carver c{static_cast<char*>(ws)};
  float *a, *mid, *gmid;
  char* scratch;
  bwd_carve(c, B, L, D, F, &a, &mid, &gmid, &scratch);
  ssrl::BranchGrads da, dm;
  ssrl::block_grads(static_cast<float*>(grads), D, F, &da, &dm);
  const float* xf = static_cast<const float*>(x);
  const ssrl::BranchParamsF32 pa = ssrl::branch_params_f32(params);

  // recompute a and x_mid
  SSRL_TRY(ssrl::attn_f32_fwd(xf, pa, mid, a, scratch, B, L, D, H, scale, st));
  // MLP branch: dx_mid = g + LN2'(...)
  SSRL_TRY(ssrl::mlp_f32_bwd(mid, ssrl::branch_params_f32(params + 6),
                             static_cast<const float*>(g), gmid, dm, scratch, B * L, D, F, st));
  // attention branch from dx_mid
  return (int)ssrl::attn_f32_bwd(xf, pa, a, gmid, static_cast<float*>(dx), da, scratch, B, L,
                                 D, H, scale, st);
}

}  // extern "C"
