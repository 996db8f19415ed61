// The whole pre-LN transformer block on Hopper (sm_90a), forward and
// backward:
//   x_mid = x + bf16(a @ Wp^T + bp),  a = MHA(bf16(LN1(x) @ Wqkv^T + bqkv))
//   out   = x_mid + bf16(h @ W2^T + b2),  h = bf16(gelu(z)),
//   z     = bf16(LN2(x_mid)) @ W1^T + b1, kept in f32
//
// Replaces the TPU kernels of ssrl_vit_mae_jepa_tpu/ops/block_pallas.py:
//   _fb_fwd_impl (:408 -> pallas_call :417, body _fwd_kernel :326) and
//   _fb_vjp_bwd (:442 -> :453, body _bwd_kernel :342), the math of
//   _block_fwd_one / _block_bwd_one (:256-317).
//
// The function differs from the two split branches only in where it rounds:
// z stays f32 into the GELU and its derivative (:271), and the backward
// keeps the gradient between the branches, dx_mid, in f32 (:299): it is
// rounded to bf16 only as the GEMM operand (:301), dbp sums the f32 form
// (:303) and dx is rounded once, at the end (:316). The residuals are x and
// the parameters only (:439), so the backward recomputes the forward.
//
// What bounds it on the H100: the products of both branches, each with
// K <= 4D at D = 96-192, sit below the card's ~295 FLOP/byte ridge at these
// widths; like the branch kernels it is bound by the memory traffic of its
// intermediates and by the launch count, not by the tensor cores.
//
// What this design does about it: the forward and the backward are each one
// host entry that launches the branch sequences of attn_branch.cu and
// mlp_branch.cu (csrc/branch.cuh) with this function's rounding points --
// the f32-z epilogues of common.cuh, and a branch backward that takes and
// gives an f32 residual gradient with its bf16 form beside it. Intermediates
// (x_mid, a, dx_mid) go through device memory between the launches; the TPU
// kernel's VMEM residency does not carry over to 227 KB of shared memory per
// SM. Fusing the launches belongs to later work on speed.
#include "common.cuh"
#include "branch.cuh"

namespace {

size_t max2(size_t a, size_t b) { return a > b ? a : b; }

// x_mid and one scratch region the two branch forwards take in turn.
size_t fwd_carve(Carver& c, int B, int L, int D, int F, bf16** mid, char** scratch) {
  const size_t M = (size_t)B * L;
  *mid = c.take<bf16>(M * D);
  *scratch = c.take<char>(max2(ssrl::attn_fwd_workspace(B, L, D, false),
                               ssrl::mlp_fwd_workspace(M, D, F)));
  return c.off;
}

// The recomputed a and x_mid, dx_mid in f32 and bf16, and one scratch region
// for the recomputing forward and the two branch backwards.
size_t bwd_carve(Carver& c, int B, int L, int D, int F, bf16** a, bf16** mid,
                 bf16** gmid, float** gmid32, char** scratch) {
  const size_t M = (size_t)B * L;
  *a = c.take<bf16>(M * D);
  *mid = c.take<bf16>(M * D);
  *gmid = c.take<bf16>(M * D);
  *gmid32 = c.take<float>(M * D);
  *scratch = c.take<char>(max2(max2(ssrl::attn_fwd_workspace(B, L, D, true),
                                    ssrl::mlp_bwd_workspace(M, D, F, true)),
                               ssrl::attn_bwd_workspace(B, L, D)));
  return c.off;
}

}  // namespace

extern "C" {

long long ssrl_fused_block_fwd_workspace(int B, int L, int D, int F) {
  Carver c{nullptr};
  bf16* mid;
  char* scratch;
  return (long long)fwd_carve(c, B, L, D, F, &mid, &scratch);
}

// x, out: [B*L][D] bf16; params: the block's 12 tensors in _BLOCK_TREE order
// (csrc/branch.cuh), LN params f32, weights and biases bf16.
int ssrl_fused_block_fwd(const void* x, const void* const* params, void* out, void* ws,
                         int B, int L, int D, int H, int F, float scale, void* stream) {
  if (!ssrl::block_shape_ok(B, L, D, H, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Carver c{static_cast<char*>(ws)};
  bf16* mid;
  char* scratch;
  fwd_carve(c, B, L, D, F, &mid, &scratch);
  cudaError_t e = ssrl::attn_fwd(static_cast<const bf16*>(x), ssrl::branch_params(params),
                                 mid, nullptr, scratch, B, L, D, H, scale, st);
  if (e != cudaSuccess) return (int)e;
  return (int)ssrl::mlp_fwd(mid, ssrl::branch_params(params + 6), static_cast<bf16*>(out),
                            scratch, B * L, D, F, true, st);
}

long long ssrl_fused_block_bwd_workspace(int B, int L, int D, int F) {
  Carver c{nullptr};
  bf16 *a, *mid, *gmid;
  float* gmid32;
  char* scratch;
  return (long long)bwd_carve(c, B, L, D, F, &a, &mid, &gmid, &gmid32, &scratch);
}

// g, dx: [B*L][D] bf16; grads: the block's f32 gradients in the packed layout
// of ssrl::block_grads, all written.
int ssrl_fused_block_bwd(const void* x, const void* const* params, const void* g,
                         void* dx, void* grads, void* ws, int B, int L, int D, int H,
                         int F, float scale, void* stream) {
  if (!ssrl::block_shape_ok(B, L, D, H, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Carver c{static_cast<char*>(ws)};
  bf16 *a, *mid, *gmid;
  float* gmid32;
  char* scratch;
  bwd_carve(c, B, L, D, F, &a, &mid, &gmid, &gmid32, &scratch);
  ssrl::BranchGrads da, dm;
  ssrl::block_grads(static_cast<float*>(grads), D, F, &da, &dm);
  const bf16* xb = static_cast<const bf16*>(x);
  const ssrl::BranchParams pa = ssrl::branch_params(params);

  // recompute a and x_mid
  cudaError_t e = ssrl::attn_fwd(xb, pa, mid, a, scratch, B, L, D, H, scale, st);
  if (e != cudaSuccess) return (int)e;
  // MLP branch: dx_mid = g + LN2'(...) in f32, and its bf16 form
  e = ssrl::mlp_bwd(mid, ssrl::branch_params(params + 6), {static_cast<const bf16*>(g), nullptr},
                    {gmid, gmid32}, dm, scratch, B * L, D, F, true, st);
  if (e != cudaSuccess) return (int)e;
  // attention branch from the f32 dx_mid; dx rounded once
  return (int)ssrl::attn_bwd(xb, pa, a, {gmid, gmid32}, {static_cast<bf16*>(dx), nullptr},
                             da, scratch, B, L, D, H, scale, st);
}

}  // extern "C"
