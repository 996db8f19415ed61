// A stack of N pre-LN transformer blocks in f32 on Hopper (sm_90a): the
// forward, with or without the stash the backward reads, and the backward.
//
// Replaces the f32 instantiation of the TPU kernels of
// ssrl_vit_mae_jepa_tpu/ops/block_chain.py: _chain_fwd_only (:235 ->
// pallas_call :241), _chain_fwd (:261 -> :267) and _chain_bwd (:288 ->
// :295). The bf16 kernel of the same functions is block_chain.cu.
//
// Forward: N x (attention branch, MLP branch) at f32, where every rounding
// point of block_chain.py:85-117 is a no-op. With a stash it keeps, per
// block k, the attention output a_k, the branch boundary x_mid_k and, for
// k >= 1, the block input x_in_k (:93-117), in the bf16 kernel's slot layout
// at f32, and after those, per block, what the backward would otherwise
// compute again: LN1(x_in_k), qkv_k, LN2(x_mid_k), z_k and h_k = gelu(z_k);
// without one (the no-grad forward, :71-90) it keeps nothing. Backward: the
// blocks in reverse with the gradient in f32 across every branch and block
// (:141-195). Numerics are those of branch_f32.cu: f32 operands and
// accumulation, no TF32, two-pass LN statistics (eps 1e-6), softmax in f32,
// exact erf GELU, every weight gradient reduced in one fixed order with no
// atomics. The plain version is ops/block_chain.py::chain_ref
// (chain_fwd_plain / chain_bwd_plain) at f32.
//
// What bounds it on the H100: the products on the CUDA cores (67 TFLOP/s,
// no TF32), as for the f32 branches: bound by operations.
//
// What this design does about it: one host entry per pass launches the f32
// branch sequences of branch_f32.cu (csrc/branch_f32.cuh) block after block
// on the caller's stream, and the backward runs no product the forward ran.
// The TPU kernel recomputes LN1, qkv, LN2 and fc1 in its backward because
// its stash has to fit VMEM and HBM (block_chain.py:353-373); the card's 80
// GB holds them (5 M D + 2 M F floats a block, ~1.1 GB a MAE decoder block
// at B=768), so the training forward keeps them (attn_f32_fwd_keep,
// mlp_f32_fwd_keep) and the backward starts each branch after them
// (mlp_f32_bwd_kept at dW2, attn_f32_bwd_kept at dWp): 48 M D^2 of product
// work a block in place of 62, and no LN forward pass. The outputs and
// gradients keep the bits of the split pair (fc1's F_BIAS_GELU_Z gives
// F_BIAS_GELU's h). The MLP half as one CUDA-core kernel each way
// (csrc/block_mlp_f32.cu) ran 1.5-2.2x the split MLP sequence's device time
// (PERF.md), so the split sequence stays. The TPU kernel keeps all N blocks'
// weights and the gradient chain resident in VMEM; here the gradient chain
// goes through device memory (two (B*L, D) f32 buffers in turn), and each
// block's 12 gradients are written straight into its packed buffer.
#include "common.cuh"
#include "branch_f32.cuh"

namespace {

size_t max2(size_t a, size_t b) { return a > b ? a : b; }

// Without a stash: x_mid and two buffers the block outputs alternate
// between, and one scratch region the branch forwards take in turn. With
// one, everything lives in the stash.
size_t fwd_carve(Carver& c, int B, int L, int D, int F, bool stash, float** mid, float** xa,
                 float** xb, char** scratch) {
  const size_t M = (size_t)B * L;
  *mid = stash ? nullptr : c.take<float>(M * D);
  *xa = stash ? nullptr : c.take<float>(M * D);
  *xb = stash ? nullptr : c.take<float>(M * D);
  *scratch = c.take<char>(stash ? 0
                                : max2(ssrl::attn_f32_fwd_workspace(B, L, D, false),
                                       ssrl::mlp_f32_fwd_workspace((int)M, D, F)));
  return c.off;
}

// The f32 gradient chain at the branch boundaries, two buffers in turn; one
// scratch region for the kept branch backwards.
size_t bwd_carve(Carver& c, int B, int L, int D, int F, float** g, char** scratch) {
  const size_t M = (size_t)B * L;
  g[0] = c.take<float>(M * D);
  g[1] = c.take<float>(M * D);
  *scratch = c.take<char>(max2(ssrl::mlp_f32_bwd_kept_workspace((int)M, D, F),
                               ssrl::attn_f32_bwd_kept_workspace(B, L, D)));
  return c.off;
}

bool chain_ok(int B, int L, int D, int H, int F, int N, bool bwd) {
  return N >= 1 && ssrl::block_f32_ok(B, L, D, H, F, bwd);
}

// The stash, in f32 floats (ops/block_chain.py::stash_floats counts the same
// layout): first 3N - 1 slots of (B*L, D), a_k at k, x_mid_k at N + k,
// x_in_k (k >= 1) at 2N + k - 1 (the bf16 chain's slots); then per block k
// what its backward takes in place of a recompute, in this order: y1 =
// LN1(x_in_k) (B*L, D), qkv (B*L, 3D), y2 = LN2(x_mid_k) (B*L, D), z and h
// (B*L, F) each. block_shape_ok takes D and F in multiples of 8, so each
// buffer starts on 32 bytes and the GEMM and the attention core keep their
// 16-byte paths.
float* slot(void* stash, int i, size_t MD) { return static_cast<float*>(stash) + i * MD; }

struct Kept {
  float *y1, *qkv, *y2, *z, *h;
};

Kept kept(void* stash, int k, int N, size_t M, int D, int F) {
  float* p = slot(stash, 3 * N - 1, M * D) + (size_t)k * M * (5 * D + 2 * F);
  return {p, p + M * D, p + 4 * M * D, p + 5 * M * D, p + 5 * M * D + M * F};
}

}  // namespace

extern "C" {

long long ssrl_block_chain_fwd_f32_workspace(int B, int L, int D, int F, int stash) {
  Carver c{nullptr};
  float *mid, *xa, *xb;
  char* scratch;
  return (long long)fwd_carve(c, B, L, D, F, stash != 0, &mid, &xa, &xb, &scratch);
}

// x, out: [B*L][D] f32; params: 12 N pointers, block after block, each
// block's f32 tensors in _BLOCK_TREE order (csrc/branch.cuh); stash: the
// layout above, (3N - 1) B L D + N B L (5D + 2F) f32, or null for the
// no-grad forward.
int ssrl_block_chain_fwd_f32(const void* x, const void* const* params, void* out,
                             void* stash, void* ws, int B, int L, int D, int H, int F, int N,
                             float scale, void* stream) {
  if (!chain_ok(B, L, D, H, F, N, stash != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t MD = (size_t)B * L * D;
  Carver c{static_cast<char*>(ws)};
  float *mid, *xa, *xb;
  char* scratch;
  fwd_carve(c, B, L, D, F, stash != nullptr, &mid, &xa, &xb, &scratch);
  const float* xin = static_cast<const float*>(x);
  for (int k = 0; k < N; ++k) {
    const ssrl::BranchParamsF32 pa = ssrl::branch_params_f32(params + 12 * k);
    const ssrl::BranchParamsF32 pm = ssrl::branch_params_f32(params + 12 * k + 6);
    float* xo = k == N - 1 ? static_cast<float*>(out)
                : stash    ? slot(stash, 2 * N + k, MD)
                : (k & 1)  ? xb
                           : xa;
    if (stash) {
      const Kept kp = kept(stash, k, N, (size_t)B * L, D, F);
      float* xm = slot(stash, N + k, MD);
      SSRL_TRY(ssrl::attn_f32_fwd_keep(xin, pa, xm, slot(stash, k, MD), kp.y1, kp.qkv, scratch,
                                       B, L, D, H, scale, st));
      SSRL_TRY(ssrl::mlp_f32_fwd_keep(xm, pm, xo, kp.y2, kp.z, kp.h, B * L, D, F, st));
    } else {
      SSRL_TRY(ssrl::attn_f32_fwd(xin, pa, mid, nullptr, scratch, B, L, D, H, scale, st));
      SSRL_TRY(ssrl::mlp_f32_fwd(mid, pm, xo, scratch, B * L, D, F, st));
    }
    xin = xo;
  }
  return (int)cudaSuccess;
}

long long ssrl_block_chain_bwd_f32_workspace(int B, int L, int D, int F) {
  Carver c{nullptr};
  float* g[2];
  char* scratch;
  return (long long)bwd_carve(c, B, L, D, F, g, &scratch);
}

// g, dx: [B*L][D] f32; stash as the forward wrote it, left as it is (a
// second backward gives the same bits); grads: N blocks of f32 gradients,
// each in the packed layout of ssrl::block_grads, all written.
int ssrl_block_chain_bwd_f32(const void* x, const void* const* params, const void* stash,
                             const void* g, void* dx, void* grads, void* ws, int B, int L,
                             int D, int H, int F, int N, float scale, void* stream) {
  if (!chain_ok(B, L, D, H, F, N, true)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t MD = (size_t)B * L * D;
  void* sv = const_cast<void*>(stash);
  Carver c{static_cast<char*>(ws)};
  float* gb[2];
  char* scratch;
  bwd_carve(c, B, L, D, F, gb, &scratch);
  // gradient at the block output: g itself at the top of the stack
  const float* gout = static_cast<const float*>(g);
  for (int k = N - 1; k >= 0; --k) {
    const void* const* p = params + 12 * k;
    ssrl::BranchGrads da, dm;
    ssrl::block_grads(static_cast<float*>(grads) + k * ssrl::block_grad_floats(D, F), D, F,
                      &da, &dm);
    const Kept kp = kept(sv, k, N, (size_t)B * L, D, F);
    const float* xin = k == 0 ? static_cast<const float*>(x) : slot(sv, 2 * N + k - 1, MD);
    // MLP branch from dW2 on: gradient at x_mid into buffer 1
    SSRL_TRY(ssrl::mlp_f32_bwd_kept(slot(sv, N + k, MD), ssrl::branch_params_f32(p + 6), kp.y2,
                                    kp.z, kp.h, gout, gb[1], dm, scratch, B * L, D, F, st));
    // attention branch from dWp on: gradient at x_in into buffer 0, or dx at
    // the bottom
    float* gin = k == 0 ? static_cast<float*>(dx) : gb[0];
    SSRL_TRY(ssrl::attn_f32_bwd_kept(xin, ssrl::branch_params_f32(p), slot(sv, k, MD), kp.y1,
                                     kp.qkv, gb[1], gin, da, scratch, B, L, D, H, scale, st));
    gout = gb[0];
  }
  return (int)cudaSuccess;
}

}  // extern "C"
