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
// at f32; without one (the no-grad forward, :71-90) it keeps nothing.
// Backward: the blocks in reverse with the gradient in f32 across every
// branch and block (:141-195). Numerics are those of branch_f32.cu: f32
// operands and accumulation, no TF32, two-pass LN statistics (eps 1e-6),
// softmax in f32, exact erf GELU, every weight gradient reduced in one fixed
// order with no atomics. The plain version is ops/block_chain.py::chain_ref
// (chain_fwd_plain / chain_bwd_plain) at f32.
//
// What bounds it on the H100: the products on the CUDA cores (67 TFLOP/s,
// no TF32), as for the f32 branches: bound by operations.
//
// What this design does about it: one host entry per pass launches the f32
// branch sequences of branch_f32.cu (csrc/branch_f32.cuh) block after block
// on the caller's stream. The backward reads each block's `a` and x_mid from
// the stash, so it runs LN1 and the qkv product once a block. The MLP half
// as one CUDA-core kernel each way (csrc/block_mlp_f32.cu) was measured in
// place of the MLP branch's sequence and ran 1.5-2.2x its device time
// (PERF.md), so the split sequence stays. The TPU kernel keeps all N blocks'
// weights and the gradient chain resident in VMEM; here the gradient chain
// goes through device memory (two (B*L, D) f32 buffers in turn), and each
// block's 12 gradients are written straight into its packed buffer.
#include "common.cuh"
#include "branch_f32.cuh"

namespace {

size_t max2(size_t a, size_t b) { return a > b ? a : b; }

// Without a stash: x_mid and two buffers the block outputs alternate
// between; and one scratch region the branch forwards take in turn.
size_t fwd_carve(Carver& c, int B, int L, int D, int F, bool stash, float** mid, float** xa,
                 float** xb, char** scratch) {
  const size_t M = (size_t)B * L;
  *mid = stash ? nullptr : c.take<float>(M * D);
  *xa = stash ? nullptr : c.take<float>(M * D);
  *xb = stash ? nullptr : c.take<float>(M * D);
  *scratch = c.take<char>(max2(ssrl::attn_f32_fwd_workspace(B, L, D, stash),
                               ssrl::mlp_f32_fwd_workspace((int)M, D, F)));
  return c.off;
}

// The f32 gradient chain at the branch boundaries, two buffers in turn; one
// scratch region for the branch backwards.
size_t bwd_carve(Carver& c, int B, int L, int D, int F, float** g, char** scratch) {
  const size_t M = (size_t)B * L;
  g[0] = c.take<float>(M * D);
  g[1] = c.take<float>(M * D);
  *scratch = c.take<char>(max2(ssrl::mlp_f32_bwd_workspace((int)M, D, F),
                               ssrl::attn_f32_bwd_workspace(B, L, D)));
  return c.off;
}

bool chain_ok(int B, int L, int D, int H, int F, int N, bool bwd) {
  return N >= 1 && ssrl::block_f32_ok(B, L, D, H, F, bwd);
}

// Stash slots of (B*L, D) f32: a_k at k, x_mid_k at N + k, x_in_k (k >= 1)
// at 2N + k - 1 (ops/block_chain.py reads the same layout).
float* slot(void* stash, int i, size_t MD) { return static_cast<float*>(stash) + i * MD; }

}  // namespace

extern "C" {

long long ssrl_block_chain_fwd_f32_workspace(int B, int L, int D, int F, int stash) {
  Carver c{nullptr};
  float *mid, *xa, *xb;
  char* scratch;
  return (long long)fwd_carve(c, B, L, D, F, stash != 0, &mid, &xa, &xb, &scratch);
}

// x, out: [B*L][D] f32; params: 12 N pointers, block after block, each
// block's f32 tensors in _BLOCK_TREE order (csrc/branch.cuh); stash:
// (3N - 1) [B*L][D] f32 slots, or null for the no-grad forward.
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
    const void* const* p = params + 12 * k;
    float* a = stash ? slot(stash, k, MD) : nullptr;
    float* xm = stash ? slot(stash, N + k, MD) : mid;
    float* xo = k == N - 1 ? static_cast<float*>(out)
                : stash    ? slot(stash, 2 * N + k, MD)
                : (k & 1)  ? xb
                           : xa;
    SSRL_TRY(ssrl::attn_f32_fwd(xin, ssrl::branch_params_f32(p), xm, a, scratch, B, L, D, H,
                                scale, st));
    SSRL_TRY(ssrl::mlp_f32_fwd(xm, ssrl::branch_params_f32(p + 6), xo, scratch, B * L, D, F,
                               st));
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

// g, dx: [B*L][D] f32; stash as the forward wrote it; grads: N blocks of f32
// gradients, each in the packed layout of ssrl::block_grads, all written.
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
    const float* xin = k == 0 ? static_cast<const float*>(x) : slot(sv, 2 * N + k - 1, MD);
    // MLP branch: gradient at x_mid into buffer 1
    SSRL_TRY(ssrl::mlp_f32_bwd(slot(sv, N + k, MD), ssrl::branch_params_f32(p + 6), gout, gb[1],
                               dm, scratch, B * L, D, F, st));
    // attention branch: gradient at x_in into buffer 0, or dx at the bottom
    float* gin = k == 0 ? static_cast<float*>(dx) : gb[0];
    SSRL_TRY(ssrl::attn_f32_bwd(xin, ssrl::branch_params_f32(p), slot(sv, k, MD), gb[1], gin, da,
                                scratch, B, L, D, H, scale, st));
    gout = gb[0];
  }
  return (int)cudaSuccess;
}

}  // extern "C"
