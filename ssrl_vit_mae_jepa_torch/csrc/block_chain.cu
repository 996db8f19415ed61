// A stack of N pre-LN transformer blocks on Hopper (sm_90a): the forward,
// with or without the stash the backward reads, and the backward.
//
// Replaces the TPU kernels of ssrl_vit_mae_jepa_tpu/ops/block_chain.py:
//   _chain_fwd_only (:235 -> pallas_call :241, body _chain_fwd_only_kernel
//   :71), _chain_fwd (:261 -> :267, body _chain_fwd_kernel :93) and
//   _chain_bwd (:288 -> :295, body _chain_bwd_kernel :120).
//
// Forward: N x (attention branch, MLP branch), the split branches' function
// bit for bit (block_chain.py:85-117, block_pallas.py:501-533), z rounded to
// bf16. With a stash it keeps, per block k, the attention output a_k, the
// branch boundary x_mid_k and, for k >= 1, the block input x_in_k (:93-117);
// without one (the no-grad forward, :71-90) it keeps nothing.
// Backward: the blocks in reverse with the gradient gy in f32 across every
// branch and block (:141-194): gy is rounded to bf16 only as the GEMM
// operand and once at the end (:195), and db2 and dbp sum the f32 gy
// (:156, :175).
//
// What bounds it on the H100: the same products as the branch kernels,
// below the card's ~295 FLOP/byte ridge at D = 96-192; memory traffic of the
// intermediates and the launch count bound it, not the tensor cores. The
// MLP half's F-wide intermediates cost the most: as split products z, h and
// dz each went to device memory and back, and y2 and dy2 besides.
//
// What this design does about it: one host entry per pass runs the blocks
// on one stream; the attention half as the attention branch's launches
// (csrc/attn_branch.cu through csrc/branch.cuh), the MLP half as one kernel
// each way (csrc/block_mlp.cu: LN2, fc1, the GELU and fc2 on chip, z
// rounded to bf16, the products summed in the split kernels' order so the
// forward keeps their bits; the backward's dy2 and LN2 backward in its
// epilogue), with the chain's rounding points (an f32 gradient in and out
// of every half's backward, its bf16 form beside it). The TPU kernel keeps
// all N blocks' weights and the gradient chain resident in VMEM; on this
// card the gradient chain goes through device memory (two (B*L, D) f32
// buffers in turn), and the weights are read per launch from L2.
#include "common.cuh"
#include "branch.cuh"

namespace {

size_t max2(size_t a, size_t b) { return a > b ? a : b; }

// Without a stash: x_mid and two buffers the block outputs alternate
// between; and the attention forward's scratch (the MLP half needs none).
size_t fwd_carve(Carver& c, int B, int L, int D, bool stash, bf16** mid, bf16** xa,
                 bf16** xb, char** scratch) {
  const size_t M = (size_t)B * L;
  *mid = stash ? nullptr : c.take<bf16>(M * D);
  *xa = stash ? nullptr : c.take<bf16>(M * D);
  *xb = stash ? nullptr : c.take<bf16>(M * D);
  *scratch = c.take<char>(ssrl::attn_fwd_workspace(B, L, D, stash));
  return c.off;
}

// The f32 gradient chain at the branch boundaries, two buffers in turn, each
// with its bf16 form; one scratch region for the halves' backwards.
size_t bwd_carve(Carver& c, int B, int L, int D, int F, float** g32, bf16** gbf,
                 char** scratch) {
  const size_t M = (size_t)B * L;
  for (int i = 0; i < 2; ++i) {
    g32[i] = c.take<float>(M * D);
    gbf[i] = c.take<bf16>(M * D);
  }
  *scratch = c.take<char>(max2(ssrl::mlp_half_bwd_workspace((int)M, D, F),
                               ssrl::attn_bwd_workspace(B, L, D)));
  return c.off;
}

bool chain_shape_ok(int B, int L, int D, int H, int F, int N) {
  return N >= 1 && ssrl::block_shape_ok(B, L, D, H, F);
}

// Stash slots of (B*L, D) bf16: a_k at k, x_mid_k at N + k, x_in_k (k >= 1)
// at 2N + k - 1 (ops/block_chain.py reads the same layout).
bf16* slot(void* stash, int i, size_t MD) { return static_cast<bf16*>(stash) + i * MD; }

}  // namespace

extern "C" {

long long ssrl_block_chain_fwd_workspace(int B, int L, int D, int F, int stash) {
  (void)F;
  Carver c{nullptr};
  bf16 *mid, *xa, *xb;
  char* scratch;
  return (long long)fwd_carve(c, B, L, D, stash != 0, &mid, &xa, &xb, &scratch);
}

// x, out: [B*L][D] bf16; params: 12 N pointers, block after block, each
// block's in _BLOCK_TREE order (csrc/branch.cuh); stash: (3N - 1) [B*L][D]
// bf16 slots, or null for the no-grad forward.
int ssrl_block_chain_fwd(const void* x, const void* const* params, void* out,
                         void* stash, void* ws, int B, int L, int D, int H, int F,
                         int N, float scale, void* stream) {
  if (!chain_shape_ok(B, L, D, H, F, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t MD = (size_t)B * L * D;
  Carver c{static_cast<char*>(ws)};
  bf16 *mid, *xa, *xb;
  char* scratch;
  fwd_carve(c, B, L, D, stash != nullptr, &mid, &xa, &xb, &scratch);
  const bf16* xin = static_cast<const bf16*>(x);
  for (int k = 0; k < N; ++k) {
    const void* const* p = params + 12 * k;
    bf16* a = stash ? slot(stash, k, MD) : nullptr;
    bf16* xm = stash ? slot(stash, N + k, MD) : mid;
    bf16* xo = k == N - 1 ? static_cast<bf16*>(out)
               : stash    ? slot(stash, 2 * N + k, MD)
               : (k & 1)  ? xb
                          : xa;
    cudaError_t e = ssrl::attn_fwd(xin, ssrl::branch_params(p), xm, a, scratch, B, L, D,
                                   H, scale, st);
    if (e != cudaSuccess) return (int)e;
    e = ssrl::mlp_half_fwd(xm, ssrl::branch_params(p + 6), xo, B * L, D, F, true, st);
    if (e != cudaSuccess) return (int)e;
    xin = xo;
  }
  return (int)cudaSuccess;
}

long long ssrl_block_chain_bwd_workspace(int B, int L, int D, int F) {
  Carver c{nullptr};
  float* g32[2];
  bf16* gbf[2];
  char* scratch;
  return (long long)bwd_carve(c, B, L, D, F, g32, gbf, &scratch);
}

// g, dx: [B*L][D] bf16; stash as the forward wrote it; grads: N blocks of
// f32 gradients, each in the packed layout of ssrl::block_grads, all written.
int ssrl_block_chain_bwd(const void* x, const void* const* params, const void* stash,
                         const void* g, void* dx, void* grads, void* ws, int B, int L,
                         int D, int H, int F, int N, float scale, void* stream) {
  if (!chain_shape_ok(B, L, D, H, F, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t MD = (size_t)B * L * D;
  void* sv = const_cast<void*>(stash);
  Carver c{static_cast<char*>(ws)};
  float* g32[2];
  bf16* gbf[2];
  char* scratch;
  bwd_carve(c, B, L, D, F, g32, gbf, &scratch);
  // gradient at the block output: the bf16 g itself at the top of the stack
  ssrl::GradIn gout{static_cast<const bf16*>(g), nullptr};
  for (int k = N - 1; k >= 0; --k) {
    const void* const* p = params + 12 * k;
    ssrl::BranchGrads da, dm;
    ssrl::block_grads(static_cast<float*>(grads) + k * ssrl::block_grad_floats(D, F), D,
                      F, &da, &dm);
    const bf16* xin = k == 0 ? static_cast<const bf16*>(x) : slot(sv, 2 * N + k - 1, MD);
    // MLP half: gradient at x_mid into buffer 1
    cudaError_t e = ssrl::mlp_half_bwd(slot(sv, N + k, MD), ssrl::branch_params(p + 6), gout,
                                       {gbf[1], g32[1]}, dm, scratch, B * L, D, F, true, st);
    if (e != cudaSuccess) return (int)e;
    // attention half: gradient at x_in into buffer 0, or dx once at the end
    const ssrl::GradOut gin = k == 0 ? ssrl::GradOut{static_cast<bf16*>(dx), nullptr}
                                     : ssrl::GradOut{gbf[0], g32[0]};
    e = ssrl::attn_bwd(xin, ssrl::branch_params(p), slot(sv, k, MD), {gbf[1], g32[1]}, gin,
                       da, scratch, B, L, D, H, scale, st);
    if (e != cudaSuccess) return (int)e;
    gout = {gbf[0], g32[0]};
  }
  return (int)cudaSuccess;
}

}  // extern "C"
