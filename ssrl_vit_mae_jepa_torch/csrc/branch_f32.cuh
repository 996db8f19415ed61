// The f32 residual branches of a pre-LN block as host-side launch sequences
// (defined in csrc/branch_f32.cu), shared by the f32 branch entries, the f32
// whole block (csrc/fused_block_f32.cu) and the f32 chain
// (csrc/block_chain_f32.cu), as csrc/branch.cuh shares the bf16 ones; and
// the f32 MLP half as one kernel each way (csrc/block_mlp_f32.cu).
//
// At f32 every rounding point of the TPU kernels is a no-op
// (ssrl_vit_mae_jepa_tpu/ops/block_pallas.py:256-317, ops/block_chain.py:
// 85-195), so the three callers compute the same function: the gradient in
// and out of a branch backward is plain f32, the MLP's pre-activation stays
// f32, and the whole block is the attention branch followed by the MLP
// branch.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "branch.cuh"

namespace ssrl {

// One branch's f32 parameters (torch Linear layout, (out, in)): LN scale and
// bias, then (Wqkv, bqkv, Wp, bp) or (W1, b1, W2, b2).
struct BranchParamsF32 {
  const float* ln_s;
  const float* ln_b;
  const float* wa;
  const float* ba;
  const float* wb;
  const float* bb;
};

// branch_params_f32(p) is a block's attention branch, branch_params_f32(p + 6)
// its MLP (the _BLOCK_TREE order of csrc/branch.cuh).
inline BranchParamsF32 branch_params_f32(const void* const* p) {
  return {static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
          static_cast<const float*>(p[2]), static_cast<const float*>(p[3]),
          static_cast<const float*>(p[4]), static_cast<const float*>(p[5])};
}

// x (B*L, D) -> out = x + MHA(LN(x) Wqkv^T + bqkv) Wp^T + bp; `a` (B*L, D)
// receives the attention output, or is null (no stash). `bwd`: the shape must
// fit the attention backward too.
bool attn_f32_ok(int B, int L, int D, int H, bool bwd);
size_t attn_f32_fwd_workspace(int B, int L, int D, bool stash);
cudaError_t attn_f32_fwd(const float* x, const BranchParamsF32& p, float* out, float* a,
                         void* ws, int B, int L, int D, int H, float scale, cudaStream_t st);
// From x, the stashed `a` and the output gradient g: dx = g + the branch's
// input gradient, and the branch's gradients (dln3 = d ln_s | d ln_b | d bp).
size_t attn_f32_bwd_workspace(int B, int L, int D);
cudaError_t attn_f32_bwd(const float* x, const BranchParamsF32& p, const float* a,
                         const float* g, float* dx, const BranchGrads& d, void* ws, int B,
                         int L, int D, int H, float scale, cudaStream_t st);

// The whole block's backward keeps LN1(x) and the qkv product from its
// recomputing forward, and the chain's from its training forward:
// attn_f32_fwd_keep writes them to y1 (B*L, D) and qkv (B*L, 3D) as well,
// and attn_f32_bwd_kept takes them in place of running LN1 and the qkv
// product again (the same bits as attn_f32_bwd).
cudaError_t attn_f32_fwd_keep(const float* x, const BranchParamsF32& p, float* out, float* a,
                              float* y1, float* qkv, void* ws, int B, int L, int D, int H,
                              float scale, cudaStream_t st);
size_t attn_f32_bwd_kept_workspace(int B, int L, int D);
cudaError_t attn_f32_bwd_kept(const float* x, const BranchParamsF32& p, const float* a,
                              const float* y1, const float* qkv, const float* g, float* dx,
                              const BranchGrads& d, void* ws, int B, int L, int D, int H,
                              float scale, cudaStream_t st);

// x (M, D) -> out = x + gelu(LN(x) W1^T + b1) W2^T + b2, and its backward
// (dln3 = d ln_s | d ln_b | d b2); the backward takes D <= 256.
bool mlp_f32_ok(int M, int D, int F);
size_t mlp_f32_fwd_workspace(int M, int D, int F);
cudaError_t mlp_f32_fwd(const float* x, const BranchParamsF32& p, float* out, void* ws, int M,
                        int D, int F, cudaStream_t st);
size_t mlp_f32_bwd_workspace(int M, int D, int F);
cudaError_t mlp_f32_bwd(const float* x, const BranchParamsF32& p, const float* g, float* dx,
                        const BranchGrads& d, void* ws, int M, int D, int F, cudaStream_t st);

// The chain's training forward keeps LN2(x), z and h for its backward, as
// it keeps LN1(x) and qkv: mlp_f32_fwd_keep writes them to y2 (M, D), z and
// h (M, F) (no workspace; the output has mlp_f32_fwd's bits), and
// mlp_f32_bwd_kept takes them in place of running LN2 and the fc1 product
// again (the same bits as mlp_f32_bwd), leaving them as they are.
cudaError_t mlp_f32_fwd_keep(const float* x, const BranchParamsF32& p, float* out, float* y2,
                             float* z, float* h, int M, int D, int F, cudaStream_t st);
size_t mlp_f32_bwd_kept_workspace(int M, int D, int F);
cudaError_t mlp_f32_bwd_kept(const float* x, const BranchParamsF32& p, const float* y2,
                             const float* z, const float* h, const float* g, float* dx,
                             const BranchGrads& d, void* ws, int M, int D, int F,
                             cudaStream_t st);

// The f32 MLP half as one CUDA-core kernel each way (csrc/block_mlp_f32.cu,
// alone: it runs slower than mlp_f32_fwd / mlp_f32_bwd, which the whole
// block and the chain keep): mlp_f32_fwd's function with the split kernels'
// bits, and its backward from the f32 gradient g at out (dx = g + the
// half's input gradient, every gradient of d written); z and dy2 never
// reach device memory. Any shape mlp_f32_ok takes.
cudaError_t mlp_half_f32_fwd(const float* x, const BranchParamsF32& p, float* out, int M,
                             int D, int F, cudaStream_t st);
size_t mlp_half_f32_bwd_workspace(int M, int D, int F);
cudaError_t mlp_half_f32_bwd(const float* x, const BranchParamsF32& p, const float* g,
                             float* dx, const BranchGrads& d, void* ws, int M, int D, int F,
                             cudaStream_t st);

// A block (or a chain of them) at f32: the bf16 block's shape gate
// (block_shape_ok, which ops/block_fused.py::supported mirrors) and the f32
// attention core's fit, the backward's too with `bwd`.
inline bool block_f32_ok(int B, int L, int D, int H, int F, bool bwd) {
  return block_shape_ok(B, L, D, H, F) && attn_f32_ok(B, L, D, H, bwd) &&
         mlp_f32_ok(B * L, D, F);
}

}  // namespace ssrl
