// The two residual branches of a pre-LN block as host-side launch sequences
// (defined in csrc/attn_branch.cu and csrc/mlp_branch.cu), shared by the
// branch entries, the whole-block kernel (csrc/fused_block.cu) and the
// chained-block kernel (csrc/block_chain.cu).
//
// The three callers compute the same products and differ only in where they
// round (ssrl_vit_mae_jepa_tpu/ops/block_pallas.py, ops/block_chain.py):
//   - the gradient entering a branch backward is bf16 (the branch kernels,
//     block_pallas.py:614) or f32 with its bf16 form beside it as the GEMM
//     operand (the whole block's dx_mid, block_pallas.py:299-304; the chain's
//     gy, block_chain.py:141-195); bias sums take the f32 form;
//   - the gradient a branch backward leaves is written bf16, or f32 as well;
//   - the MLP's pre-activation z is rounded to bf16 before the GELU (branch
//     and chain, block_pallas.py:530) or kept in f32 (the whole block,
//     block_pallas.py:271).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace ssrl {

using bf16_t = __nv_bfloat16;

// Gradient at a branch's output: `op` is its bf16 form, the GEMMs' operand;
// `f32`, where set, is the gradient itself (else `op` is).
struct GradIn {
  const bf16_t* op;
  const float* f32;
};

// Gradient at a branch's input, written as bf16 (`bf`) and, where set, also
// as f32 (`f32`).
struct GradOut {
  bf16_t* bf;
  float* f32;
};

// One branch's parameters: f32 LN scale and bias, bf16 weights (torch Linear
// layout, (out, in)) and biases: (Wqkv, bqkv, Wp, bp) or (W1, b1, W2, b2).
struct BranchParams {
  const float* ln_s;
  const float* ln_b;
  const bf16_t* wa;
  const bf16_t* ba;
  const bf16_t* wb;
  const bf16_t* bb;
};

// One branch's f32 gradients, all written: dln3 = [3][D] (d ln_s, d ln_b,
// d bb), dwa, dba, dwb in the shapes of wa, ba, wb.
struct BranchGrads {
  float* dln3;
  float* dwa;
  float* dba;
  float* dwb;
};

// x (B*L, D) -> out = x + bf16(MHA(bf16(LN(x) Wqkv^T + bqkv)) Wp^T + bp);
// `a` (B*L, D) receives the attention output, or is null (no stash).
bool attn_shape_ok(int B, int L, int D, int H);
size_t attn_fwd_workspace(int B, int L, int D, bool stash);
cudaError_t attn_fwd(const bf16_t* x, const BranchParams& p, bf16_t* out,
                     bf16_t* a, void* ws, int B, int L, int D, int H,
                     float scale, cudaStream_t st);
size_t attn_bwd_workspace(int B, int L, int D);
cudaError_t attn_bwd(const bf16_t* x, const BranchParams& p, const bf16_t* a,
                     GradIn g, GradOut dx, const BranchGrads& d, void* ws,
                     int B, int L, int D, int H, float scale, cudaStream_t st);

// x (M, D) -> out = x + bf16(h W2^T + b2), h = bf16(gelu(z)),
// z = LN(x) W1^T + b1, rounded to bf16 unless z_f32.
bool mlp_shape_ok(int M, int D, int F);
size_t mlp_fwd_workspace(int M, int D, int F);
cudaError_t mlp_fwd(const bf16_t* x, const BranchParams& p, bf16_t* out,
                    void* ws, int M, int D, int F, bool z_f32, cudaStream_t st);
size_t mlp_bwd_workspace(int M, int D, int F, bool z_f32);
cudaError_t mlp_bwd(const bf16_t* x, const BranchParams& p, GradIn g,
                    GradOut dx, const BranchGrads& d, void* ws, int M, int D,
                    int F, bool z_f32, cudaStream_t st);

// ---------------------------------------------------------------------------
// One whole block, for fused_block.cu and block_chain.cu.
// ---------------------------------------------------------------------------

// A block's 12 tensors in the JAX package's _BLOCK_TREE order
// (models/vit.py:213-220): ln1_s, ln1_b, wqkv, bqkv, wp, bp, ln2_s, ln2_b,
// w1, b1, w2, b2.
// branch_params(p) is the attention branch's, branch_params(p + 6) the MLP's.
inline BranchParams branch_params(const void* const* p) {
  return {static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
          static_cast<const bf16_t*>(p[2]), static_cast<const bf16_t*>(p[3]),
          static_cast<const bf16_t*>(p[4]), static_cast<const bf16_t*>(p[5])};
}

// A block's f32 gradients, packed: [dln_attn 3D | dWqkv 3D*D | dbqkv 3D |
// dWp D*D | dln_mlp 3D | dW1 F*D | db1 F | dW2 D*F] (ops/block_fused.py reads
// the same layout).
inline size_t block_grad_floats(int D, int F) {
  const size_t d = D, f = F;
  return 3 * d + 3 * d * d + 3 * d + d * d + 3 * d + f * d + f + d * f;
}

inline void block_grads(float* g, int D, int F, BranchGrads* attn,
                        BranchGrads* mlp) {
  const size_t d = D, f = F;
  attn->dln3 = g;
  attn->dwa = attn->dln3 + 3 * d;
  attn->dba = attn->dwa + 3 * d * d;
  attn->dwb = attn->dba + 3 * d;
  mlp->dln3 = attn->dwb + d * d;
  mlp->dwa = mlp->dln3 + 3 * d;
  mlp->dba = mlp->dwa + f * d;
  mlp->dwb = mlp->dba + f;
}

inline bool block_shape_ok(int B, int L, int D, int H, int F) {
  return attn_shape_ok(B, L, D, H) && mlp_shape_ok(B * L, D, F);
}

}  // namespace ssrl
