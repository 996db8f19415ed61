// Multi-head attention core (csrc/mha.cu), shared by the standalone
// attention entries and by the attention branch (csrc/attn_branch.cu).
//
// One problem is softmax(q k^T / sqrt(d)) v over B images and H heads of
// L tokens and head dim d, on bf16 tensors (mha.cu) or f32 tensors
// (mha_f32.cu) addressed by strides, so that one kernel serves every layout
// the callers hold:
//   element (b, h, i, c) of q, k, v, dq, dk, dv is at
//     ptr[b * in_b + h * in_h + i * in_r + c],
//   element (b, h, i, c) of o and dO at
//     ptr[b * out_b + h * out_h + i * out_r + c].
// The three layouts in use:
//   fused qkv (B, L, 3D): k = q + D, v = q + 2D;  in = (L*3D, d, 3D), out = (L*D, d, D)
//   three (B, L, D):                              in = out = (L*D, d, D)
//   heads (B, H, L, d):                           in = out = (H*L*d, L*d, d)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ssrl {

// Where the 1/sqrt(d) scale goes; the TPU kernels have two contracts.
//   kPreScaled  (ops/attention_pallas_stacked.py, ops/attention_pallas_packed.py):
//     q is scaled in f32 and rounded to bf16 before QK^T;
//     dq = (dS K) * scale, dk = dS^T q_scaled.
//   kPostScaled (ops/attention_pallas.py):
//     the f32 scores are scaled after QK^T;
//     dq = (dS K) * scale, dk = (dS^T q) * scale.
// Both round P and dS to bf16 before their second product and round every
// output once from its f32 accumulator.
enum MhaScale : int { kPreScaled = 0, kPostScaled = 1 };

template <typename T>
struct MhaArgsT {
  const T *q, *k, *v;
  const T* dO;       // backward input
  T* o;              // forward output
  T *dq, *dk, *dv;   // backward outputs, in the layout of q, k, v
  float* colpart;  // bf16 backward, may be null: [B][3 * H * d] f32 column sums of dq | dk | dv
  long long in_b, out_b;
  int in_h, in_r, out_h, out_r;
  int B, H, L, d;
  float scale;
  int post;  // MhaScale
};
using MhaArgs = MhaArgsT<__nv_bfloat16>;

// Whether (L, d) fits the kernels: d <= 32 and L <= 256 (the backward's
// shared memory then leaves two blocks per SM).
bool mha_fits(int L, int d);
// Launch on `st`; return cudaGetLastError() after the launch.
cudaError_t mha_fwd(const MhaArgs& a, cudaStream_t st);
cudaError_t mha_bwd(const MhaArgs& a, cudaStream_t st);

// The f32 core (mha_f32.cu): the same function on f32 tensors with no
// rounding point (each scale contract without its bf16 roundings), no TF32;
// colpart is not written. Its fit is set by shared memory: the forward's
// (bwd = false), or the forward's and the backward's (bwd = true).
bool mha_f32_fits(int L, int d, bool bwd);
cudaError_t mha_f32_fwd(const MhaArgsT<float>& a, cudaStream_t st);
cudaError_t mha_f32_bwd(const MhaArgsT<float>& a, cudaStream_t st);

}  // namespace ssrl
