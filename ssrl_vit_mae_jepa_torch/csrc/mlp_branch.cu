// MLP branch of a pre-LN transformer block on Hopper (sm_90a):
//   out = x + bf16(h @ W2^T + b2),  h = bf16(gelu(bf16(LN2(x) @ W1^T + b1)))
// and its backward from (x, dy).
//
// Replaces the TPU kernels of ssrl_vit_mae_jepa_tpu/ops/block_pallas.py:
//   _mb_fwd (:807, body _mlp_branch_fwd_kernel :617) and _mb_bwd (:831,
//   _mlp_branch_bwd_kernel :622).
//
// What bounds it on the H100: K is D = 144/192 for fc1 and F = 4D for fc2,
// so at B*L rows the branch does ~2*4*D*F FLOPs per row against ~2*(D + F)
// bf16 bytes of activations per row for each GEMM: a few hundred FLOP/byte
// at best, at or below the ridge, so bound by the bytes of its activations.
//
// What this design does about it: LayerNorm in its own warp-per-row pass,
// then two GEMMs on wgmma fed by TMA (csrc/gemm_sm90.cuh) whose epilogues
// carry everything elementwise from the accumulator registers -- bias +
// bf16 rounding + exact-erf GELU after fc1, bias + bf16 rounding + residual
// after fc2 -- so z and h are each written once in bf16 and nothing is
// written in f32 on the forward. The backward recomputes LN2, fc1 and the
// GELU (as the TPU kernel does) and folds gelu'(z) and the f32 column sums
// for db1 into the dh GEMM's epilogue; weight gradients are TN products
// split over the B*L rows into f32 partials and a deterministic column
// reduction.
//
// Numerics contract: LN statistics in f32 (two-pass, eps 1e-6); y2 in bf16;
// z rounded to bf16 before the exact-erf GELU; h in bf16; the fc2 output
// rounded to bf16 before the residual add. db1 is summed from the f32 dz and
// dW1 uses the bf16-rounded dz; every weight and bias gradient is f32. The
// whole-block kernel keeps z in f32 (z_f32, the EPI_*GELU32* epilogues), and
// it and the chain pass an f32 incoming gradient (csrc/branch.cuh).
//
// Split over a model axis (Megatron; _TP_RULES of
// ssrl_vit_mae_jepa_tpu/parallel/mesh.py:61-65 on _mb_fwd and _mb_bwd): a
// rank holds an F/mp slice of fc1's rows and fc2's columns, so the branch
// runs as above at F/mp, except that fc2 ends in its f32 sum h W2^T without
// bias or residual (ssrl_mlp_branch_part_fwd), and the backward stops at
// the f32 dy2 = dz W1 of the slice (ssrl_mlp_branch_part_bwd); the caller
// all-reduces each over the model group and finishes with
// ssrl_branch_finish / ssrl_branch_ln_bwd (csrc/attn_branch.cu).
#include "common.cuh"
#include "branch.cuh"

namespace {

size_t fwd_carve(Carver& c, size_t M, int D, int F, bf16** y2, bf16** h) {
  *y2 = c.take<bf16>(M * D);
  *h = c.take<bf16>(M * F);
  return c.off;
}

struct BwdPlan {
  int k_w2, k_w1;
  size_t part, tmp;
};

BwdPlan bwd_plan(int M, int D, int F) {
  BwdPlan p;
  int s_w2, s_w1;
  p.k_w2 = ssrl::gemm_splitk(D, F, M, &s_w2);
  p.k_w1 = ssrl::gemm_splitk(F, D, M, &s_w1);
  size_t part = (size_t)s_w2 * D * F;
  const size_t cands[3] = {(size_t)s_w1 * F * D, (size_t)cdiv(M, kGemmBM) * F,
                           ln_bwd_part_floats(M, D)};
  for (size_t x : cands) part = x > part ? x : part;
  p.part = part;
  p.tmp = (size_t)64 * (F > 3 * D ? F : 3 * D);
  return p;
}

// z is bf16, or f32 (z32) for the whole block
size_t bwd_carve(Carver& c, int M, int D, int F, bool z_f32, bf16** y2, bf16** z,
                 float** z32, bf16** h, bf16** dz, float** dy2, float** part,
                 float** tmp) {
  const BwdPlan p = bwd_plan(M, D, F);
  *y2 = c.take<bf16>((size_t)M * D);
  *z = z_f32 ? nullptr : c.take<bf16>((size_t)M * F);
  *z32 = z_f32 ? c.take<float>((size_t)M * F) : nullptr;
  *h = c.take<bf16>((size_t)M * F);
  *dz = c.take<bf16>((size_t)M * F);
  *dy2 = c.take<float>((size_t)M * D);
  *part = c.take<float>(p.part);
  *tmp = c.take<float>(p.tmp);
  return c.off;
}

// y2 = LN2(x); h = bf16(gelu(z)), z = y2 @ W1^T + b1, rounded to bf16 unless
// z_f32 (stored to zout / zout32 if set)
cudaError_t fc1_gelu(const bf16* x, const ssrl::BranchParams& p, bf16* y2, bf16* h,
                     bf16* zout, float* zout32, int M, int D, int F, bool z_f32,
                     cudaStream_t st) {
  launch_ln_fwd(x, p.ln_s, p.ln_b, y2, M, D, st);
  GemmArgs g{};
  g.A = y2; g.lda = D;
  g.B = p.wa; g.ldb = D;
  g.M = M; g.N = F; g.K = D;
  g.C = h; g.ldc = F;
  g.bias = p.ba;
  g.Zout = zout;
  g.Zout32 = zout32;
  return ssrl::gemm(ssrl::GEMM_NT, z_f32 ? EPI_BIAS_GELU32 : EPI_BIAS_GELU, g, st);
}

// The forward: out = x + bf16(h W2^T + b2); or, with `part` set (a
// model-axis shard, F its slice), only the f32 partial sum part = h W2^T.
cudaError_t mlp_fwd_seq(const bf16* x, const ssrl::BranchParams& p, bf16* out, float* part,
                        void* ws, int M, int D, int F, bool z_f32, cudaStream_t st) {
  if (!ssrl::mlp_shape_ok(M, D, F)) return cudaErrorInvalidValue;
  Carver c{static_cast<char*>(ws)};
  bf16 *y2, *h;
  fwd_carve(c, M, D, F, &y2, &h);
  SSRL_TRY(fc1_gelu(x, p, y2, h, nullptr, nullptr, M, D, F, z_f32, st));
  GemmArgs g{};
  g.A = h; g.lda = F;
  g.B = p.wb; g.ldb = F;
  g.M = M; g.N = D; g.K = F;
  g.ldc = D;
  if (part) {
    g.C = part;
    SSRL_TRY(ssrl::gemm(ssrl::GEMM_NT, EPI_F32, g, st));
  } else {
    g.C = out;
    g.bias = p.bb;
    g.R = x;
    SSRL_TRY(ssrl::gemm(ssrl::GEMM_NT, EPI_BIAS_RESID, g, st));
  }
  return cudaGetLastError();
}

// The backward; with `dy2_out` set (a model-axis shard) it stops at the f32
// dy2 = dz W1 of the slice, written there, and leaves dx and d.dln3 to
// ssrl_branch_ln_bwd after the model-group all-reduce.
cudaError_t mlp_bwd_seq(const bf16* x, const ssrl::BranchParams& p, ssrl::GradIn gy,
                        ssrl::GradOut dx, const ssrl::BranchGrads& d, float* dy2_out, void* ws,
                        int M, int D, int F, bool z_f32, cudaStream_t st) {
  if (!ssrl::mlp_shape_ok(M, D, F)) return cudaErrorInvalidValue;
  const BwdPlan plan = bwd_plan(M, D, F);
  Carver c{static_cast<char*>(ws)};
  bf16 *y2, *z, *h, *dz;
  float *z32, *dy2, *part, *tmp;
  bwd_carve(c, M, D, F, z_f32, &y2, &z, &z32, &h, &dz, &dy2, &part, &tmp);
  if (dy2_out) dy2 = dy2_out;

  SSRL_TRY(fc1_gelu(x, p, y2, h, z, z32, M, D, F, z_f32, st));

  // dW2 = dy^T h (split over the B*L rows)
  GemmArgs w{};
  w.A = gy.op; w.lda = D;
  w.B = h; w.ldb = F;
  w.M = D; w.N = F; w.K = M;
  w.k_chunk = plan.k_w2;
  w.C = part; w.ldc = F; w.c_split = (long long)D * F;
  SSRL_TRY(ssrl::gemm(ssrl::GEMM_TN, EPI_F32, w, st));
  reduce_rows(part, cdiv(M, plan.k_w2), D * F, d.dwb, tmp, st);

  // dz = (dy @ W2) * gelu'(z), bf16; db1 from the f32 dz
  GemmArgs g{};
  g.A = gy.op; g.lda = D;
  g.B = p.wb; g.ldb = F;
  g.M = M; g.N = F; g.K = D;
  g.C = dz; g.ldc = F;
  g.Zin = z;
  g.Zin32 = z32;
  g.colpart = part;
  SSRL_TRY(ssrl::gemm(ssrl::GEMM_NN, z_f32 ? EPI_GELU32_BWD : EPI_GELU_BWD, g, st));
  reduce_rows(part, cdiv(M, kGemmBM), F, d.dba, tmp, st);

  // dW1 = dz^T y2
  GemmArgs w1g{};
  w1g.A = dz; w1g.lda = F;
  w1g.B = y2; w1g.ldb = D;
  w1g.M = F; w1g.N = D; w1g.K = M;
  w1g.k_chunk = plan.k_w1;
  w1g.C = part; w1g.ldc = D; w1g.c_split = (long long)F * D;
  SSRL_TRY(ssrl::gemm(ssrl::GEMM_TN, EPI_F32, w1g, st));
  reduce_rows(part, cdiv(M, plan.k_w1), F * D, d.dwa, tmp, st);

  // dy2 = dz @ W1 (f32)
  GemmArgs y{};
  y.A = dz; y.lda = F;
  y.B = p.wa; y.ldb = D;
  y.M = M; y.N = D; y.K = F;
  y.C = dy2; y.ldc = D;
  SSRL_TRY(ssrl::gemm(ssrl::GEMM_NN, EPI_F32, y, st));
  if (dy2_out) return cudaGetLastError();

  launch_ln_bwd(x, p.ln_s, dy2, gy.op, gy.f32, dx.bf, dx.f32, d.dln3, part, tmp, M, D,
                st);
  return cudaGetLastError();
}

}  // namespace

namespace ssrl {

bool mlp_shape_ok(int M, int D, int F) {
  return M >= 1 && D >= 8 && D <= 256 && F >= 8 && D % 8 == 0 && F % 8 == 0;
}

size_t mlp_fwd_workspace(int M, int D, int F) {
  Carver c{nullptr};
  bf16 *y2, *h;
  return fwd_carve(c, M, D, F, &y2, &h);
}

cudaError_t mlp_fwd(const bf16* x, const BranchParams& p, bf16* out, void* ws, int M,
                    int D, int F, bool z_f32, cudaStream_t st) {
  return mlp_fwd_seq(x, p, out, nullptr, ws, M, D, F, z_f32, st);
}

size_t mlp_bwd_workspace(int M, int D, int F, bool z_f32) {
  Carver c{nullptr};
  bf16 *y2, *z, *h, *dz;
  float *z32, *dy2, *part, *tmp;
  return bwd_carve(c, M, D, F, z_f32, &y2, &z, &z32, &h, &dz, &dy2, &part, &tmp);
}

cudaError_t mlp_bwd(const bf16* x, const BranchParams& p, GradIn gy, GradOut dx,
                    const BranchGrads& d, void* ws, int M, int D, int F, bool z_f32,
                    cudaStream_t st) {
  return mlp_bwd_seq(x, p, gy, dx, d, nullptr, ws, M, D, F, z_f32, st);
}

}  // namespace ssrl

extern "C" {

long long ssrl_mlp_branch_fwd_workspace(int M, int D, int F) {
  return (long long)ssrl::mlp_fwd_workspace(M, D, F);
}

// x, out: [M][D] bf16; ln_s, ln_b: [D] f32; w1: [F][D], b1: [F], w2: [D][F],
// b2: [D] bf16 (torch Linear layout).
int ssrl_mlp_branch_fwd(const void* x, const void* ln_s, const void* ln_b,
                        const void* w1, const void* b1, const void* w2,
                        const void* b2, void* out, void* ws, int M, int D, int F,
                        void* stream) {
  const void* p[6] = {ln_s, ln_b, w1, b1, w2, b2};
  return (int)ssrl::mlp_fwd(static_cast<const bf16*>(x), ssrl::branch_params(p),
                            static_cast<bf16*>(out), ws, M, D, F, false,
                            static_cast<cudaStream_t>(stream));
}

long long ssrl_mlp_branch_bwd_workspace(int M, int D, int F) {
  return (long long)ssrl::mlp_bwd_workspace(M, D, F, false);
}

// Outputs (all written): dx [M][D] bf16; dln3 [3][D] f32 = (d ln_s, d ln_b,
// d b2); dw1 [F][D], db1 [F], dw2 [D][F] f32.
int ssrl_mlp_branch_bwd(const void* x, const void* ln_s, const void* ln_b,
                        const void* w1, const void* b1, const void* w2,
                        const void* gy, void* dx, void* dln3, void* dw1,
                        void* db1, void* dw2, void* ws, int M, int D, int F,
                        void* stream) {
  const void* p[6] = {ln_s, ln_b, w1, b1, w2, nullptr};
  const ssrl::BranchGrads d{static_cast<float*>(dln3), static_cast<float*>(dw1),
                            static_cast<float*>(db1), static_cast<float*>(dw2)};
  return (int)ssrl::mlp_bwd(static_cast<const bf16*>(x), ssrl::branch_params(p),
                            {static_cast<const bf16*>(gy), nullptr},
                            {static_cast<bf16*>(dx), nullptr}, d, ws, M, D, F, false,
                            static_cast<cudaStream_t>(stream));
}

// ---- split over a model axis: F the shard's slice of the hidden width ----

long long ssrl_mlp_branch_part_fwd_workspace(int M, int D, int F) {
  return (long long)ssrl::mlp_fwd_workspace(M, D, F);
}

// x [M][D] bf16; ln_s, ln_b [D] f32; w1 [F][D], b1 [F], w2 [D][F] bf16 (the
// shard's rows of fc1, columns of fc2). Writes part [M][D] f32 = h W2^T.
int ssrl_mlp_branch_part_fwd(const void* x, const void* ln_s, const void* ln_b,
                             const void* w1, const void* b1, const void* w2, void* part,
                             void* ws, int M, int D, int F, void* stream) {
  const void* p[6] = {ln_s, ln_b, w1, b1, w2, nullptr};
  return (int)mlp_fwd_seq(static_cast<const bf16*>(x), ssrl::branch_params(p), nullptr,
                          static_cast<float*>(part), ws, M, D, F, false,
                          static_cast<cudaStream_t>(stream));
}

long long ssrl_mlp_branch_part_bwd_workspace(int M, int D, int F) {
  return (long long)ssrl::mlp_bwd_workspace(M, D, F, false);
}

// From x and the bf16 output gradient gy [M][D]: dy2 [M][D] f32 (this
// shard's part of LN2's output gradient), dw1 [F][D], db1 [F], dw2 [D][F].
int ssrl_mlp_branch_part_bwd(const void* x, const void* ln_s, const void* ln_b,
                             const void* w1, const void* b1, const void* w2, const void* gy,
                             void* dy2, void* dw1, void* db1, void* dw2, void* ws, int M,
                             int D, int F, void* stream) {
  const void* p[6] = {ln_s, ln_b, w1, b1, w2, nullptr};
  const ssrl::BranchGrads d{nullptr, static_cast<float*>(dw1), static_cast<float*>(db1),
                            static_cast<float*>(dw2)};
  return (int)mlp_bwd_seq(static_cast<const bf16*>(x), ssrl::branch_params(p),
                          {static_cast<const bf16*>(gy), nullptr}, {nullptr, nullptr}, d,
                          static_cast<float*>(dy2), ws, M, D, F, false,
                          static_cast<cudaStream_t>(stream));
}

const char* ssrl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
