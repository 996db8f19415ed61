// Attention branch of a pre-LN transformer block on Hopper (sm_90a):
//   out = x + bf16(a @ Wp^T + bp),  a = MHA(bf16(LN1(x) @ Wqkv^T + bqkv))
// and its backward from (x, a, dy).
//
// Replaces the TPU kernels of ssrl_vit_mae_jepa_tpu/ops/block_pallas.py:
//   _ab_fwd (:722, body _attn_branch_fwd_kernel :536), _ab_fwd_only (:692,
//   _attn_branch_fwd_only_kernel :555) and _ab_bwd (:752,
//   _attn_branch_bwd_kernel :573), with the attention math of
//   ops/attention_pallas_stacked.py::_attn_fwd_one/_attn_bwd_one (:169-242).
//
// What bounds it on the H100: at the model's widths (D = 144/192, head dim
// d = 24/32, L = 37/145) every GEMM has K <= 3D, so each output element costs
// a few hundred MACs and the work sits far below the card's ~295 FLOP/byte
// ridge. The branch is bound by memory traffic and by launch count, not by
// the tensor cores.
//
// What this design does about it: a few simple launches per pass, each
// reading bf16 and writing bf16 only once --
//   1. LayerNorm (warp per row, f32 statistics) -> y1;
//   2. the wgmma + TMA GEMM of csrc/gemm_sm90.cuh with the bias in the
//      epilogue -> qkv;
//   3. attention through the core of mha.cu (one block per (image, head);
//      q, k, v, the probabilities and dS stay in shared memory as bf16
//      tiles, so the L x L scores never reach device memory), reading q, k
//      and v straight out of the qkv buffer; its backward also writes the
//      per-image dbqkv partials;
//   4. the same GEMM with bias and residual in the epilogue -> out.
// The backward recomputes LN1 and qkv (one GEMM) instead of storing them, as
// the TPU kernel does; weight gradients are TN products split over the B*L
// rows into f32 partials, followed by a deterministic column reduction. The
// no-grad forward is the same sequence with `a` written to a scratch buffer
// that the caller drops. Fusing the launches (LayerNorm into the GEMMs)
// belongs to later work on speed.
//
// Numerics contract: LN statistics in f32 (two-pass, eps 1e-6); y1 and qkv
// rounded to bf16; q scaled in f32 then rounded to bf16 before QK^T; softmax
// in f32 with P rounded to bf16 before PV; `a` in bf16; the projection
// rounded to bf16 before the residual add. Backward: dS = P o (dP -
// rowsum(dP o P)) from the f32 P, rounded to bf16; dbqkv summed from the f32
// dqkv while dWqkv uses its bf16 form; all weight and bias gradients in f32.
// The incoming gradient is bf16 here; the whole-block and chain kernels pass
// an f32 one with its bf16 form (csrc/branch.cuh).
#include "common.cuh"
#include "branch.cuh"
#include "mha.cuh"

namespace {

// The attention core's view of the fused (B*L, 3D) qkv buffer: q | k | v
// along the features, the attention output `a` and its gradient (B*L, D).
ssrl::MhaArgs qkv_args(const bf16* qkv, int B, int L, int D, int H, float scale) {
  ssrl::MhaArgs m{};
  m.q = qkv;
  m.k = qkv + D;
  m.v = qkv + 2 * D;
  m.in_b = (long long)L * 3 * D; m.in_h = D / H; m.in_r = 3 * D;
  m.out_b = (long long)L * D; m.out_h = D / H; m.out_r = D;
  m.B = B; m.H = H; m.L = L; m.d = D / H;
  m.scale = scale;
  m.post = ssrl::kPreScaled;
  return m;
}

// Scratch of the forward: y1, qkv and, without a stash, the attention output.
size_t fwd_carve(Carver& c, size_t M, int D, bool stash, bf16** y1, bf16** qkv,
                 bf16** a_scratch) {
  *y1 = c.take<bf16>(M * D);
  *qkv = c.take<bf16>(M * 3 * D);
  *a_scratch = stash ? nullptr : c.take<bf16>(M * D);
  return c.off;
}

struct BwdPlan {
  int k_wp, k_wqkv;
  size_t part, tmp;
};

BwdPlan bwd_plan(int B, int L, int D) {
  BwdPlan p;
  const int M = B * L;
  int s_wp, s_wqkv;
  p.k_wp = ssrl::gemm_splitk(D, D, M, &s_wp);
  p.k_wqkv = ssrl::gemm_splitk(3 * D, D, M, &s_wqkv);
  size_t part = (size_t)s_wp * D * D;
  const size_t cands[3] = {(size_t)B * 3 * D, (size_t)s_wqkv * 3 * D * D,
                           (size_t)ln_bwd_blocks(M) * 3 * D};
  for (size_t x : cands) part = x > part ? x : part;
  p.part = part;
  p.tmp = (size_t)64 * 3 * D;
  return p;
}

size_t bwd_carve(Carver& c, int B, int L, int D, bf16** y1, bf16** qkv, bf16** da,
                 bf16** dqkv, float** dy1, float** part, float** tmp) {
  const size_t M = (size_t)B * L;
  const BwdPlan p = bwd_plan(B, L, D);
  *y1 = c.take<bf16>(M * D);
  *qkv = c.take<bf16>(M * 3 * D);
  *da = c.take<bf16>(M * D);
  *dqkv = c.take<bf16>(M * 3 * D);
  *dy1 = c.take<float>(M * D);
  *part = c.take<float>(p.part);
  *tmp = c.take<float>(p.tmp);
  return c.off;
}

// y1 = LN1(x); qkv = bf16(y1 @ Wqkv^T + bqkv)
cudaError_t ln_qkv(const bf16* x, const ssrl::BranchParams& p, bf16* y1, bf16* qkv, int M,
                   int D, cudaStream_t st) {
  launch_ln_fwd(x, p.ln_s, p.ln_b, y1, M, D, st);
  GemmArgs g{};
  g.A = y1; g.lda = D;
  g.B = p.wa; g.ldb = D;
  g.M = M; g.N = 3 * D; g.K = D;
  g.C = qkv; g.ldc = 3 * D;
  g.bias = p.ba;
  return ssrl::gemm(ssrl::GEMM_NT, EPI_BIAS_BF16, g, st);
}

}  // namespace

namespace ssrl {

// head dim <= 32 and L <= 256, the attention core's fit (ssrl::mha_fits)
bool attn_shape_ok(int B, int L, int D, int H) {
  if (B < 1 || L < 1 || D < 8 || D > 256 || H < 1 || D % H || D / H > 32) return false;
  return mha_fits(L, D / H);
}

size_t attn_fwd_workspace(int B, int L, int D, bool stash) {
  Carver c{nullptr};
  bf16 *y1, *qkv, *as;
  return fwd_carve(c, (size_t)B * L, D, stash, &y1, &qkv, &as);
}

cudaError_t attn_fwd(const bf16* x, const BranchParams& p, bf16* out, bf16* a,
                     void* ws, int B, int L, int D, int H, float scale,
                     cudaStream_t st) {
  if (!attn_shape_ok(B, L, D, H)) return cudaErrorInvalidValue;
  const int M = B * L;
  Carver c{static_cast<char*>(ws)};
  bf16 *y1, *qkv, *a_scratch;
  fwd_carve(c, M, D, a != nullptr, &y1, &qkv, &a_scratch);
  bf16* abuf = a ? a : a_scratch;

  SSRL_TRY(ln_qkv(x, p, y1, qkv, M, D, st));
  MhaArgs m = qkv_args(qkv, B, L, D, H, scale);
  m.o = abuf;
  cudaError_t e = mha_fwd(m, st);
  if (e != cudaSuccess) return e;

  GemmArgs o{};
  o.A = abuf; o.lda = D;
  o.B = p.wb; o.ldb = D;
  o.M = M; o.N = D; o.K = D;
  o.C = out; o.ldc = D;
  o.bias = p.bb;
  o.R = x;
  SSRL_TRY(ssrl::gemm(ssrl::GEMM_NT, EPI_BIAS_RESID, o, st));
  return cudaGetLastError();
}

size_t attn_bwd_workspace(int B, int L, int D) {
  Carver c{nullptr};
  bf16 *y1, *qkv, *da, *dqkv;
  float *dy1, *part, *tmp;
  return bwd_carve(c, B, L, D, &y1, &qkv, &da, &dqkv, &dy1, &part, &tmp);
}

cudaError_t attn_bwd(const bf16* x, const BranchParams& p, const bf16* a, GradIn gy,
                     GradOut dx, const BranchGrads& d, void* ws, int B, int L, int D,
                     int H, float scale, cudaStream_t st) {
  if (!attn_shape_ok(B, L, D, H)) return cudaErrorInvalidValue;
  const int M = B * L;
  const BwdPlan plan = bwd_plan(B, L, D);
  Carver c{static_cast<char*>(ws)};
  bf16 *y1, *qkv, *da, *dqkv;
  float *dy1, *part, *tmp;
  bwd_carve(c, B, L, D, &y1, &qkv, &da, &dqkv, &dy1, &part, &tmp);

  // recompute y1 = LN1(x) and qkv
  SSRL_TRY(ln_qkv(x, p, y1, qkv, M, D, st));

  // dWp = dy^T a (split over the B*L rows)
  GemmArgs w{};
  w.A = gy.op; w.lda = D;
  w.B = a; w.ldb = D;
  w.M = D; w.N = D; w.K = M;
  w.k_chunk = plan.k_wp;
  w.C = part; w.ldc = D; w.c_split = (long long)D * D;
  SSRL_TRY(ssrl::gemm(ssrl::GEMM_TN, EPI_F32, w, st));
  reduce_rows(part, cdiv(M, plan.k_wp), D * D, d.dwb, tmp, st);

  // da = bf16(dy @ Wp)
  GemmArgs g{};
  g.A = gy.op; g.lda = D;
  g.B = p.wb; g.ldb = D;
  g.M = M; g.N = D; g.K = D;
  g.C = da; g.ldc = D;
  SSRL_TRY(ssrl::gemm(ssrl::GEMM_NN, EPI_BF16, g, st));

  // attention backward -> dqkv (bf16) and dbqkv
  MhaArgs m = qkv_args(qkv, B, L, D, H, scale);
  m.dO = da;
  m.dq = dqkv;
  m.dk = dqkv + D;
  m.dv = dqkv + 2 * D;
  m.colpart = part;
  cudaError_t e = mha_bwd(m, st);
  if (e != cudaSuccess) return e;
  reduce_rows(part, B, 3 * D, d.dba, tmp, st);

  // dWqkv = dqkv^T y1
  GemmArgs wq{};
  wq.A = dqkv; wq.lda = 3 * D;
  wq.B = y1; wq.ldb = D;
  wq.M = 3 * D; wq.N = D; wq.K = M;
  wq.k_chunk = plan.k_wqkv;
  wq.C = part; wq.ldc = D; wq.c_split = (long long)3 * D * D;
  SSRL_TRY(ssrl::gemm(ssrl::GEMM_TN, EPI_F32, wq, st));
  reduce_rows(part, cdiv(M, plan.k_wqkv), 3 * D * D, d.dwa, tmp, st);

  // dy1 = dqkv @ Wqkv (f32)
  GemmArgs y{};
  y.A = dqkv; y.lda = 3 * D;
  y.B = p.wa; y.ldb = D;
  y.M = M; y.N = D; y.K = 3 * D;
  y.C = dy1; y.ldc = D;
  SSRL_TRY(ssrl::gemm(ssrl::GEMM_NN, EPI_F32, y, st));

  // dx = dy + LN1'(dy1); d ln_s, d ln_b and d bp = sum(dy)
  launch_ln_bwd(x, p.ln_s, dy1, gy.op, gy.f32, dx.bf, dx.f32, d.dln3, part, tmp, M,
                D, st);
  return cudaGetLastError();
}

}  // namespace ssrl

extern "C" {

long long ssrl_attn_branch_fwd_workspace(int B, int L, int D, int stash) {
  return (long long)ssrl::attn_fwd_workspace(B, L, D, stash != 0);
}

// x, out, a: [B*L][D] bf16; ln_s, ln_b: [D] f32; wqkv: [3D][D], bqkv: [3D],
// wp: [D][D], bp: [D] bf16 (torch Linear layout). `a` null: no stash.
int ssrl_attn_branch_fwd(const void* x, const void* ln_s, const void* ln_b,
                         const void* wqkv, const void* bqkv, const void* wp,
                         const void* bp, void* out, void* a, void* ws, int B,
                         int L, int D, int H, float scale, void* stream) {
  const void* p[6] = {ln_s, ln_b, wqkv, bqkv, wp, bp};
  return (int)ssrl::attn_fwd(static_cast<const bf16*>(x), ssrl::branch_params(p),
                             static_cast<bf16*>(out), static_cast<bf16*>(a), ws, B, L,
                             D, H, scale, static_cast<cudaStream_t>(stream));
}

long long ssrl_attn_branch_bwd_workspace(int B, int L, int D) {
  return (long long)ssrl::attn_bwd_workspace(B, L, D);
}

// Outputs (all written, none accumulated): dx [B*L][D] bf16; dln3 [3][D] f32
// = (d ln_s, d ln_b, d bp); dwqkv [3D][D], dbqkv [3D], dwp [D][D] f32.
int ssrl_attn_branch_bwd(const void* x, const void* ln_s, const void* ln_b,
                         const void* wqkv, const void* bqkv, const void* wp,
                         const void* a, const void* gy, void* dx, void* dln3,
                         void* dwqkv, void* dbqkv, void* dwp, void* ws, int B,
                         int L, int D, int H, float scale, void* stream) {
  const void* p[6] = {ln_s, ln_b, wqkv, bqkv, wp, nullptr};
  const ssrl::BranchGrads d{static_cast<float*>(dln3), static_cast<float*>(dwqkv),
                            static_cast<float*>(dbqkv), static_cast<float*>(dwp)};
  return (int)ssrl::attn_bwd(
      static_cast<const bf16*>(x), ssrl::branch_params(p), static_cast<const bf16*>(a),
      {static_cast<const bf16*>(gy), nullptr}, {static_cast<bf16*>(dx), nullptr}, d,
      ws, B, L, D, H, scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
