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
// widths; it is bound by the memory traffic of its intermediates and by the
// launch count, not by the tensor cores. The MLP half's F-wide
// intermediates cost the most: as split products z (f32 here, 4F bytes a
// row), h and dz each went to device memory and back.
//
// What this design does about it: the attention half runs the attention
// branch's launches (LN1, the wgmma + TMA products of csrc/gemm_sm90.cuh,
// the attention core of csrc/mha.cu); the MLP half is one kernel each way
// (csrc/block_mlp.cu), LN2, fc1, the GELU and fc2 (and in the backward z
// again, dh, dz and dy2 with the LN2 backward) on chip, so z never reaches
// device memory. The backward recomputes y1 = LN1(x) and qkv once and keeps
// them for the attention backward, which the branch's own sequence
// (csrc/attn_branch.cu) would recompute a second time. x_mid, a and dx_mid
// (f32 with its bf16 form) go through device memory between the halves.
#include "common.cuh"
#include "branch.cuh"
#include "mha.cuh"

namespace {

size_t max2(size_t a, size_t b) { return a > b ? a : b; }

// x_mid, and the attention forward's scratch (the MLP half needs none).
size_t fwd_carve(Carver& c, int B, int L, int D, bf16** mid, char** scratch) {
  *mid = c.take<bf16>((size_t)B * L * D);
  *scratch = c.take<char>(ssrl::attn_fwd_workspace(B, L, D, false));
  return c.off;
}

// The attention backward's plan: split-K chunks of dWp and dWqkv and the
// partials they, dbqkv and the LN1 backward need (attn_branch.cu's, Da = D).
struct AttnPlan {
  int k_wp, k_wqkv;
  size_t part, tmp;
};

AttnPlan attn_plan(int B, int L, int D) {
  AttnPlan p;
  const int M = B * L;
  int s_wp, s_wqkv;
  p.k_wp = ssrl::gemm_splitk(D, D, M, &s_wp);
  p.k_wqkv = ssrl::gemm_splitk(3 * D, D, M, &s_wqkv);
  size_t part = (size_t)s_wp * D * D;
  const size_t cands[3] = {(size_t)B * 3 * D, (size_t)s_wqkv * 3 * D * D,
                           ln_bwd_part_floats(M, D)};
  for (size_t x : cands) part = x > part ? x : part;
  p.part = part;
  p.tmp = (size_t)64 * 3 * D;
  return p;
}

// The attention backward's buffers, carved from the scratch the MLP half's
// backward used before it.
struct AttnBufs {
  bf16 *da, *dqkv;
  float *dy1, *part, *tmp;
};

size_t attn_carve(Carver& c, int B, int L, int D, AttnBufs* b) {
  const size_t M = (size_t)B * L;
  const AttnPlan p = attn_plan(B, L, D);
  b->da = c.take<bf16>(M * D);
  b->dqkv = c.take<bf16>(M * 3 * D);
  b->dy1 = c.take<float>(M * D);
  b->part = c.take<float>(p.part);
  b->tmp = c.take<float>(p.tmp);
  return c.off;
}

// Kept from the recomputed forward: y1, qkv, a and x_mid; dx_mid in f32 and
// bf16; one scratch region for the MLP half's backward, then the
// attention's.
struct BwdBufs {
  bf16 *y1, *qkv, *a, *mid, *gmid;
  float* gmid32;
  char* scratch;
};

size_t bwd_carve(Carver& c, int B, int L, int D, int F, BwdBufs* b) {
  const size_t M = (size_t)B * L;
  b->y1 = c.take<bf16>(M * D);
  b->qkv = c.take<bf16>(M * 3 * D);
  b->a = c.take<bf16>(M * D);
  b->mid = c.take<bf16>(M * D);
  b->gmid = c.take<bf16>(M * D);
  b->gmid32 = c.take<float>(M * D);
  Carver attn{nullptr};
  AttnBufs unused;
  b->scratch = c.take<char>(
      max2(ssrl::mlp_half_bwd_workspace((int)M, D, F), attn_carve(attn, B, L, D, &unused)));
  return c.off;
}

// The attention core's view of the fused (B*L, 3D) qkv buffer.
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

// The attention half's forward, y1 and qkv kept: x_mid = x + bf16(a Wp^T +
// bp), the launches of attn_branch.cu's forward.
cudaError_t attn_fwd_kept(const bf16* x, const ssrl::BranchParams& p, const BwdBufs& k, int B,
                          int L, int D, int H, float scale, cudaStream_t st) {
  const int M = B * L;
  launch_ln_fwd(x, p.ln_s, p.ln_b, k.y1, M, D, st);
  GemmArgs q{};
  q.A = k.y1; q.lda = D;
  q.B = p.wa; q.ldb = D;
  q.M = M; q.N = 3 * D; q.K = D;
  q.C = k.qkv; q.ldc = 3 * D;
  q.bias = p.ba;
  SSRL_TRY(ssrl::gemm(ssrl::GEMM_NT, EPI_BIAS_BF16, q, st));
  ssrl::MhaArgs m = qkv_args(k.qkv, B, L, D, H, scale);
  m.o = k.a;
  SSRL_TRY(ssrl::mha_fwd(m, st));
  GemmArgs o{};
  o.A = k.a; o.lda = D;
  o.B = p.wb; o.ldb = D;
  o.M = M; o.N = D; o.K = D;
  o.C = k.mid; o.ldc = D;
  o.bias = p.bb;
  o.R = x;
  return ssrl::gemm(ssrl::GEMM_NT, EPI_BIAS_RESID, o, st);
}

// The attention half's backward from the kept y1, qkv and a, and the f32
// dx_mid with its bf16 form: attn_branch.cu's backward without its
// recompute of LN1 and qkv; dx rounded once.
cudaError_t attn_bwd_kept(const bf16* x, const ssrl::BranchParams& p, const BwdBufs& k,
                          bf16* dx, const ssrl::BranchGrads& d, int B, int L, int D, int H,
                          float scale, cudaStream_t st) {
  const int M = B * L;
  const AttnPlan plan = attn_plan(B, L, D);
  Carver c{k.scratch};
  AttnBufs b;
  attn_carve(c, B, L, D, &b);

  // dWp = dx_mid^T a (split over the B*L rows)
  GemmArgs w{};
  w.A = k.gmid; w.lda = D;
  w.B = k.a; w.ldb = D;
  w.M = D; w.N = D; w.K = M;
  w.k_chunk = plan.k_wp;
  w.C = b.part; w.ldc = D; w.c_split = (long long)D * D;
  SSRL_TRY(ssrl::gemm(ssrl::GEMM_TN, EPI_F32, w, st));
  reduce_rows(b.part, cdiv(M, plan.k_wp), D * D, d.dwb, b.tmp, st);

  // da = bf16(dx_mid @ Wp)
  GemmArgs g{};
  g.A = k.gmid; g.lda = D;
  g.B = p.wb; g.ldb = D;
  g.M = M; g.N = D; g.K = D;
  g.C = b.da; g.ldc = D;
  SSRL_TRY(ssrl::gemm(ssrl::GEMM_NN, EPI_BF16, g, st));

  // attention backward -> dqkv (bf16) and dbqkv
  ssrl::MhaArgs m = qkv_args(k.qkv, B, L, D, H, scale);
  m.dO = b.da;
  m.dq = b.dqkv;
  m.dk = b.dqkv + D;
  m.dv = b.dqkv + 2 * D;
  m.colpart = b.part;
  SSRL_TRY(ssrl::mha_bwd(m, st));
  reduce_rows(b.part, B, 3 * D, d.dba, b.tmp, st);

  // dWqkv = dqkv^T y1
  GemmArgs wq{};
  wq.A = b.dqkv; wq.lda = 3 * D;
  wq.B = k.y1; wq.ldb = D;
  wq.M = 3 * D; wq.N = D; wq.K = M;
  wq.k_chunk = plan.k_wqkv;
  wq.C = b.part; wq.ldc = D; wq.c_split = (long long)3 * D * D;
  SSRL_TRY(ssrl::gemm(ssrl::GEMM_TN, EPI_F32, wq, st));
  reduce_rows(b.part, cdiv(M, plan.k_wqkv), 3 * D * D, d.dwa, b.tmp, st);

  // dy1 = dqkv @ Wqkv (f32)
  GemmArgs y{};
  y.A = b.dqkv; y.lda = 3 * D;
  y.B = p.wa; y.ldb = D;
  y.M = M; y.N = D; y.K = 3 * D;
  y.C = b.dy1; y.ldc = D;
  SSRL_TRY(ssrl::gemm(ssrl::GEMM_NN, EPI_F32, y, st));

  // dx = dx_mid + LN1'(dy1); d ln_s, d ln_b and d bp = sum(dx_mid), f32
  launch_ln_bwd(x, p.ln_s, b.dy1, k.gmid, k.gmid32, dx, nullptr, d.dln3, b.part, b.tmp, M, D,
                st);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

long long ssrl_fused_block_fwd_workspace(int B, int L, int D, int F) {
  (void)F;
  Carver c{nullptr};
  bf16* mid;
  char* scratch;
  return (long long)fwd_carve(c, B, L, D, &mid, &scratch);
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
  fwd_carve(c, B, L, D, &mid, &scratch);
  cudaError_t e = ssrl::attn_fwd(static_cast<const bf16*>(x), ssrl::branch_params(params),
                                 mid, nullptr, scratch, B, L, D, H, scale, st);
  if (e != cudaSuccess) return (int)e;
  return (int)ssrl::mlp_half_fwd(mid, ssrl::branch_params(params + 6), static_cast<bf16*>(out),
                                 B * L, D, F, false, st);
}

long long ssrl_fused_block_bwd_workspace(int B, int L, int D, int F) {
  Carver c{nullptr};
  BwdBufs b;
  return (long long)bwd_carve(c, B, L, D, F, &b);
}

// g, dx: [B*L][D] bf16; grads: the block's f32 gradients in the packed layout
// of ssrl::block_grads, all written.
int ssrl_fused_block_bwd(const void* x, const void* const* params, const void* g,
                         void* dx, void* grads, void* ws, int B, int L, int D, int H,
                         int F, float scale, void* stream) {
  if (!ssrl::block_shape_ok(B, L, D, H, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Carver c{static_cast<char*>(ws)};
  BwdBufs k;
  bwd_carve(c, B, L, D, F, &k);
  ssrl::BranchGrads da, dm;
  ssrl::block_grads(static_cast<float*>(grads), D, F, &da, &dm);
  const bf16* xb = static_cast<const bf16*>(x);
  const ssrl::BranchParams pa = ssrl::branch_params(params);

  // recompute y1, qkv, a and x_mid: LN1 and the qkv product once a call
  cudaError_t e = attn_fwd_kept(xb, pa, k, B, L, D, H, scale, st);
  if (e != cudaSuccess) return (int)e;
  // MLP half: dx_mid = g + its input gradient, in f32 and bf16
  e = ssrl::mlp_half_bwd(k.mid, ssrl::branch_params(params + 6),
                         {static_cast<const bf16*>(g), nullptr}, {k.gmid, k.gmid32}, dm,
                         k.scratch, B * L, D, F, false, st);
  if (e != cudaSuccess) return (int)e;
  // attention half from the f32 dx_mid and the kept y1, qkv; dx rounded once
  return (int)attn_bwd_kept(xb, pa, k, static_cast<bf16*>(dx), da, B, L, D, H, scale, st);
}

}  // extern "C"
