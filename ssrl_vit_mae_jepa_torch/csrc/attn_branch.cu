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
//
// Split over a model axis (Megatron; the JAX package's _TP_RULES,
// ssrl_vit_mae_jepa_tpu/parallel/mesh.py:61-65, applied to _ab_fwd and
// _ab_bwd): a rank holds the qkv rows and proj columns of H/mp heads, so
// LN runs at D while qkv, the attention and proj's K run at the shard's
// attention width Da = (H/mp) d. The partial forward ends in proj's f32 sum
// a Wp^T without bias or residual (ssrl_attn_branch_part_fwd); the caller
// all-reduces it over the model group and ssrl_branch_finish adds bias and
// residual at EPI_BIAS_RESID's rounding points, so the split block equals
// the whole one up to f32 summation order. The partial backward stops at
// the f32 dy1 = dqkv Wqkv of its heads (ssrl_attn_branch_part_bwd); after
// the all-reduce, ssrl_branch_ln_bwd runs the LN backward on the sum.
#include "common.cuh"
#include "branch.cuh"
#include "mha.cuh"

namespace {

// The attention core's view of the fused (B*L, 3Da) qkv buffer: q | k | v
// along the features, the attention output `a` and its gradient (B*L, Da);
// Da is the attention width, D itself or a model-axis shard's (H/mp) d.
ssrl::MhaArgs qkv_args(const bf16* qkv, int B, int L, int Da, int H, float scale) {
  ssrl::MhaArgs m{};
  m.q = qkv;
  m.k = qkv + Da;
  m.v = qkv + 2 * Da;
  m.in_b = (long long)L * 3 * Da; m.in_h = Da / H; m.in_r = 3 * Da;
  m.out_b = (long long)L * Da; m.out_h = Da / H; m.out_r = Da;
  m.B = B; m.H = H; m.L = L; m.d = Da / H;
  m.scale = scale;
  m.post = ssrl::kPreScaled;
  return m;
}

// Scratch of the forward: y1, qkv and, without a stash, the attention output.
size_t fwd_carve(Carver& c, size_t M, int D, int Da, bool stash, bf16** y1, bf16** qkv,
                 bf16** a_scratch) {
  *y1 = c.take<bf16>(M * D);
  *qkv = c.take<bf16>(M * 3 * Da);
  *a_scratch = stash ? nullptr : c.take<bf16>(M * Da);
  return c.off;
}

struct BwdPlan {
  int k_wp, k_wqkv;
  size_t part, tmp;
};

BwdPlan bwd_plan(int B, int L, int D, int Da) {
  BwdPlan p;
  const int M = B * L;
  int s_wp, s_wqkv;
  p.k_wp = ssrl::gemm_splitk(D, Da, M, &s_wp);
  p.k_wqkv = ssrl::gemm_splitk(3 * Da, D, M, &s_wqkv);
  size_t part = (size_t)s_wp * D * Da;
  const size_t cands[3] = {(size_t)B * 3 * Da, (size_t)s_wqkv * 3 * Da * D,
                           (size_t)ln_bwd_blocks(M) * 3 * D};
  for (size_t x : cands) part = x > part ? x : part;
  p.part = part;
  p.tmp = (size_t)64 * 3 * D;
  return p;
}

size_t bwd_carve(Carver& c, int B, int L, int D, int Da, bf16** y1, bf16** qkv, bf16** da,
                 bf16** dqkv, float** dy1, float** part, float** tmp) {
  const size_t M = (size_t)B * L;
  const BwdPlan p = bwd_plan(B, L, D, Da);
  *y1 = c.take<bf16>(M * D);
  *qkv = c.take<bf16>(M * 3 * Da);
  *da = c.take<bf16>(M * Da);
  *dqkv = c.take<bf16>(M * 3 * Da);
  *dy1 = c.take<float>(M * D);
  *part = c.take<float>(p.part);
  *tmp = c.take<float>(p.tmp);
  return c.off;
}

// y1 = LN1(x); qkv = bf16(y1 @ Wqkv^T + bqkv), Wqkv (3Da, D)
cudaError_t ln_qkv(const bf16* x, const ssrl::BranchParams& p, bf16* y1, bf16* qkv, int M,
                   int D, int Da, cudaStream_t st) {
  launch_ln_fwd(x, p.ln_s, p.ln_b, y1, M, D, st);
  GemmArgs g{};
  g.A = y1; g.lda = D;
  g.B = p.wa; g.ldb = D;
  g.M = M; g.N = 3 * Da; g.K = D;
  g.C = qkv; g.ldc = 3 * Da;
  g.bias = p.ba;
  return ssrl::gemm(ssrl::GEMM_NT, EPI_BIAS_BF16, g, st);
}

// D in [8, 256] (the LN kernels), Da = (heads) x (head dim <= 32), the
// attention core's fit (ssrl::mha_fits)
bool shape_ok(int B, int L, int D, int Da, int H) {
  if (B < 1 || L < 1 || D < 8 || D > 256 || H < 1 || Da < 1 || Da > D || Da % H ||
      Da / H > 32)
    return false;
  return ssrl::mha_fits(L, Da / H);
}

// The forward: out = x + bf16(a Wp^T + bp); or, with `part` set (a model-axis
// shard), only the f32 partial sum part = a Wp^T, Wp (D, Da).
cudaError_t fwd_seq(const bf16* x, const ssrl::BranchParams& p, bf16* out, float* part,
                    bf16* a, void* ws, int B, int L, int D, int Da, int H, float scale,
                    cudaStream_t st) {
  if (!shape_ok(B, L, D, Da, H)) return cudaErrorInvalidValue;
  const int M = B * L;
  Carver c{static_cast<char*>(ws)};
  bf16 *y1, *qkv, *a_scratch;
  fwd_carve(c, M, D, Da, a != nullptr, &y1, &qkv, &a_scratch);
  bf16* abuf = a ? a : a_scratch;

  SSRL_TRY(ln_qkv(x, p, y1, qkv, M, D, Da, st));
  ssrl::MhaArgs m = qkv_args(qkv, B, L, Da, H, scale);
  m.o = abuf;
  SSRL_TRY(ssrl::mha_fwd(m, st));

  GemmArgs o{};
  o.A = abuf; o.lda = Da;
  o.B = p.wb; o.ldb = Da;
  o.M = M; o.N = D; o.K = Da;
  o.ldc = D;
  if (part) {
    o.C = part;
    SSRL_TRY(ssrl::gemm(ssrl::GEMM_NT, EPI_F32, o, st));
  } else {
    o.C = out;
    o.bias = p.bb;
    o.R = x;
    SSRL_TRY(ssrl::gemm(ssrl::GEMM_NT, EPI_BIAS_RESID, o, st));
  }
  return cudaGetLastError();
}

// The backward; with `dy1_out` set (a model-axis shard) it stops at the f32
// dy1 = dqkv Wqkv of the shard's heads, written there, and leaves dx and
// d.dln3 to ssrl_branch_ln_bwd after the model-group all-reduce.
cudaError_t bwd_seq(const bf16* x, const ssrl::BranchParams& p, const bf16* a,
                    ssrl::GradIn gy, ssrl::GradOut dx, const ssrl::BranchGrads& d,
                    float* dy1_out, void* ws, int B, int L, int D, int Da, int H, float scale,
                    cudaStream_t st) {
  if (!shape_ok(B, L, D, Da, H)) return cudaErrorInvalidValue;
  const int M = B * L;
  const BwdPlan plan = bwd_plan(B, L, D, Da);
  Carver c{static_cast<char*>(ws)};
  bf16 *y1, *qkv, *da, *dqkv;
  float *dy1, *part, *tmp;
  bwd_carve(c, B, L, D, Da, &y1, &qkv, &da, &dqkv, &dy1, &part, &tmp);
  if (dy1_out) dy1 = dy1_out;

  // recompute y1 = LN1(x) and qkv
  SSRL_TRY(ln_qkv(x, p, y1, qkv, M, D, Da, st));

  // dWp = dy^T a (split over the B*L rows)
  GemmArgs w{};
  w.A = gy.op; w.lda = D;
  w.B = a; w.ldb = Da;
  w.M = D; w.N = Da; w.K = M;
  w.k_chunk = plan.k_wp;
  w.C = part; w.ldc = Da; w.c_split = (long long)D * Da;
  SSRL_TRY(ssrl::gemm(ssrl::GEMM_TN, EPI_F32, w, st));
  reduce_rows(part, cdiv(M, plan.k_wp), D * Da, d.dwb, tmp, st);

  // da = bf16(dy @ Wp)
  GemmArgs g{};
  g.A = gy.op; g.lda = D;
  g.B = p.wb; g.ldb = Da;
  g.M = M; g.N = Da; g.K = D;
  g.C = da; g.ldc = Da;
  SSRL_TRY(ssrl::gemm(ssrl::GEMM_NN, EPI_BF16, g, st));

  // attention backward -> dqkv (bf16) and dbqkv
  ssrl::MhaArgs m = qkv_args(qkv, B, L, Da, H, scale);
  m.dO = da;
  m.dq = dqkv;
  m.dk = dqkv + Da;
  m.dv = dqkv + 2 * Da;
  m.colpart = part;
  SSRL_TRY(ssrl::mha_bwd(m, st));
  reduce_rows(part, B, 3 * Da, d.dba, tmp, st);

  // dWqkv = dqkv^T y1
  GemmArgs wq{};
  wq.A = dqkv; wq.lda = 3 * Da;
  wq.B = y1; wq.ldb = D;
  wq.M = 3 * Da; wq.N = D; wq.K = M;
  wq.k_chunk = plan.k_wqkv;
  wq.C = part; wq.ldc = D; wq.c_split = (long long)3 * Da * D;
  SSRL_TRY(ssrl::gemm(ssrl::GEMM_TN, EPI_F32, wq, st));
  reduce_rows(part, cdiv(M, plan.k_wqkv), 3 * Da * D, d.dwa, tmp, st);

  // dy1 = dqkv @ Wqkv (f32)
  GemmArgs y{};
  y.A = dqkv; y.lda = 3 * Da;
  y.B = p.wa; y.ldb = D;
  y.M = M; y.N = D; y.K = 3 * Da;
  y.C = dy1; y.ldc = D;
  SSRL_TRY(ssrl::gemm(ssrl::GEMM_NN, EPI_F32, y, st));
  if (dy1_out) return cudaGetLastError();

  // dx = dy + LN1'(dy1); d ln_s, d ln_b and d bp = sum(dy)
  launch_ln_bwd(x, p.ln_s, dy1, gy.op, gy.f32, dx.bf, dx.f32, d.dln3, part, tmp, M,
                D, st);
  return cudaGetLastError();
}

// out = bf16(x + bf16(s + b)): EPI_BIAS_RESID's contract on the all-reduced
// f32 sum s of a row-parallel product (the branch outputs split over a
// model axis), b the output bias (D), 8 elements a thread.
__global__ void finish_kernel(const bf16* __restrict__ x, const float* __restrict__ s,
                              const bf16* __restrict__ b, bf16* __restrict__ out,
                              long long n8, int D) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n8;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * 8;
    const uint4 xv = *reinterpret_cast<const uint4*>(x + e);
    const float4 s0 = *reinterpret_cast<const float4*>(s + e);
    const float4 s1 = *reinterpret_cast<const float4*>(s + e + 4);
    const bf16* xs = reinterpret_cast<const bf16*>(&xv);
    const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const int c = (int)(e % D);
    uint4 ov;
    unsigned* op = reinterpret_cast<unsigned*>(&ov);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float lo = bf(xs[2 * j]) + rbf(sv[2 * j] + bf(b[c + 2 * j]));
      const float hi = bf(xs[2 * j + 1]) + rbf(sv[2 * j + 1] + bf(b[c + 2 * j + 1]));
      op[j] = pack_bf16(lo, hi);
    }
    *reinterpret_cast<uint4*>(out + e) = ov;
  }
}

}  // namespace

namespace ssrl {

// head dim <= 32 and L <= 256, the attention core's fit (ssrl::mha_fits)
bool attn_shape_ok(int B, int L, int D, int H) { return shape_ok(B, L, D, D, H); }

size_t attn_fwd_workspace(int B, int L, int D, bool stash) {
  Carver c{nullptr};
  bf16 *y1, *qkv, *as;
  return fwd_carve(c, (size_t)B * L, D, D, stash, &y1, &qkv, &as);
}

cudaError_t attn_fwd(const bf16* x, const BranchParams& p, bf16* out, bf16* a,
                     void* ws, int B, int L, int D, int H, float scale,
                     cudaStream_t st) {
  return fwd_seq(x, p, out, nullptr, a, ws, B, L, D, D, H, scale, st);
}

size_t attn_bwd_workspace(int B, int L, int D) {
  Carver c{nullptr};
  bf16 *y1, *qkv, *da, *dqkv;
  float *dy1, *part, *tmp;
  return bwd_carve(c, B, L, D, D, &y1, &qkv, &da, &dqkv, &dy1, &part, &tmp);
}

cudaError_t attn_bwd(const bf16* x, const BranchParams& p, const bf16* a, GradIn gy,
                     GradOut dx, const BranchGrads& d, void* ws, int B, int L, int D,
                     int H, float scale, cudaStream_t st) {
  return bwd_seq(x, p, a, gy, dx, d, nullptr, ws, B, L, D, D, H, scale, st);
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

// ---- split over a model axis: Da = (H/mp) d, the shard's attention width ----

long long ssrl_attn_branch_part_fwd_workspace(int B, int L, int D, int Da, int stash) {
  Carver c{nullptr};
  bf16 *y1, *qkv, *as;
  return (long long)fwd_carve(c, (size_t)B * L, D, Da, stash != 0, &y1, &qkv, &as);
}

// x [B*L][D] bf16; ln_s, ln_b [D] f32; wqkv [3Da][D], bqkv [3Da], wp [D][Da]
// bf16 (the shard's rows of qkv, columns of proj). Writes part [B*L][D] f32
// = a Wp^T and, where `a` is set, a [B*L][Da] bf16 (the stash).
int ssrl_attn_branch_part_fwd(const void* x, const void* ln_s, const void* ln_b,
                              const void* wqkv, const void* bqkv, const void* wp, void* part,
                              void* a, void* ws, int B, int L, int D, int Da, int H,
                              float scale, void* stream) {
  const void* p[6] = {ln_s, ln_b, wqkv, bqkv, wp, nullptr};
  if (Da % 8) return (int)cudaErrorInvalidValue;
  return (int)fwd_seq(static_cast<const bf16*>(x), ssrl::branch_params(p), nullptr,
                      static_cast<float*>(part), static_cast<bf16*>(a), ws, B, L, D, Da, H,
                      scale, static_cast<cudaStream_t>(stream));
}

long long ssrl_attn_branch_part_bwd_workspace(int B, int L, int D, int Da) {
  Carver c{nullptr};
  bf16 *y1, *qkv, *da, *dqkv;
  float *dy1, *part, *tmp;
  return (long long)bwd_carve(c, B, L, D, Da, &y1, &qkv, &da, &dqkv, &dy1, &part, &tmp);
}

// From x, the stash a [B*L][Da] and the bf16 output gradient gy [B*L][D]:
// dy1 [B*L][D] f32 (this shard's part of LN1's output gradient), dwqkv
// [3Da][D], dbqkv [3Da], dwp [D][Da] f32 (the shard's gradients).
int ssrl_attn_branch_part_bwd(const void* x, const void* ln_s, const void* ln_b,
                              const void* wqkv, const void* bqkv, const void* wp,
                              const void* a, const void* gy, void* dy1, void* dwqkv,
                              void* dbqkv, void* dwp, void* ws, int B, int L, int D, int Da,
                              int H, float scale, void* stream) {
  const void* p[6] = {ln_s, ln_b, wqkv, bqkv, wp, nullptr};
  if (Da % 8) return (int)cudaErrorInvalidValue;
  const ssrl::BranchGrads d{nullptr, static_cast<float*>(dwqkv), static_cast<float*>(dbqkv),
                            static_cast<float*>(dwp)};
  return (int)bwd_seq(static_cast<const bf16*>(x), ssrl::branch_params(p),
                      static_cast<const bf16*>(a), {static_cast<const bf16*>(gy), nullptr},
                      {nullptr, nullptr}, d, static_cast<float*>(dy1), ws, B, L, D, Da, H,
                      scale, static_cast<cudaStream_t>(stream));
}

// out = bf16(x + bf16(s + b)), x and out [M][D] bf16, s [M][D] f32, b [D]
// bf16; D a multiple of 8.
int ssrl_branch_finish(const void* x, const void* s, const void* b, void* out, int M, int D,
                       void* stream) {
  if (M < 1 || D < 8 || D % 8) return (int)cudaErrorInvalidValue;
  const long long n8 = (long long)M * D / 8;
  const int grid = (int)(n8 < 132LL * 16 * 256 ? cdiv(n8, 256) : 132 * 16);
  finish_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(s), static_cast<const bf16*>(b),
      static_cast<bf16*>(out), n8, D);
  return (int)cudaGetLastError();
}

long long ssrl_branch_ln_bwd_workspace(int M, int D) {
  Carver c{nullptr};
  c.take<float>((size_t)ln_bwd_blocks(M) * 3 * D);
  c.take<float>((size_t)64 * 3 * D);
  return (long long)c.off;
}

// dx = bf16(gy + LN'(dy)) from x [M][D] bf16, the f32 dy (the all-reduced
// LN output gradient) and the bf16 branch output gradient gy; dln3 [3][D]
// f32 = (d ln_s, d ln_b, sum gy): the LN backward of the branch kernels.
int ssrl_branch_ln_bwd(const void* x, const void* ln_s, const void* dy, const void* gy,
                       void* dx, void* dln3, void* ws, int M, int D, void* stream) {
  if (M < 1 || D < 1 || D > 256) return (int)cudaErrorInvalidValue;
  Carver c{static_cast<char*>(ws)};
  float* part = c.take<float>((size_t)ln_bwd_blocks(M) * 3 * D);
  float* tmp = c.take<float>((size_t)64 * 3 * D);
  launch_ln_bwd(static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
                static_cast<const float*>(dy), static_cast<const bf16*>(gy), nullptr,
                static_cast<bf16*>(dx), nullptr, static_cast<float*>(dln3), part, tmp, M, D,
                static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

}  // extern "C"
