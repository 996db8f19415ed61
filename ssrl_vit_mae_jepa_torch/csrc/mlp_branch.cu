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
// at best, at or below the ridge, and in practice bound by the small 64x64
// WMMA tiles of this first version and by the launch count.
//
// What this design does about it: LayerNorm in its own warp-per-row pass,
// then two tiled WMMA GEMMs whose epilogues carry everything elementwise --
// bias + bf16 rounding + exact-erf GELU after fc1, bias + bf16 rounding +
// residual after fc2 -- so z and h are each written once in bf16 and nothing
// is written in f32 on the forward. The backward recomputes LN2, fc1 and the
// GELU (as the TPU kernel does) and folds gelu'(z) and the f32 column sums
// for db1 into the dh GEMM's epilogue; weight gradients use split-K GEMMs
// into f32 partials and a deterministic column reduction.
//
// Numerics contract: LN statistics in f32 (two-pass, eps 1e-6); y2 in bf16;
// z rounded to bf16 before the exact-erf GELU; h in bf16; the fc2 output
// rounded to bf16 before the residual add. db1 is summed from the f32 dz and
// dW1 uses the bf16-rounded dz; every weight and bias gradient is f32.
#include "common.cuh"

namespace {

bool shape_ok(int M, int D, int F) {
  return M >= 1 && D >= 8 && D <= 256 && F >= 8 && D % 8 == 0 && F % 8 == 0;
}

size_t fwd_carve(Carver& c, size_t M, int D, int F, bf16** y2, bf16** h) {
  *y2 = c.take<bf16>(M * D);
  *h = c.take<bf16>(M * F);
  return c.off;
}

struct BwdPlan {
  int s_w2, k_w2, s_w1, k_w1;
  size_t part, tmp;
};

BwdPlan bwd_plan(int M, int D, int F) {
  BwdPlan p;
  p.k_w2 = splitk_chunk(cdiv(D, BM) * cdiv(F, BN), M, &p.s_w2);
  p.k_w1 = splitk_chunk(cdiv(F, BM) * cdiv(D, BN), M, &p.s_w1);
  size_t part = (size_t)p.s_w2 * D * F;
  const size_t cands[3] = {(size_t)p.s_w1 * F * D, (size_t)cdiv(M, BM) * F,
                           (size_t)ln_bwd_blocks(M) * 3 * D};
  for (size_t x : cands) part = x > part ? x : part;
  p.part = part;
  p.tmp = (size_t)64 * (F > 3 * D ? F : 3 * D);
  return p;
}

size_t bwd_carve(Carver& c, int M, int D, int F, bf16** y2, bf16** z, bf16** h,
                 bf16** dz, float** dy2, float** part, float** tmp) {
  const BwdPlan p = bwd_plan(M, D, F);
  *y2 = c.take<bf16>((size_t)M * D);
  *z = c.take<bf16>((size_t)M * F);
  *h = c.take<bf16>((size_t)M * F);
  *dz = c.take<bf16>((size_t)M * F);
  *dy2 = c.take<float>((size_t)M * D);
  *part = c.take<float>(p.part);
  *tmp = c.take<float>(p.tmp);
  return c.off;
}

// y2 = LN2(x); h = bf16(gelu(z)), z = bf16(y2 @ W1^T + b1) (stored if zout)
void fc1_gelu(const bf16* x, const float* s, const float* b, const bf16* w1,
              const bf16* b1, bf16* y2, bf16* h, bf16* zout, int M, int D, int F,
              cudaStream_t st) {
  launch_ln_fwd(x, s, b, y2, M, D, st);
  GemmArgs g{};
  g.A = y2; g.lda = D;
  g.B = w1; g.ldb = D;
  g.M = M; g.N = F; g.K = D;
  g.C = h; g.ldc = F;
  g.bias = b1;
  g.Zout = zout;
  launch_gemm<false, true, EPI_BIAS_GELU>(g, 1, st);
}

}  // namespace

extern "C" {

long long ssrl_mlp_branch_fwd_workspace(int M, int D, int F) {
  Carver c{nullptr};
  bf16 *y2, *h;
  return (long long)fwd_carve(c, M, D, F, &y2, &h);
}

// x, out: [M][D] bf16; ln_s, ln_b: [D] f32; w1: [F][D], b1: [F], w2: [D][F],
// b2: [D] bf16 (torch Linear layout).
int ssrl_mlp_branch_fwd(const void* x, const void* ln_s, const void* ln_b,
                        const void* w1, const void* b1, const void* w2,
                        const void* b2, void* out, void* ws, int M, int D, int F,
                        void* stream) {
  if (!shape_ok(M, D, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Carver c{static_cast<char*>(ws)};
  bf16 *y2, *h;
  fwd_carve(c, M, D, F, &y2, &h);
  const bf16* xb = static_cast<const bf16*>(x);
  fc1_gelu(xb, static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
           static_cast<const bf16*>(w1), static_cast<const bf16*>(b1), y2, h,
           nullptr, M, D, F, st);
  GemmArgs g{};
  g.A = h; g.lda = F;
  g.B = static_cast<const bf16*>(w2); g.ldb = F;
  g.M = M; g.N = D; g.K = F;
  g.C = out; g.ldc = D;
  g.bias = static_cast<const bf16*>(b2);
  g.R = xb;
  launch_gemm<false, true, EPI_BIAS_RESID>(g, 1, st);
  return (int)cudaGetLastError();
}

long long ssrl_mlp_branch_bwd_workspace(int M, int D, int F) {
  Carver c{nullptr};
  bf16 *y2, *z, *h, *dz;
  float *dy2, *part, *tmp;
  return (long long)bwd_carve(c, M, D, F, &y2, &z, &h, &dz, &dy2, &part, &tmp);
}

// Outputs (all written): dx [M][D] bf16; dln3 [3][D] f32 = (d ln_s, d ln_b,
// d b2); dw1 [F][D], db1 [F], dw2 [D][F] f32.
int ssrl_mlp_branch_bwd(const void* x, const void* ln_s, const void* ln_b,
                        const void* w1, const void* b1, const void* w2,
                        const void* gy, void* dx, void* dln3, void* dw1,
                        void* db1, void* dw2, void* ws, int M, int D, int F,
                        void* stream) {
  if (!shape_ok(M, D, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdPlan plan = bwd_plan(M, D, F);
  Carver c{static_cast<char*>(ws)};
  bf16 *y2, *z, *h, *dz;
  float *dy2, *part, *tmp;
  bwd_carve(c, M, D, F, &y2, &z, &h, &dz, &dy2, &part, &tmp);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gyb = static_cast<const bf16*>(gy);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* w2b = static_cast<const bf16*>(w2);

  fc1_gelu(xb, static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
           w1b, static_cast<const bf16*>(b1), y2, h, z, M, D, F, st);

  // dW2 = dy^T h
  GemmArgs w{};
  w.A = gyb; w.lda = D;
  w.B = h; w.ldb = F;
  w.M = D; w.N = F; w.K = M;
  w.k_chunk = plan.k_w2;
  w.C = part; w.ldc = F; w.c_split = (long long)D * F;
  launch_gemm<true, false, EPI_F32>(w, plan.s_w2, st);
  reduce_rows(part, plan.s_w2, D * F, static_cast<float*>(dw2), tmp, st);

  // dz = (dy @ W2) * gelu'(z), bf16; db1 from the f32 dz
  GemmArgs g{};
  g.A = gyb; g.lda = D;
  g.B = w2b; g.ldb = F;
  g.M = M; g.N = F; g.K = D;
  g.C = dz; g.ldc = F;
  g.Zin = z;
  g.colpart = part;
  launch_gemm<false, false, EPI_GELU_BWD>(g, 1, st);
  reduce_rows(part, cdiv(M, BM), F, static_cast<float*>(db1), tmp, st);

  // dW1 = dz^T y2
  GemmArgs w1g{};
  w1g.A = dz; w1g.lda = F;
  w1g.B = y2; w1g.ldb = D;
  w1g.M = F; w1g.N = D; w1g.K = M;
  w1g.k_chunk = plan.k_w1;
  w1g.C = part; w1g.ldc = D; w1g.c_split = (long long)F * D;
  launch_gemm<true, false, EPI_F32>(w1g, plan.s_w1, st);
  reduce_rows(part, plan.s_w1, F * D, static_cast<float*>(dw1), tmp, st);

  // dy2 = dz @ W1 (f32)
  GemmArgs y{};
  y.A = dz; y.lda = F;
  y.B = w1b; y.ldb = D;
  y.M = M; y.N = D; y.K = F;
  y.C = dy2; y.ldc = D;
  launch_gemm<false, false, EPI_F32>(y, 1, st);

  launch_ln_bwd(xb, static_cast<const float*>(ln_s), dy2, gyb,
                static_cast<bf16*>(dx), static_cast<float*>(dln3), part, tmp, M, D,
                st);
  return (int)cudaGetLastError();
}

const char* ssrl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
