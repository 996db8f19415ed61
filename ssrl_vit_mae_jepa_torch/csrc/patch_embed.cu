// Fused patch embed on Hopper (sm_90a): embed GEMM + CLS + position
// embedding + token gather, forward and backward.
//
//   out[b, k] = bf16(cls + pos[0])                                  t == 0
//             = bf16(bf16(P[b, t-1] . W^T + bf16(bias)) + bf16(pos[t]))  t >= 1
//   with t = idx[b, k] (or t = k when there is no index: K = L = N + 1).
//
// Replaces the TPU kernels of ssrl_vit_mae_jepa_tpu/ops/embed_pallas.py:
//   _fpe_fwd_impl (:185, call :209) and _fpe_vjp_bwd (:242, call :263).
//
// What bounds it on the H100: the GEMM has a reduction of Pc = 192 and an
// output width of D = 144, so each kept row does 2*Pc*D operations against
// 2*(Pc + D) bytes: ~170 operations per byte, under the card's ~295 ridge.
// It is bound by the bytes of the kept patch rows and of the output.
//
// What this design does about it: the TPU kernel embeds all N patches of an
// image in VMEM and gathers with a one-hot matmul; here the GEMM's A-tile
// loader gathers the kept patch rows straight from device memory (cp.async,
// 16 bytes a thread), so only the K kept rows are read and multiplied (at
// MAE's K=37 a quarter of the TPU kernel's GEMM), and the epilogue adds the
// bias, the position row of each token and the CLS row, rounding where the
// TPU kernel rounds (the CLS token folded into pos[0] in f32, then one
// rounding). Nothing but the (B, K, D) output is written.
//
// Backward, from dy (B, K, D):
//   - a combine pass sums the dy rows of each distinct token of an image in
//     f32 (row order; a repeated index sums, as the TPU kernel's one-hot
//     transpose does), writes the sum in bf16 at the token's first row and
//     zeros at its repeats, and accumulates d(cls_pos) (L, D) per group of
//     images in shared memory; a deterministic column reduction then gives
//     d(cls_pos) and db (its rows 1..L-1);
//   - dW (D, Pc) f32 = sum over kept rows of dsum^T . P[row], a split-K GEMM
//     whose B-tile loader gathers the patch rows, into f32 partials and a
//     deterministic column reduction (as the branch kernels' weight grads);
//   - dpatches (optional) = zeros, then dsum . W scattered to the kept rows.
// An index outside [0, L) gives NaN rows in the forward and no gradient.
#include "common.cuh"

namespace {

constexpr int PE_COLS = 32;     // columns per block of the combine pass
constexpr int PE_MAX_L = 256;   // tokens the combine pass holds in shared memory
constexpr int PE_MAX_K = 1024;  // indices per image the combine pass holds
constexpr int PE_GROUPS = 64;   // image groups of the combine pass (one reduce pass)
constexpr int PE_THREADS = 256;

bool shape_ok(int B, int N, int Pc, int D, int K, bool has_idx) {
  const long long rows = (long long)B * K;
  return B >= 1 && N >= 1 && N + 1 <= PE_MAX_L && K >= 1 && K <= PE_MAX_K &&
         (has_idx || K == N + 1) && Pc >= 8 && Pc % 8 == 0 && D >= 8 &&
         D % 8 == 0 && cdiv(rows, BM) <= 65535 && rows * (D > Pc ? D : Pc) < (1LL << 31);
}

// Which token each flat row r = b*K + k of the kept rows holds.
struct Rows {
  const long long* idx;  // (B, K) token indices, or null
  const int* map;        // (B*K) tokens with repeats as -1 (backward), or null
  int K, N, L;
};

__device__ __forceinline__ int row_token(const Rows& q, int r) {
  if (q.map) return q.map[r];
  if (q.idx) return (int)q.idx[r];
  return r % q.K;  // no index: token k of every image
}

// The patch row that kept row r reads, b*N + t - 1; -1 for the CLS token, a
// repeat or an index out of range (a zero row).
__device__ __forceinline__ long long patch_row(const Rows& q, int r) {
  const int t = row_token(q, r);
  if (t < 1 || t >= q.L) return -1;
  return (long long)(r / q.K) * q.N + (t - 1);
}

// rows x cols tile whose row i is kept row r0 + i (patch row patch_row(r0+i)
// of g, leading dimension gld); zero rows for -1 and past rmax, columns
// masked by cmax. Aligned in-bounds 16-byte chunks go by cp.async.
__device__ __forceinline__ void load_gathered(bf16* s, int sld, const bf16* g,
                                              int gld, const Rows& q, int rows,
                                              int cols, int r0, int c0,
                                              int rmax, int cmax) {
  const int cpr = cols / 8;
  const bool vec_ok =
      ((gld & 7) == 0) && ((reinterpret_cast<uintptr_t>(g) & 15) == 0);
  for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
    const int r = i / cpr;
    const int c = (i - r * cpr) * 8;
    const int gr = r0 + r, gc = c0 + c;
    const long long pr = gr < rmax ? patch_row(q, gr) : -1;
    bf16* dst = s + r * sld + c;
    if (pr >= 0 && vec_ok && gc + 8 <= cmax) {
      cp_async16(dst, g + pr * gld + gc);
      continue;
    }
    union {
      uint4 u;
      bf16 h[8];
    } v;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v.h[e] = (pr >= 0 && gc + e < cmax) ? g[pr * gld + gc + e]
                                          : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(dst) = v.u;
  }
}

// The three GEMMs, C[m][n] = sum_k A(m,k) B(k,n) on 64x64x32 WMMA tiles with
// a two-stage cp.async pipeline (the tile of common.cuh's gemm_kernel):
//   PE_FWD  m = kept row, n = d, k = c: A = gathered patch rows, B = W^T
//           (W (D, Pc) row-major); epilogue bias + pos/CLS -> out (B*K, D);
//   PE_DW   m = d, n = c, k = kept row: A = dsum^T, B = gathered patch rows;
//           f32 split-K partials (blockIdx.z) -> part;
//   PE_DP   m = kept row, n = c, k = d: A = dsum, B = W; rows scattered to
//           their patch row of dpatches.
enum PeMode : int { PE_FWD = 0, PE_DW = 1, PE_DP = 2 };

struct PeArgs {
  const bf16* A;
  const bf16* B;
  int lda, ldb;
  int M, N, K;
  int k_chunk;
  Rows rows;
  const bf16* bias;  // PE_FWD: [D]
  const float* cls;  // PE_FWD: [D]
  const float* pos;  // PE_FWD: [L][D]
  void* C;           // PE_FWD: out bf16; PE_DW: f32 partials; PE_DP: dpatches bf16
  int ldc;
};

template <int MODE>
__global__ void __launch_bounds__(GEMM_THREADS) pe_gemm_kernel(PeArgs p) {
  using namespace nvcuda;
  constexpr bool AT = MODE == PE_DW;
  constexpr bool BT = MODE == PE_FWD;
  constexpr int A_LD = AT ? BM + 8 : BK + 8;
  constexpr int B_LD = BT ? BK + 8 : BN + 8;
  constexpr int C_LD = BN + 4;
  __shared__ __align__(128) bf16 As[2][AT ? BK * (BM + 8) : BM * (BK + 8)];
  __shared__ __align__(128) bf16 Bs[2][BT ? BN * (BK + 8) : BK * (BN + 8)];
  __shared__ __align__(128) float Cs[BM * C_LD];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * p.k_chunk;
  const int ke = min(p.K, kb + p.k_chunk);
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;

  using LayoutA = typename std::conditional<AT, wmma::col_major, wmma::row_major>::type;
  using LayoutB = typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  auto load_stage = [&](int buf, int k0) {
    if (MODE == PE_FWD) {
      load_gathered(As[buf], A_LD, p.A, p.lda, p.rows, BM, BK, m0, k0, p.M, ke);
      load_tile(Bs[buf], B_LD, p.B, p.ldb, BN, BK, n0, k0, p.N, ke);
    } else if (MODE == PE_DW) {
      load_tile(As[buf], A_LD, p.A, p.lda, BK, BM, k0, m0, ke, p.M);
      load_gathered(Bs[buf], B_LD, p.B, p.ldb, p.rows, BK, BN, k0, n0, ke, p.N);
    } else {
      load_tile(As[buf], A_LD, p.A, p.lda, BM, BK, m0, k0, p.M, ke);
      load_tile(Bs[buf], B_LD, p.B, p.ldb, BK, BN, k0, n0, ke, p.N);
    }
  };
  if (kb < ke) load_stage(0, kb);
  cp_async_commit();
  int buf = 0;
  for (int k0 = kb; k0 < ke; k0 += BK, buf ^= 1) {
    if (k0 + BK < ke) load_stage(buf ^ 1, k0 + BK);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* Ab = As[buf];
    const bf16* Bb = Bs[buf];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int mo = wm * 32 + i * 16;
        wmma::load_matrix_sync(fa[i], AT ? Ab + kk * A_LD + mo : Ab + mo * A_LD + kk, A_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int no = wn * 32 + j * 16;
        wmma::load_matrix_sync(fb[j], BT ? Bb + no * B_LD + kk : Bb + kk * B_LD + no, B_LD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * BN; idx += GEMM_THREADS) {
    const int r = idx / BN, c = idx - (idx / BN) * BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= p.M || n >= p.N) continue;
    const float v = Cs[r * C_LD + c];
    if (MODE == PE_FWD) {
      const int t = row_token(p.rows, m);
      float o;
      if (t < 0 || t >= p.rows.L) o = __int_as_float(0x7fc00000);  // NaN
      else if (t == 0) o = p.cls[n] + p.pos[n];
      else o = rbf(v + bf(p.bias[n])) + rbf(p.pos[(size_t)t * p.N + n]);
      static_cast<bf16*>(p.C)[(size_t)m * p.ldc + n] = tobf(o);
    } else if (MODE == PE_DW) {
      static_cast<float*>(p.C)[(size_t)blockIdx.z * p.M * p.N + (size_t)m * p.ldc + n] = v;
    } else {
      const long long pr = patch_row(p.rows, m);
      if (pr >= 0) static_cast<bf16*>(p.C)[pr * p.ldc + n] = tobf(v);
    }
  }
}

template <int MODE>
void launch_pe_gemm(PeArgs p, int splits, cudaStream_t st) {
  if (splits <= 1) {
    splits = 1;
    p.k_chunk = cdiv(p.K, BK) * BK;
  }
  dim3 grid(cdiv(p.N, BN), cdiv(p.M, BM), splits);
  pe_gemm_kernel<MODE><<<grid, GEMM_THREADS, 0, st>>>(p);
}

// Combine pass. Block (column chunk, image group): for each image of the
// group, each distinct token's gradient is the f32 sum of the dy rows that
// hold it, in row order. It is added to the group's d(cls_pos) accumulator
// in shared memory and, with an index, written in bf16 to dsum at the
// token's first row (zeros at repeats), the token (or -1) to map.
__global__ void __launch_bounds__(PE_THREADS)
    pe_combine_kernel(const bf16* __restrict__ dy, const long long* __restrict__ idx,
                      int B, int K, int L, int D, int per_group,
                      bf16* __restrict__ dsum, int* __restrict__ map,
                      float* __restrict__ part) {
  __shared__ float acc[PE_MAX_L * PE_COLS];
  __shared__ int tok[PE_MAX_K];
  __shared__ int first[PE_MAX_K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int WARPS = PE_THREADS / 32;
  const int col = blockIdx.x * PE_COLS + lane;
  for (int i = threadIdx.x; i < L * PE_COLS; i += PE_THREADS) acc[i] = 0.f;
  const int b0 = blockIdx.y * per_group, b1 = min(B, b0 + per_group);
  for (int b = b0; b < b1; ++b) {
    __syncthreads();  // the previous image is done with tok, first and acc
    const size_t rb = (size_t)b * K;
    if (idx) {
      for (int k = threadIdx.x; k < K; k += PE_THREADS) tok[k] = (int)idx[rb + k];
      __syncthreads();
      for (int k = threadIdx.x; k < K; k += PE_THREADS) {
        const int t = tok[k];
        bool f = t >= 0 && t < L;
        for (int j = 0; j < k && f; ++j) f = tok[j] != t;
        first[k] = f;
        if (blockIdx.x == 0) map[rb + k] = f ? t : -1;
      }
      __syncthreads();
    }
    for (int k = warp; k < K; k += WARPS) {
      if (col >= D) continue;
      if (!idx) {  // token k, no repeats
        acc[k * PE_COLS + lane] += bf(dy[(rb + k) * D + col]);
        continue;
      }
      const int t = tok[k];
      float s = 0.f;
      if (first[k]) {
        for (int j = k; j < K; ++j)
          if (tok[j] == t) s += bf(dy[(rb + j) * D + col]);
        acc[t * PE_COLS + lane] += s;  // first rows hold distinct tokens
      }
      dsum[(rb + k) * D + col] = tobf(s);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L * PE_COLS; i += PE_THREADS) {
    const int t = i / PE_COLS, n = blockIdx.x * PE_COLS + (i - t * PE_COLS);
    if (n < D) part[((size_t)blockIdx.y * L + t) * D + n] = acc[i];
  }
}

struct BwdPlan {
  int per_group, groups, s_w, k_w;
  size_t part;
};

BwdPlan bwd_plan(int B, int Pc, int D, int K, int L) {
  BwdPlan p;
  p.per_group = cdiv(B, PE_GROUPS);
  p.groups = cdiv(B, p.per_group);
  p.k_w = splitk_chunk(cdiv(D, BM) * cdiv(Pc, BN), B * K, &p.s_w);
  const size_t a = (size_t)p.groups * L * D, w = (size_t)p.s_w * D * Pc;
  p.part = a > w ? a : w;
  return p;
}

size_t bwd_carve(Carver& c, int B, int Pc, int D, int K, int L, bool has_idx,
                 bf16** dsum, int** map, float** part, float** tmp) {
  const BwdPlan p = bwd_plan(B, Pc, D, K, L);
  *dsum = has_idx ? c.take<bf16>((size_t)B * K * D) : nullptr;
  *map = has_idx ? c.take<int>((size_t)B * K) : nullptr;
  *part = c.take<float>(p.part);
  // the group and split-K partials number <= 64 (one reduce pass, no tmp);
  // db sums L - 1 rows of d(cls_pos) and needs 64 * D
  *tmp = c.take<float>((size_t)64 * D);
  return c.off;
}

}  // namespace

extern "C" {

// patches: [B][N][Pc] bf16; w: [D][Pc] bf16 (torch Linear layout); bias: [D]
// bf16; cls: [D] f32; pos: [L][D] f32; idx: [B][K] int64 or null (K = L);
// out: [B][K][D] bf16.
int ssrl_patch_embed_fwd(const void* patches, const void* w, const void* bias,
                         const void* cls, const void* pos, const void* idx,
                         void* out, int B, int N, int Pc, int D, int K,
                         void* stream) {
  if (!shape_ok(B, N, Pc, D, K, idx != nullptr)) return (int)cudaErrorInvalidValue;
  PeArgs g{};
  g.A = static_cast<const bf16*>(patches); g.lda = Pc;
  g.B = static_cast<const bf16*>(w); g.ldb = Pc;
  g.M = B * K; g.N = D; g.K = Pc;
  g.rows = Rows{static_cast<const long long*>(idx), nullptr, K, N, N + 1};
  g.bias = static_cast<const bf16*>(bias);
  g.cls = static_cast<const float*>(cls);
  g.pos = static_cast<const float*>(pos);
  g.C = out; g.ldc = D;
  launch_pe_gemm<PE_FWD>(g, 1, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

long long ssrl_patch_embed_bwd_workspace(int B, int N, int Pc, int D, int K,
                                         int has_idx) {
  Carver c{nullptr};
  bf16* dsum;
  int* map;
  float *part, *tmp;
  return (long long)bwd_carve(c, B, Pc, D, K, N + 1, has_idx != 0, &dsum, &map,
                              &part, &tmp);
}

// dy: [B][K][D] bf16. Outputs: dpatches [B][N][Pc] bf16 (skipped when null);
// dw [D][Pc], db [D], dcp [L][D] f32 (d(cls_pos): dcls is row 0, dpos all).
int ssrl_patch_embed_bwd(const void* patches, const void* w, const void* idx,
                         const void* dy, void* dpatches, void* dw, void* db,
                         void* dcp, void* ws, int B, int N, int Pc, int D, int K,
                         void* stream) {
  const bool has_idx = idx != nullptr;
  if (!shape_ok(B, N, Pc, D, K, has_idx)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = N + 1;
  const BwdPlan plan = bwd_plan(B, Pc, D, K, L);
  Carver c{static_cast<char*>(ws)};
  bf16* dsum;
  int* map;
  float *part, *tmp;
  bwd_carve(c, B, Pc, D, K, L, has_idx, &dsum, &map, &part, &tmp);
  const long long* idx64 = static_cast<const long long*>(idx);
  const bf16* dyb = static_cast<const bf16*>(dy);
  float* dcpf = static_cast<float*>(dcp);

  pe_combine_kernel<<<dim3(cdiv(D, PE_COLS), plan.groups), PE_THREADS, 0, st>>>(
      dyb, idx64, B, K, L, D, plan.per_group, dsum, map, part);
  reduce_rows(part, plan.groups, L * D, dcpf, tmp, st);
  reduce_rows(dcpf + D, L - 1, D, static_cast<float*>(db), tmp, st);

  // the GEMMs read the combined rows; without an index every row is distinct
  const bf16* rows_a = has_idx ? dsum : dyb;
  const Rows rows{nullptr, map, K, N, L};

  PeArgs w2{};
  w2.A = rows_a; w2.lda = D;
  w2.B = static_cast<const bf16*>(patches); w2.ldb = Pc;
  w2.M = D; w2.N = Pc; w2.K = B * K;
  w2.k_chunk = plan.k_w;
  w2.rows = rows;
  w2.C = part; w2.ldc = Pc;
  launch_pe_gemm<PE_DW>(w2, plan.s_w, st);
  reduce_rows(part, plan.s_w, D * Pc, static_cast<float*>(dw), tmp, st);

  if (dpatches) {
    const cudaError_t e =
        cudaMemsetAsync(dpatches, 0, (size_t)B * N * Pc * sizeof(bf16), st);
    if (e != cudaSuccess) return (int)e;
    PeArgs d{};
    d.A = rows_a; d.lda = D;
    d.B = static_cast<const bf16*>(w); d.ldb = Pc;
    d.M = B * K; d.N = Pc; d.K = D;
    d.rows = rows;
    d.C = dpatches; d.ldc = Pc;
    launch_pe_gemm<PE_DP>(d, 1, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
