// Fused patch embed in f32 on Hopper (sm_90a): embed GEMM + CLS + position
// embedding + token gather, forward and backward.
//
//   out[b, k] = cls + pos[0]                          t == 0
//             = P[b, t-1] . W^T + bias + pos[t]       t >= 1
//   with t = idx[b, k] (or t = k when there is no index: K = L = N + 1).
//
// Replaces the f32 instantiation of the TPU kernels of
// ssrl_vit_mae_jepa_tpu/ops/embed_pallas.py: _fpe_fwd_impl (:185, call
// :209) and _fpe_vjp_bwd (:242, call :263), which cast by the patches' dtype
// (:192, :249), so that at f32 every rounding point is a no-op. The bf16
// kernel of the same functions is patch_embed.cu. Numerics: f32 operands and
// accumulation, no TF32; the CLS token folded into pos[0] in f32; an index
// outside [0, L) gives a NaN row and no gradient, as in patch_embed.cu. The
// plain version is ops/embed_fused.py::fused_patch_embed_ref at f32.
//
// What bounds it on the H100: each kept row does 2 Pc D operations (Pc = 192,
// D = 144) against 4 (Pc + D) bytes: ~41 operations a byte, above the card's
// f32 ridge of 67e12 / 3.35e12 = 20, so the product on the CUDA cores bounds
// it (no TF32 in the contract), ~0.02 ms a pass at the MAE's K = 37 and
// B = 768.
//
// What this design does about it: little, on purpose -- the first, simple
// version, right before fast. The bf16 kernel keeps the whole weight in
// shared memory; at f32 a 256 x 256 weight is 256 KB, more than the 227 KB a
// block can have, so every product here is tiled over its output columns: a
// 64 x 64 x 16 shared-memory SIMT tile (256 threads, 4 x 4 outputs each)
// whose row loader gathers each kept row's patch row by its token.
//   - Forward (pef_rows_kernel<PEF_FWD>): the epilogue adds the bias and the
//     token's position row, or writes the CLS row, straight from the
//     accumulators.
//   - Backward, dW | d(cls_pos)^T | db = dy^T [X | E | e] over the kept rows
//     (pef_dw_kernel): X holds each row's patch row (zero for the CLS token
//     and an index out of range), E its token as a one-hot row of L columns
//     and e a 1 for the tokens 1..L-1, as in patch_embed.cu, so the token
//     sums need no atomics and no inverse index; split over the rows into
//     f32 partials, then summed in split order (pef_fold_kernel).
//   - dpatches (optional): zeros, then each kept patch token's dy rows
//     summed in f32 in row order (pef_dsum_kernel, with an index) times W
//     (pef_rows_kernel<PEF_DP>), scattered to its patch row.
// Every sum has one fixed order: two calls give the same bits.
#include "common.cuh"

namespace {

constexpr int PE_MAX_L = 256;   // tokens
constexpr int PE_MAX_K = 1024;  // indices per image
constexpr int PE_MAX_W = 256;   // D and Pc
constexpr int TM = 64, TN = 64, TK = 16, THREADS = 256;
constexpr int DW_SPLITS = 64;   // row splits of the dW product, at most
constexpr int DW_MIN_ROWS = 256;  // rows a split, at least
static_assert(TM * TK == 4 * THREADS && TN * TK == 4 * THREADS, "four loads a thread");

bool shape_ok(int B, int N, int Pc, int D, int K, bool has_idx) {
  const long long rows = (long long)B * K;
  return B >= 1 && N >= 1 && N + 1 <= PE_MAX_L && K >= 1 && K <= PE_MAX_K &&
         (has_idx || K == N + 1) && Pc >= 8 && Pc % 8 == 0 && Pc <= PE_MAX_W && D >= 8 &&
         D % 8 == 0 && D <= PE_MAX_W && rows * PE_MAX_W < (1LL << 31) &&
         (long long)B * N * Pc < (1LL << 31);
}

// Which token each flat row r = b*K + k of the kept rows holds.
struct Rows {
  const long long* idx;  // (B, K) token indices, or null
  const int* map;        // (B*K) tokens with repeats as -1 (dpatches), or null
  int K, N, L;
};

__device__ __forceinline__ int row_token(const Rows& q, int r) {
  if (q.map) return q.map[r];
  if (q.idx) return (int)q.idx[r];
  return r % q.K;  // no index: token k of every image
}

// The patch row b*N + t - 1 that kept row r reads when it holds token t;
// -1 for the CLS token, a repeat or an index out of range (a zero row).
__device__ __forceinline__ long long patch_of(const Rows& q, int r, int t) {
  if (t < 1 || t >= q.L) return -1;
  return (long long)(r / q.K) * q.N + (t - 1);
}

// ---------------------------------------------------------------------------
// Row kernel: a 64-row x 64-column tile of (kept rows) x (output columns).
//   PEF_FWD  A = gathered patch rows (reduction Pc), B(c, n) = W[n][c]
//            (n over D); epilogue bias + pos / CLS -> out (B*K, D)
//   PEF_DP   A = combined dy rows (reduction D), B(d, n) = W[d][n] (n over
//            Pc); rows scattered to their patch row of dpatches
// Row tiles run along gridDim.x (up to 2^31 - 1), column tiles along y.
// ---------------------------------------------------------------------------
enum PefMode : int { PEF_FWD = 0, PEF_DP = 1 };

struct RowArgs {
  const float* src;   // PEF_FWD: patches [B*N][Pc]; PEF_DP: combined dy [B*K][D]
  const float* w;     // [D][Pc]
  int D, Pc, rows;    // rows = B*K
  Rows map;
  const float* bias;  // PEF_FWD: [D]
  const float* cls;   // PEF_FWD: [D]
  const float* pos;   // PEF_FWD: [L][D]
  float* out;         // PEF_FWD: [B*K][D]; PEF_DP: dpatches [B*N][Pc]
};

template <int MODE>
__global__ void __launch_bounds__(THREADS) pef_rows_kernel(const RowArgs p) {
  __shared__ __align__(16) float As[TK][TM + 4];
  __shared__ __align__(16) float Bs[TK][TN + 4];
  __shared__ long long src_row[TM];  // the A row each tile row reads, or -1
  __shared__ long long dst_row[TM];  // PEF_FWD: the output row; PEF_DP: the patch row
  __shared__ int tok[TM];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int kdim = MODE == PEF_FWD ? p.Pc : p.D;
  const int ncols = MODE == PEF_FWD ? p.D : p.Pc;
  if (tid < TM) {
    const int r = m0 + tid;
    int t = -1;
    long long s = -1, d = -1;
    if (r < p.rows) {
      t = row_token(p.map, r);
      const long long pr = patch_of(p.map, r, t);
      s = MODE == PEF_FWD ? pr : (pr >= 0 ? r : -1);
      d = MODE == PEF_FWD ? r : pr;
    }
    src_row[tid] = s;
    dst_row[tid] = d;
    tok[tid] = t;
  }
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kdim; k0 += TK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + THREADS * i;
      {  // A[row][k]: neighbouring threads on k
        const int r = idx / TK, kk = idx % TK, gk = k0 + kk;
        const long long s = src_row[r];
        As[kk][r] = (s >= 0 && gk < kdim) ? p.src[s * kdim + gk] : 0.f;
      }
      if (MODE == PEF_FWD) {  // B(c, n) = W[n][c]: neighbouring threads on c
        const int n = idx / TK, kk = idx % TK, gk = k0 + kk, gn = n0 + n;
        Bs[kk][n] = (gn < ncols && gk < kdim) ? p.w[(size_t)gn * p.Pc + gk] : 0.f;
      } else {  // B(d, n) = W[d][n]: neighbouring threads on n
        const int kk = idx / TN, n = idx % TN, gk = k0 + kk, gn = n0 + n;
        Bs[kk][n] = (gn < ncols && gk < kdim) ? p.w[(size_t)gk * p.Pc + gn] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rl = ty * 4 + i;
    const long long dst = dst_row[rl];
    if (dst < 0) continue;  // past the rows, or (PEF_DP) no patch row
    const int t = tok[rl];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= ncols) continue;
      float v = acc[i][j];
      if (MODE == PEF_FWD) {
        if (t < 0 || t >= p.map.L) v = __int_as_float(0x7fc00000);  // NaN
        else if (t == 0) v = p.cls[n] + p.pos[n];
        else v = (v + p.bias[n]) + p.pos[(size_t)t * p.D + n];
        p.out[dst * p.D + n] = v;
      } else {
        p.out[dst * p.Pc + n] = v;
      }
    }
  }
}

template <int MODE>
cudaError_t launch_rows(const RowArgs& p, cudaStream_t st) {
  const dim3 grid(cdiv(p.rows, TM), cdiv(MODE == PEF_FWD ? p.D : p.Pc, TN));
  pef_rows_kernel<MODE><<<grid, THREADS, 0, st>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dW | d(cls_pos)^T | db = dy^T [X | E | e] over the kept rows, split over
// the rows: C[d][n] over NC = Pc + L + 1 columns, one 64 x 64 tile of (d, n)
// a block, split z of the rows into part[z][D][NC].
// ---------------------------------------------------------------------------

struct DwArgs {
  const float* dy;       // [rows][D]
  const float* patches;  // [B*N][Pc]
  Rows map;              // each row's token (the index, or none)
  int rows, D, Pc, NC;
  int chunk;             // rows per split, a multiple of TK
  float* part;           // [splits][D][NC]
};

__global__ void __launch_bounds__(THREADS) pef_dw_kernel(const DwArgs p) {
  __shared__ __align__(16) float As[TK][TM + 4];  // dy rows: As[r][d]
  __shared__ __align__(16) float Bs[TK][TN + 4];  // [X | E | e] rows: Bs[r][n]
  __shared__ long long prow[TK];
  __shared__ int tok[TK];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * TN, d0 = blockIdx.y * TM;
  const int r0 = blockIdx.z * p.chunk, r1 = min(p.rows, r0 + p.chunk);
  const int L = p.map.L;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = r0; k0 < r1; k0 += TK) {
    if (tid < TK) {
      const int r = k0 + tid;
      const int t = r < r1 ? row_token(p.map, r) : -1;
      tok[tid] = r < r1 && t >= 0 && t < L ? t : -1;
      prow[tid] = r < r1 ? patch_of(p.map, r, t) : -1;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + THREADS * i;
      {  // neighbouring threads on d
        const int kk = idx / TM, d = idx % TM, r = k0 + kk, gd = d0 + d;
        As[kk][d] = (r < r1 && gd < p.D) ? p.dy[(size_t)r * p.D + gd] : 0.f;
      }
      {  // neighbouring threads on n
        const int kk = idx / TN, n = idx % TN, gn = n0 + n;
        const int t = tok[kk];
        float v = 0.f;
        if (gn < p.Pc) {
          const long long pr = prow[kk];
          v = pr >= 0 ? p.patches[pr * p.Pc + gn] : 0.f;
        } else if (gn < p.Pc + L) {
          v = t == gn - p.Pc ? 1.f : 0.f;
        } else if (gn == p.Pc + L) {
          v = t >= 1 ? 1.f : 0.f;
        }
        Bs[kk][n] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = p.part + (size_t)blockIdx.z * p.D * p.NC;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = d0 + ty * 4 + i;
    if (d >= p.D) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < p.NC) out[(size_t)d * p.NC + n] = acc[i][j];
    }
  }
}

// dw[d][c], dcp[t][d] and db[d] from the split partials, summed in split
// order
__global__ void pef_fold_kernel(const float* __restrict__ part, int S, int D, int Pc, int L,
                                float* __restrict__ dw, float* __restrict__ dcp,
                                float* __restrict__ db) {
  const int NC = Pc + L + 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= D * NC) return;
  const int d = i / NC, n = i - d * NC;
  float s = 0.f;
  for (int sp = 0; sp < S; ++sp) s += part[(size_t)sp * D * NC + i];
  if (n < Pc) dw[(size_t)d * Pc + n] = s;
  else if (n < Pc + L) dcp[(size_t)(n - Pc) * D + d] = s;
  else db[d] = s;
}

// dpatches with an index: one warp per kept row r of image b. The row counts
// when its token t is a patch (1 <= t < L) that no earlier row of b holds;
// then dsum[r] = the f32 sum, in row order, of b's dy rows that hold t, and
// map[r] = t, else map[r] = -1.
__global__ void pef_dsum_kernel(const float* __restrict__ dy, const long long* __restrict__ idx,
                                int rows, int K, int L, int D, float* __restrict__ dsum,
                                int* __restrict__ map) {
  const int r = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const int b = r / K, k = r - b * K;
  const long long* ib = idx + (size_t)b * K;
  const long long t = ib[k];
  bool first = t >= 1 && t < L;
  for (int j0 = 0; j0 < k && first; j0 += 32) {
    const int j = j0 + lane;
    if (__any_sync(0xffffffffu, j < k && ib[j] == t)) first = false;
  }
  if (lane == 0) map[r] = first ? (int)t : -1;
  if (!first) return;
  float acc[PE_MAX_W / 32] = {};
  for (int j0 = k; j0 < K; j0 += 32) {
    unsigned hits = __ballot_sync(0xffffffffu, j0 + lane < K && ib[j0 + lane] == t);
    while (hits) {
      const int j = j0 + __ffs(hits) - 1;
      hits &= hits - 1;
      const float* y = dy + ((size_t)b * K + j) * D;
#pragma unroll
      for (int e = 0; e < PE_MAX_W / 32; ++e) {
        const int c = lane + 32 * e;
        if (c < D) acc[e] += y[c];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < PE_MAX_W / 32; ++e) {
    const int c = lane + 32 * e;
    if (c < D) dsum[(size_t)r * D + c] = acc[e];
  }
}

struct BwdPlan {
  int splits, chunk;
};

BwdPlan bwd_plan(int rows) {
  BwdPlan p;
  int s = cdiv(rows, DW_MIN_ROWS);
  s = s < DW_SPLITS ? s : DW_SPLITS;
  s = s > 1 ? s : 1;
  p.chunk = cdiv(cdiv(rows, s), TK) * TK;
  p.splits = cdiv(rows, p.chunk);
  return p;
}

size_t bwd_carve(Carver& c, int B, int Pc, int D, int K, int L, bool has_idx, float** dsum,
                 int** map, float** part) {
  const BwdPlan p = bwd_plan(B * K);
  *part = c.take<float>((size_t)p.splits * D * (Pc + L + 1));
  *dsum = has_idx ? c.take<float>((size_t)B * K * D) : nullptr;
  *map = has_idx ? c.take<int>((size_t)B * K) : nullptr;
  return c.off;
}

}  // namespace

extern "C" {

// patches: [B][N][Pc] f32; w: [D][Pc] f32 (torch Linear layout); bias: [D]
// f32; cls: [D] f32; pos: [L][D] f32; idx: [B][K] int64 or null (K = L);
// out: [B][K][D] f32.
int ssrl_patch_embed_fwd_f32(const void* patches, const void* w, const void* bias,
                             const void* cls, const void* pos, const void* idx, void* out, int B,
                             int N, int Pc, int D, int K, void* stream) {
  if (!shape_ok(B, N, Pc, D, K, idx != nullptr)) return (int)cudaErrorInvalidValue;
  RowArgs p{};
  p.src = static_cast<const float*>(patches);
  p.w = static_cast<const float*>(w);
  p.D = D; p.Pc = Pc; p.rows = B * K;
  p.map = Rows{static_cast<const long long*>(idx), nullptr, K, N, N + 1};
  p.bias = static_cast<const float*>(bias);
  p.cls = static_cast<const float*>(cls);
  p.pos = static_cast<const float*>(pos);
  p.out = static_cast<float*>(out);
  return (int)launch_rows<PEF_FWD>(p, static_cast<cudaStream_t>(stream));
}

long long ssrl_patch_embed_bwd_f32_workspace(int B, int N, int Pc, int D, int K, int has_idx) {
  Carver c{nullptr};
  float *dsum, *part;
  int* map;
  return (long long)bwd_carve(c, B, Pc, D, K, N + 1, has_idx != 0, &dsum, &map, &part);
}

// dy: [B][K][D] f32. Outputs: dpatches [B][N][Pc] f32 (skipped when null);
// dw [D][Pc], db [D], dcp [L][D] f32 (d(cls_pos): dcls is row 0, dpos all).
int ssrl_patch_embed_bwd_f32(const void* patches, const void* w, const void* idx,
                             const void* dy, void* dpatches, void* dw, void* db, void* dcp,
                             void* ws, int B, int N, int Pc, int D, int K, void* stream) {
  const bool has_idx = idx != nullptr;
  if (!shape_ok(B, N, Pc, D, K, has_idx)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = N + 1, rows = B * K;
  const BwdPlan plan = bwd_plan(rows);
  Carver c{static_cast<char*>(ws)};
  float *dsum, *part;
  int* map;
  bwd_carve(c, B, Pc, D, K, L, has_idx, &dsum, &map, &part);
  const long long* idx64 = static_cast<const long long*>(idx);
  const float* dyf = static_cast<const float*>(dy);

  DwArgs a{};
  a.dy = dyf;
  a.patches = static_cast<const float*>(patches);
  a.map = Rows{idx64, nullptr, K, N, L};
  a.rows = rows; a.D = D; a.Pc = Pc; a.NC = Pc + L + 1;
  a.chunk = plan.chunk;
  a.part = part;
  pef_dw_kernel<<<dim3(cdiv(a.NC, TN), cdiv(D, TM), plan.splits), THREADS, 0, st>>>(a);
  SSRL_TRY(cudaGetLastError());
  pef_fold_kernel<<<cdiv((long long)D * a.NC, 256), 256, 0, st>>>(
      part, plan.splits, D, Pc, L, static_cast<float*>(dw), static_cast<float*>(dcp),
      static_cast<float*>(db));
  SSRL_TRY(cudaGetLastError());

  if (dpatches) {
    SSRL_TRY(cudaMemsetAsync(dpatches, 0, (size_t)B * N * Pc * sizeof(float), st));
    RowArgs d{};
    d.src = dyf;  // without an index every row is a distinct token
    d.map = Rows{nullptr, nullptr, K, N, L};
    if (has_idx) {
      pef_dsum_kernel<<<cdiv((long long)rows * 32, 256), 256, 0, st>>>(dyf, idx64, rows, K, L,
                                                                        D, dsum, map);
      SSRL_TRY(cudaGetLastError());
      d.src = dsum;
      d.map = Rows{nullptr, map, K, N, L};
    }
    d.w = static_cast<const float*>(w);
    d.D = D; d.Pc = Pc; d.rows = rows;
    d.out = static_cast<float*>(dpatches);
    SSRL_TRY(launch_rows<PEF_DP>(d, st));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
