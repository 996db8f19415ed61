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
// accumulation on the CUDA cores, no TF32; the CLS token folded into pos[0]
// in f32; an index outside [0, L) gives a NaN row and no gradient, repeated
// indices sum their gradients, as in patch_embed.cu. The plain version is
// ops/embed_fused.py::fused_patch_embed_ref at f32.
//
// What bounds it on the H100: each kept row does 2 Pc D operations (Pc = 192,
// D = 144) against 4 (Pc + D) bytes: ~41 operations a byte, above the card's
// f32 ridge of 67e12 / 3.35e12 = 20, so the products on the CUDA cores bound
// it (no TF32 in the contract), ~0.02 ms a pass at the MAE's K = 37 and
// B = 768. A SIMT product reaches that rate only with few shared-memory
// loads and instructions per FMA and enough loads in flight.
//
// What this design does about it: every product is a register-tiled SIMT
// product (8 x 2 outputs a thread forward, 8 x 8 for dW), both operands
// brought in 16-byte cp.async chunks into a double-buffered ring.
//   - Forward (pef_fwd_kernel): a block takes 32 kept rows and every one of
//     the D output columns (2 D threads): thread (rg, cg) holds rows rg +
//     4 i (i < 8) and columns cg and cg + D / 2. Each 32-deep step stages
//     the rows' gathered patch rows (by token; zero for CLS and an index out
//     of range) and W's 32 columns; the row loads of a warp are broadcasts,
//     its weight loads consecutive rows of an odd number of 16-byte units.
//     The epilogue adds the bias and the token's position row, or writes the
//     CLS row, straight from the accumulators. W comes from L2 for every row
//     tile. Small blocks won on the H100: 8 x 2 outputs a thread in 32-row
//     blocks ran 16% faster at K = 37 than 8 x 8 in 128-row blocks (one
//     block per SM at 168 registers, the last wave of blocks part empty).
//   - dW = dy^T X over the kept rows alone (pef_dw_kernel): split into
//     DW_SPLITS row ranges, a block per split holding all of D x Pc (D / 8
//     x Pc / 8 threads of 8 x 8, more column tiles above 512 threads), 16
//     rows a step; each step's gather reads a ring of row tables whose index
//     entries were loaded two steps ahead. The f32 partials are summed in
//     split order (pef_fold_kernel).
//   - d(cls_pos) and db as ordered token sums of dy rows, not product
//     columns (one-hot product columns would add 76% to the product's
//     work): the first column tile's blocks add each staged dy row to its
//     token's row of an [L][D] accumulator in shared memory after the
//     step's products (thread d owns column d, rows in order, repeated
//     indices summed, an index out of range skipped), written once per split
//     and summed in split order beside dW; db is the column sums of
//     d(cls_pos) over tokens 1..L-1 (colsum_kernel, one fixed order). Where
//     [L][D] does not fit beside the stages the accumulator is the split's
//     zeroed slice of the partials in device memory. The sums cost the
//     product ~28% at K = 37 on the H100; a separate kernel, one more warp
//     for them, or more owners a column each cost more.
//   - dpatches (optional, off the main path, as before): zeros, then each
//     kept patch token's dy rows summed in f32 in row order (pef_dsum_kernel,
//     with an index) times W (pef_dp_kernel), scattered to its patch row.
// Every sum has one fixed order and nothing is atomic: two calls give the
// same bits.
#include "common.cuh"

namespace {

constexpr int PE_MAX_L = 256;   // tokens
constexpr int PE_MAX_K = 1024;  // indices per image
constexpr int PE_MAX_W = 256;   // D and Pc
// forward: 4 row groups of 8 rows (32 rows) a block, 2 columns a thread
// (2 D threads); 32-deep steps, shared rows of 36 floats (9 16-byte units,
// odd)
constexpr int FRG = 4, FCT = 2, FBM = 8 * FRG, FK = 32, FLD = FK + 4;
// dW: 16 rows a step, at most 512 threads a block, DW_SPLITS row ranges
constexpr int WK = 16, W_THREADS = 512, DW_SPLITS = 128, DW_MIN_ROWS = 64;
// dpatches: a 64 x 64 x 16 tile, 4 x 4 a thread
constexpr int TM = 64, TN = 64, TK = 16, THREADS = 256;
static_assert(TM * TK == 4 * THREADS && TN * TK == 4 * THREADS, "four loads a thread");

bool shape_ok(int B, int N, int Pc, int D, int K, bool has_idx) {
  const long long rows = (long long)B * K;
  return B >= 1 && N >= 1 && N + 1 <= PE_MAX_L && K >= 1 && K <= PE_MAX_K &&
         (has_idx || K == N + 1) && Pc >= 8 && Pc % 8 == 0 && Pc <= PE_MAX_W && D >= 8 &&
         D % 8 == 0 && D <= PE_MAX_W && rows * PE_MAX_W < (1LL << 31) &&
         (long long)B * N * Pc < (1LL << 31) && (long long)B * PE_MAX_L < (1LL << 31);
}

// Which token each flat row r = b*K + k of the kept rows holds.
struct Rows {
  const long long* idx;  // (B, K) token indices, or null
  const int* map;        // (B*K) tokens with repeats as -1 (dpatches), or null
  int K, N, L;
};

// dpatches' rows: the token map, or without an index token k of every image
__device__ __forceinline__ int row_token(const Rows& q, int r) {
  return q.map ? q.map[r] : r % q.K;
}

// The patch row b*N + t - 1 that kept row r reads when it holds token t;
// -1 for the CLS token, a repeat or an index out of range (a zero row).
__device__ __forceinline__ long long patch_of(const Rows& q, int r, int t) {
  if (t < 1 || t >= q.L) return -1;
  return (long long)(r / q.K) * q.N + (t - 1);
}

__device__ __forceinline__ void zero16(float* p) {
  *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// ---------------------------------------------------------------------------
// Forward: out (B*K, D) = gathered patch rows . W^T, bias, position rows.
// ---------------------------------------------------------------------------

struct FwdArgs {
  const float* patches;  // [B*N][Pc]
  const float* w;        // [D][Pc]
  const float* bias;     // [D]
  const float* cls;      // [D]
  const float* pos;      // [L][D]
  Rows map;
  int D, Pc, rows;
  float* out;            // [B*K][D]
};

size_t fwd_smem(int D) { return sizeof(float) * 2 * (size_t)(FBM + D) * FLD; }

// The patch row kept row r reads (-1 for none: CLS, an index out of range,
// r >= r1), from its index entry `raw` (loaded ahead, so that the load's
// latency overlaps other work).
__device__ __forceinline__ long long raw_token(const Rows& q, int r, int r1) {
  return r < r1 && q.idx ? q.idx[r] : 0;
}
__device__ __forceinline__ int token_of(const Rows& q, int r, int r1, long long raw) {
  if (r >= r1) return -1;
  return q.idx ? (raw < 0 || raw >= q.L ? -1 : (int)raw) : r % q.K;
}
__device__ __forceinline__ int patch_row(const Rows& q, int r, int r1, long long raw) {
  return (int)patch_of(q, r, token_of(q, r, r1, raw));
}

// Stage a step of k0: the tile's gathered patch rows (As, by the block's
// table prow) and W's columns k0 .. k0 + FK (Ws), zero past Pc and where a
// row has no patch.
__device__ __forceinline__ void fwd_stage_rows(const FwdArgs& p, float* As, const int* prow,
                                               int BM, int k0) {
  constexpr int CPR = FK / 4;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < BM * CPR; i += blockDim.x) {
    const int m = i / CPR, c = (i - m * CPR) * 4;
    float* dst = As + m * FLD + c;
    if (prow[m] >= 0 && k0 + c < p.Pc)
      cp_async16(dst, p.patches + (size_t)prow[m] * p.Pc + k0 + c);
    else zero16(dst);
  }
}
__device__ __forceinline__ void fwd_stage_w(const FwdArgs& p, float* Ws, int k0) {
  constexpr int CPR = FK / 4;
  for (int i = threadIdx.x; i < p.D * CPR; i += blockDim.x) {
    const int n = i / CPR, c = (i - n * CPR) * 4;
    float* dst = Ws + n * FLD + c;
    if (k0 + c < p.Pc) cp_async16(dst, p.w + (size_t)n * p.Pc + k0 + c);
    else zero16(dst);
  }
}

// FRG row groups and D / FCT column groups: thread (rg, cg) holds rows rg +
// FRG i and columns cg + (D / FCT) j, i < 8, j < FCT
__global__ void __launch_bounds__(FRG * PE_MAX_W / FCT) pef_fwd_kernel(const FwdArgs p) {
  extern __shared__ __align__(16) float sm[];
  const int D = p.D, nd = D / FCT;
  const int rg = threadIdx.x / nd, cg = threadIdx.x - (threadIdx.x / nd) * nd;
  const int m0 = blockIdx.x * FBM;
  const int buf = (FBM + D) * FLD;  // floats of one stage: rows, then W's columns
  __shared__ int prow[FBM];          // each row's patch row, or -1
  __shared__ int tok[FBM];           // its token, -1 out of range
  fwd_stage_w(p, sm + FBM * FLD, 0);  // W does not wait for the row table
  for (int m = threadIdx.x; m < FBM; m += blockDim.x) {
    const int r = m0 + m;
    const long long raw = raw_token(p.map, r, p.rows);
    prow[m] = patch_row(p.map, r, p.rows, raw);
    tok[m] = !p.map.idx ? r % p.map.K : raw < 0 || raw >= p.map.L ? -1 : (int)raw;
  }
  __syncthreads();
  float acc[8][FCT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < FCT; ++j) acc[i][j] = 0.f;

  const int steps = (p.Pc + FK - 1) / FK;
  fwd_stage_rows(p, sm, prow, FBM, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      float* nb = sm + ((s + 1) & 1) * buf;
      fwd_stage_rows(p, nb, prow, FBM, (s + 1) * FK);
      fwd_stage_w(p, nb + FBM * FLD, (s + 1) * FK);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* A = sm + (s & 1) * buf + rg * FLD;
    const float* W = sm + (s & 1) * buf + (FBM + cg) * FLD;
#pragma unroll 1
    for (int k = 0; k < FK; k += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(A + FRG * i * FLD + k);
#pragma unroll
      for (int j = 0; j < FCT; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(W + nd * j * FLD + k);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v = fmaf(a[i].x, b.x, acc[i][j]);
          v = fmaf(a[i].y, b.y, v);
          v = fmaf(a[i].z, b.z, v);
          acc[i][j] = fmaf(a[i].w, b.w, v);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + rg + FRG * i;
    if (r >= p.rows) continue;
    const int t = tok[rg + FRG * i];
    float* o = p.out + (size_t)r * D;
#pragma unroll
    for (int j = 0; j < FCT; ++j) {
      const int n = cg + nd * j;
      float v;
      if (t < 0) v = __int_as_float(0x7fc00000);  // NaN
      else if (t == 0) v = p.cls[n] + p.pos[n];
      else v = (acc[i][j] + p.bias[n]) + p.pos[(size_t)t * D + n];
      o[n] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// dW = dy^T X over the kept rows, split over the rows: part[z][D][Pc].
// ---------------------------------------------------------------------------

struct DwArgs {
  const float* dy;       // [rows][D]
  const float* patches;  // [B*N][Pc]
  Rows map;
  int rows, D, Pc;
  int ct;                // columns of a block's tile (a multiple of 8)
  int chunk;             // rows a split, a multiple of WK
  float* part;           // [splits][D][Pc]
  int L;
  float* tpart;          // [splits][L][D]: the token sums' partials
};

__host__ __device__ inline size_t dw_stage_floats(int D, int ct) { return 2 * (size_t)WK * (D + ct); }
// with the token sums' [L][D] accumulator when it fits beside the stages
size_t dw_smem(int D, int ct, int L, bool tok_shared) {
  return sizeof(float) * (dw_stage_floats(D, ct) + (tok_shared ? (size_t)L * D : 0));
}
// (1 KB is left for the kernel's static shared memory)
bool dw_tok_shared(int D, int ct, int L) { return dw_smem(D, ct, L, true) <= 232448 - 1024; }

// (column tile width, its tiles): all of Pc in one tile unless D / 8 x Pc / 8
// threads exceed W_THREADS
void dw_tiles(int D, int Pc, int* ct, int* tiles) {
  const int cg = Pc / 8;
  *tiles = cdiv((long long)(D / 8) * cg, W_THREADS);
  *ct = 8 * cdiv(cg, *tiles);
  *tiles = cdiv(Pc, *ct);
}

__device__ __forceinline__ void dw_stage(const DwArgs& p, float* Ys, float* Xs, const int* prow,
                                         int r0, int r1, int c0) {
  const int ycpr = p.D / 4, xcpr = p.ct / 4;
  for (int i = threadIdx.x; i < WK * ycpr; i += blockDim.x) {
    const int k = i / ycpr, c = (i - k * ycpr) * 4, r = r0 + k;
    float* dst = Ys + k * p.D + c;
    if (r < r1) cp_async16(dst, p.dy + (size_t)r * p.D + c);
    else zero16(dst);
  }
  for (int i = threadIdx.x; i < WK * xcpr; i += blockDim.x) {
    const int k = i / xcpr, c = (i - k * xcpr) * 4;
    float* dst = Xs + k * p.ct + c;
    if (prow[k] >= 0 && c0 + c < p.Pc)
      cp_async16(dst, p.patches + (size_t)prow[k] * p.Pc + c0 + c);
    else zero16(dst);
  }
}

// D / 8 x ct / 8 threads of 8 x 8; TS: the token sums in shared memory
template <bool TS>
__global__ void __launch_bounds__(W_THREADS) pef_dw_kernel(const DwArgs p) {
  extern __shared__ __align__(16) float sm[];
  const int ncg = p.ct / 8;
  const int dg = threadIdx.x / ncg, cg = threadIdx.x - (threadIdx.x / ncg) * ncg;
  const int c0 = blockIdx.x * p.ct, half = p.ct / 2;
  const int r0 = blockIdx.y * p.chunk, r1 = min(p.rows, r0 + p.chunk);
  float* Ys[2] = {sm, sm + WK * (p.D + p.ct)};
  float* Xs[2] = {Ys[0] + WK * p.D, Ys[1] + WK * p.D};
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // the patch rows and tokens of steps s, s + 1, s + 2 in a ring: step s +
  // 2's index entries are loaded before step s's products and stored after
  __shared__ int prow[3][WK], trow[3][WK];
  const int steps = (r1 - r0 + WK - 1) / WK;
  for (int i = threadIdx.x; i < 2 * WK; i += blockDim.x) {
    const long long raw = raw_token(p.map, r0 + i, r1);
    prow[i / WK][i % WK] = patch_row(p.map, r0 + i, r1, raw);
    trow[i / WK][i % WK] = token_of(p.map, r0 + i, r1, raw);
  }
  // the first column tile's blocks also sum this split's dy rows by token,
  // in row order, each thread its columns d: tacc[t][d]
  const bool toks = blockIdx.x == 0;
  float* tacc = TS ? sm + dw_stage_floats(p.D, p.ct) : p.tpart + (size_t)blockIdx.y * p.L * p.D;
  if (toks && TS)
    for (int i = threadIdx.x; i < p.L * p.D; i += blockDim.x) tacc[i] = 0.f;
  __syncthreads();
  if (steps > 0) dw_stage(p, Ys[0], Xs[0], prow[0], r0, r1, c0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps)
      dw_stage(p, Ys[(s + 1) & 1], Xs[(s + 1) & 1], prow[(s + 1) % 3], r0 + (s + 1) * WK, r1, c0);
    const int ra = r0 + (s + 2) * WK + threadIdx.x;
    const long long raw = threadIdx.x < WK ? raw_token(p.map, ra, r1) : 0;
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Y = Ys[s & 1] + dg * 8;
    const float* X = Xs[s & 1] + cg * 4;
#pragma unroll 4
    for (int k = 0; k < WK; ++k) {
      const float4 y0 = *reinterpret_cast<const float4*>(Y + k * p.D);
      const float4 y1 = *reinterpret_cast<const float4*>(Y + k * p.D + 4);
      const float4 x0 = *reinterpret_cast<const float4*>(X + k * p.ct);
      const float4 x1 = *reinterpret_cast<const float4*>(X + k * p.ct + half);
      const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(yv[i], xv[j], acc[i][j]);
    }
    if (toks) {  // the step's staged dy rows, in row order
      const float* Yk = Ys[s & 1];
      for (int d = threadIdx.x; d < p.D; d += blockDim.x) {
        float y[WK];  // loaded before the chain of updates
#pragma unroll
        for (int k = 0; k < WK; ++k) y[k] = Yk[k * p.D + d];
#pragma unroll
        for (int k = 0; k < WK; ++k) {
          const int t = trow[s % 3][k];
          if (t >= 0) tacc[t * p.D + d] += y[k];
        }
      }
    }
    for (int i = threadIdx.x; i < WK; i += blockDim.x) {  // one pass unless blockDim < WK
      const int r = r0 + (s + 2) * WK + i;
      const long long rw = i == threadIdx.x ? raw : raw_token(p.map, r, r1);
      prow[(s + 2) % 3][i] = patch_row(p.map, r, r1, rw);
      trow[(s + 2) % 3][i] = token_of(p.map, r, r1, rw);
    }
    __syncthreads();
  }

  if (toks && TS) {  // the last step's barrier has passed
    float* dst = p.tpart + (size_t)blockIdx.y * p.L * p.D;
    for (int i = threadIdx.x; i < p.L * p.D; i += blockDim.x) dst[i] = tacc[i];
  }
  float* out = p.part + (size_t)blockIdx.y * p.D * p.Pc;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = out + (size_t)(dg * 8 + i) * p.Pc + c0 + cg * 4;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (c0 + cg * 4 + h * half < p.Pc)
        *reinterpret_cast<float4*>(row + h * half) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  }
}

// dw[d][c] = sum over the dW partials, dcp[t][d] over the token partials,
// each in split order
__global__ void pef_fold_kernel(const float* __restrict__ part, int nw,
                                const float* __restrict__ tpart, int nt, int S,
                                float* __restrict__ dw, float* __restrict__ dcp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool w = i < nw;
  if (i >= nw + nt) return;
  const float* src = w ? part + i : tpart + (i - nw);
  const size_t stride = w ? nw : nt;
  float s = 0.f;
#pragma unroll 8
  for (int z = 0; z < S; ++z) s += src[z * stride];  // the loads run ahead of the adds
  (w ? dw : dcp)[w ? i : i - nw] = s;
}

// ---------------------------------------------------------------------------
// dpatches: a 64-row x 64-column tile of (kept rows) x (Pc columns), A =
// combined dy rows (reduction D), B(d, n) = W[d][n]; rows scattered to
// their patch row. Row tiles along gridDim.x, column tiles along y.
// ---------------------------------------------------------------------------

struct DpArgs {
  const float* src;  // combined dy [B*K][D]
  const float* w;    // [D][Pc]
  int D, Pc, rows;
  Rows map;
  float* out;        // dpatches [B*N][Pc]
};

__global__ void __launch_bounds__(THREADS) pef_dp_kernel(const DpArgs p) {
  __shared__ __align__(16) float As[TK][TM + 4];
  __shared__ __align__(16) float Bs[TK][TN + 4];
  __shared__ long long src_row[TM];  // the A row each tile row reads, or -1
  __shared__ long long dst_row[TM];  // the patch row
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  if (tid < TM) {
    const int r = m0 + tid;
    long long s = -1, d = -1;
    if (r < p.rows) {
      const long long pr = patch_of(p.map, r, row_token(p.map, r));
      s = pr >= 0 ? r : -1;
      d = pr;
    }
    src_row[tid] = s;
    dst_row[tid] = d;
  }
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.D; k0 += TK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + THREADS * i;
      {  // A[row][k]: neighbouring threads on k
        const int r = idx / TK, kk = idx % TK, gk = k0 + kk;
        const long long s = src_row[r];
        As[kk][r] = (s >= 0 && gk < p.D) ? p.src[s * p.D + gk] : 0.f;
      }
      {  // B(d, n) = W[d][n]: neighbouring threads on n
        const int kk = idx / TN, n = idx % TN, gk = k0 + kk, gn = n0 + n;
        Bs[kk][n] = (gn < p.Pc && gk < p.D) ? p.w[(size_t)gk * p.Pc + gn] : 0.f;
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
    const long long dst = dst_row[ty * 4 + i];
    if (dst < 0) continue;  // past the rows, or no patch row
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < p.Pc) p.out[dst * p.Pc + n] = acc[i][j];
    }
  }
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

// ---------------------------------------------------------------------------
// The backward's plan and workspace
// ---------------------------------------------------------------------------

struct BwdPlan {
  int splits, chunk;  // dW and token-sum row ranges
  int ct, tiles;      // dW column tile width, tiles
};

BwdPlan bwd_plan(int B, int K, int Pc, int D) {
  BwdPlan p;
  const int rows = B * K;
  int s = cdiv(rows, DW_MIN_ROWS);
  s = s < DW_SPLITS ? s : DW_SPLITS;
  p.chunk = cdiv(cdiv(rows, s), WK) * WK;
  p.splits = cdiv(rows, p.chunk);
  dw_tiles(D, Pc, &p.ct, &p.tiles);
  return p;
}

struct BwdWork {
  float *part, *tpart, *dsum;
  int* map;
};

size_t bwd_carve(Carver& c, int B, int N, int Pc, int D, int K, bool has_idx, BwdWork* w) {
  const int L = N + 1;
  const BwdPlan p = bwd_plan(B, K, Pc, D);
  w->part = c.take<float>((size_t)p.splits * D * Pc);
  w->tpart = c.take<float>((size_t)p.splits * L * D);
  w->dsum = has_idx ? c.take<float>((size_t)B * K * D) : nullptr;
  w->map = has_idx ? c.take<int>((size_t)B * K) : nullptr;
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
  FwdArgs p{};
  p.patches = static_cast<const float*>(patches);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.cls = static_cast<const float*>(cls);
  p.pos = static_cast<const float*>(pos);
  p.map = Rows{static_cast<const long long*>(idx), nullptr, K, N, N + 1};
  p.D = D; p.Pc = Pc; p.rows = B * K;
  p.out = static_cast<float*>(out);
  const size_t smem = fwd_smem(D);
  SSRL_TRY(cudaFuncSetAttribute(pef_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem));
  pef_fwd_kernel<<<cdiv(p.rows, FBM), FRG * (D / FCT), smem,
                   static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

long long ssrl_patch_embed_bwd_f32_workspace(int B, int N, int Pc, int D, int K, int has_idx) {
  Carver c{nullptr};
  BwdWork w;
  return (long long)bwd_carve(c, B, N, Pc, D, K, has_idx != 0, &w);
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
  const BwdPlan plan = bwd_plan(B, K, Pc, D);
  Carver c{static_cast<char*>(ws)};
  BwdWork wk;
  bwd_carve(c, B, N, Pc, D, K, has_idx, &wk);
  const long long* idx64 = static_cast<const long long*>(idx);
  const float* dyf = static_cast<const float*>(dy);
  float* dcpf = static_cast<float*>(dcp);

  DwArgs a{};
  a.dy = dyf;
  a.patches = static_cast<const float*>(patches);
  a.map = Rows{idx64, nullptr, K, N, L};
  a.rows = rows; a.D = D; a.Pc = Pc;
  a.ct = plan.ct;
  a.chunk = plan.chunk;
  a.part = wk.part;
  a.L = L;
  a.tpart = wk.tpart;
  const bool tok_shared = dw_tok_shared(D, plan.ct, L);
  if (!tok_shared)  // the token sums accumulate in tpart itself
    SSRL_TRY(cudaMemsetAsync(wk.tpart, 0, (size_t)plan.splits * L * D * sizeof(float), st));
  const size_t smem = dw_smem(D, plan.ct, L, tok_shared);
  const auto kernel = tok_shared ? pef_dw_kernel<true> : pef_dw_kernel<false>;
  SSRL_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  kernel<<<dim3(plan.tiles, plan.splits), (D / 8) * (plan.ct / 8), smem, st>>>(a);
  SSRL_TRY(cudaGetLastError());
  const int nw = D * Pc, nt = L * D;
  pef_fold_kernel<<<cdiv(nw + nt, 256), 256, 0, st>>>(wk.part, nw, wk.tpart, nt, plan.splits,
                                                      static_cast<float*>(dw), dcpf);
  SSRL_TRY(cudaGetLastError());
  // db: the sums over tokens 1..L-1 of d(cls_pos), one block per 32 columns
  colsum_kernel<<<cdiv(D, 32), 256, 0, st>>>(dcpf + D, L - 1, D, L - 1 > 0 ? L - 1 : 1,
                                             static_cast<float*>(db));
  SSRL_TRY(cudaGetLastError());

  if (dpatches) {
    SSRL_TRY(cudaMemsetAsync(dpatches, 0, (size_t)B * N * Pc * sizeof(float), st));
    DpArgs d{};
    d.src = dyf;  // without an index every row is a distinct token
    d.map = Rows{nullptr, nullptr, K, N, L};
    if (has_idx) {
      pef_dsum_kernel<<<cdiv((long long)rows * 32, 256), 256, 0, st>>>(dyf, idx64, rows, K, L,
                                                                        D, wk.dsum, wk.map);
      SSRL_TRY(cudaGetLastError());
      d.src = wk.dsum;
      d.map = Rows{nullptr, wk.map, K, N, L};
    }
    d.w = static_cast<const float*>(w);
    d.D = D; d.Pc = Pc; d.rows = rows;
    d.out = static_cast<float*>(dpatches);
    pef_dp_kernel<<<dim3(cdiv(rows, TM), cdiv(Pc, TN)), THREADS, 0, st>>>(d);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
