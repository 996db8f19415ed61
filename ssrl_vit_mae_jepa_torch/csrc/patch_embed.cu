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
// Its floor is the bytes of the kept patch rows and of the output (19 MB
// at the MAE's K = 37, 5.7 us); at that size it waits on latency rather
// than bandwidth (a gathered row arrives a memory round trip after it is
// asked for), so the warps in flight per SM set its time.
//
// Forward (pe_rows_kernel<PE_FWD>): a persistent grid of 8-warp blocks, each
// of which loads W (D x Pc bf16, 55 KB) into shared memory once and then
// walks over tiles of 64 kept rows. A tile's patch rows are gathered from
// device memory by cp.async (16 bytes a thread, each row read exactly once)
// while the previous tile computes; a warp multiplies 16 rows by half of the
// D columns with mma.sync.m16n8k16 (ldmatrix fragments, f32 accumulators in
// registers) and the epilogue adds the bias, the position row of each token
// or the CLS row, rounding where the TPU kernel rounds (the CLS token folded
// into pos[0] in f32, then one rounding), straight from the accumulators.
// An index outside [0, L) gives a NaN row. W and two row tiles take 109 KB,
// two blocks per SM; splitting the columns over two warps doubled the warps
// per SM (8 to 16) and took the forward from 0.055 ms to 0.035 at K = 37
// (H100 80GB HBM3, 700 W).
//
// Backward, from dy (B, K, D), in two launches:
//   - pe_dw_kernel: one split-K product over the kept rows, dy^T [X | E | e],
//     where X holds each row's patch row (zero for the CLS token and for an
//     index out of range), E its token as a one-hot row of L columns and e
//     a 1 for the tokens 1..L-1. Its D x (Pc + L + 1) result is
//     dW | d(cls_pos)^T | db: the one-hot product is the TPU kernel's one-hot
//     transpose, made on the fly in shared memory, so the token sums need no
//     combine pass, no atomics and no inverse index. A repeated index sums
//     its rows' products in f32 (the gradients of repeated indices add, as in
//     the TPU kernel; every caller passes unique indices); an index out of
//     range has no gradient.
//     Like the forward it waits on latency more than on bytes: 8-warp blocks
//     (half of D a warp) with four 32-row stages in flight took it from
//     0.053 to 0.039 ms at K = 37 against 4 warps and three stages (H100
//     80GB HBM3, 700 W).
//   - pe_fold_kernel: the f32 split partials summed in split order into dW,
//     d(cls_pos) and db.
// dpatches (optional) = zeros, then each kept patch token's dy rows, summed
// in f32 in row order and rounded (pe_dsum_kernel, with an index), times W
// (pe_rows_kernel<PE_DP>), scattered to its patch row. Every sum has a fixed
// order: two calls give the same bits.
#include "common.cuh"

namespace {

constexpr int PE_MAX_L = 256;     // tokens
constexpr int PE_MAX_K = 1024;    // indices per image
constexpr int PE_MAX_W = 256;     // D and Pc: W (<= 135 KB) stays in shared memory
constexpr int PE_ROWS = 64;       // kept rows per tile of the row kernel
constexpr int ROW_THREADS = 256;  // row kernel: 4 strips of 16 rows x 2 column halves
constexpr int DW_BK = 32;         // rows per stage of the dW product
constexpr int DW_BN = 64;         // columns per block of the dW product
constexpr int DW_THREADS = 256;   // dW product: 4 slices of 16 columns x 2 halves of D
constexpr int DW_STAGES = 4;      // stages in flight: the dW product waits on latency
constexpr int DW_BLOCKS = 528;    // blocks the dW product aims at (4 per H100 SM)
static_assert(ROW_THREADS % PE_ROWS == 0 && DW_THREADS % DW_BK == 0,
              "the loaders give every row the same number of threads");

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

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

__device__ __forceinline__ long long patch_row(const Rows& q, int r) {
  return patch_of(q, r, row_token(q, r));
}

// 8 bf16 from src (16-byte aligned: cp.async) or, unaligned, element by
// element; zeros when src is null
__device__ __forceinline__ void chunk8(bf16* dst, const bf16* src, bool vec) {
  if (src && vec) {
    cp_async16(dst, src);
    return;
  }
  union {
    uint4 u;
    bf16 h[8];
  } v;
#pragma unroll
  for (int e = 0; e < 8; ++e) v.h[e] = src ? src[e] : __float2bfloat16(0.f);
  *reinterpret_cast<uint4*>(dst) = v.u;
}

__host__ __device__ inline bool vec16(const void* p, int ld) {
  return (ld & 7) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// Row kernel: each kept row times all output columns, W resident.
//   PE_FWD  A = gathered patch rows (reduction Pc), B(c, d) = W[d][c] (n = D);
//           epilogue bias + pos / CLS -> out (B*K, D)
//   PE_DP   A = combined dy rows (reduction D), B(d, c) = W[d][c] (n = Pc);
//           rows scattered to their patch row of dpatches
// ---------------------------------------------------------------------------
enum PeMode : int { PE_FWD = 0, PE_DP = 1 };

struct RowArgs {
  const bf16* src;   // PE_FWD: patches [B*N][Pc]; PE_DP: combined dy [B*K][D]
  const bf16* w;     // [D][Pc]
  int D, Pc, rows;   // rows = B*K
  Rows map;
  const bf16* bias;  // PE_FWD: [D]
  const float* cls;  // PE_FWD: [D]
  const float* pos;  // PE_FWD: [L][D]
  bf16* out;         // PE_FWD: [B*K][D]; PE_DP: dpatches [B*N][Pc]
};

inline size_t rows_smem(int mode, int D, int Pc) {
  const int KP = mode == PE_FWD ? pad16(Pc) : pad16(D);
  return (size_t)pad16(D) * (pad16(Pc) + 8) * 2 + (size_t)2 * PE_ROWS * (KP + 8) * 2;
}

// NT: the 8-column tiles a warp holds, half the output width rounded up to
// a bucket (10: D = 144)
template <int MODE, int NT>
__global__ void __launch_bounds__(ROW_THREADS) pe_rows_kernel(const RowArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dp = pad16(p.D), Pcp = pad16(p.Pc), WLD = Pcp + 8;
  const int kdim = MODE == PE_FWD ? p.Pc : p.D;
  const int KP = MODE == PE_FWD ? Pcp : Dp, ALD = KP + 8;
  const int NTr = (MODE == PE_FWD ? Dp : Pcp) / 8;
  const int src_ld = kdim;
  bf16* Ws = reinterpret_cast<bf16*>(smem);  // [Dp][WLD], zero-padded
  bf16* As = Ws + Dp * WLD;                  // [2][PE_ROWS][ALD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int tiles = (p.rows + PE_ROWS - 1) / PE_ROWS;
  const bool wvec = vec16(p.w, p.Pc), svec = vec16(p.src, src_ld);

  for (int i = threadIdx.x; i < Dp * (Pcp / 8); i += ROW_THREADS) {
    const int r = i / (Pcp / 8), c = (i - r * (Pcp / 8)) * 8;
    chunk8(Ws + r * WLD + c, r < p.D && c < p.Pc ? p.w + (size_t)r * p.Pc + c : nullptr, wvec);
  }
  // ROW_THREADS / PE_ROWS threads a row: one token lookup a thread, so that
  // a thread's copies wait on one index load, not one each
  constexpr int TPR = ROW_THREADS / PE_ROWS;
  auto load_tile = [&](int buf, int tile) {
    const int row = threadIdx.x / TPR, r = tile * PE_ROWS + row;
    long long sr = -1;
    if (r < p.rows) {
      const long long pr = patch_row(p.map, r);
      sr = MODE == PE_FWD ? pr : (pr >= 0 ? r : -1);
    }
    bf16* A = As + (buf * PE_ROWS + row) * ALD;
    for (int c = (threadIdx.x % TPR) * 8; c < KP; c += TPR * 8)
      chunk8(A + c, sr >= 0 && c < kdim ? p.src + sr * src_ld + c : nullptr, svec);
  };
  load_tile(0, blockIdx.x);  // the grid has at most `tiles` blocks
  cp_async_commit();

  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const int buf = it & 1;
    if (tile + (int)gridDim.x < tiles) load_tile(buf ^ 1, tile + gridDim.x);
    cp_async_commit();
    cp_async_wait<1>();  // W and this tile have landed
    __syncthreads();
    const bf16* A = As + buf * PE_ROWS * ALD;
    const int rw = warp & 3, NP = NTr / 2, HP = (NP + 1) / 2;
    const int plo = (warp >> 2) * HP, phi = min(NP, plo + HP);
    float acc[NT][4] = {};
    for (int kc = 0; kc < KP / 16; ++kc) {
      unsigned af[4];
      ldsm_x4(af, A + ld_a(rw * 16, kc * 16, ALD, lane));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (plo + np < phi) {
          unsigned bq[4];
          if (MODE == PE_FWD) ldsm_x4(bq, Ws + ld_b((plo + np) * 16, kc * 16, WLD, lane));
          else ldsm_x4_t(bq, Ws + ld_a(kc * 16, (plo + np) * 16, WLD, lane));
          mma16816(acc[2 * np], af, bq[0], bq[1]);
          mma16816(acc[2 * np + 1], af, bq[2], bq[3]);
        }
      }
    }
    // this lane's two rows: their token (and output row) once, read-only
    // operands through the non-coherent path, so that no load waits on the
    // stores before it
    int row[2], tok[2];
    long long dst[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      row[hh] = tile * PE_ROWS + rw * 16 + g + 8 * hh;
      tok[hh] = -1;
      dst[hh] = -1;
      if (row[hh] < p.rows) {
        tok[hh] = p.map.idx ? (int)__ldg(p.map.idx + row[hh]) : row_token(p.map, row[hh]);
        dst[hh] = MODE == PE_FWD ? (long long)row[hh] * p.D : patch_row(p.map, row[hh]) * p.Pc;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = (2 * plo + j) * 8 + 2 * tq;
      if (2 * plo + j >= 2 * phi || c >= (MODE == PE_FWD ? p.D : p.Pc)) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (row[hh] >= p.rows || dst[hh] < 0) continue;
        float o0 = acc[j][2 * hh], o1 = acc[j][2 * hh + 1];
        if (MODE == PE_FWD) {
          const int t = tok[hh];
          if (t < 0 || t >= p.map.L) {
            o0 = o1 = __int_as_float(0x7fc00000);  // NaN
          } else if (t == 0) {
            o0 = __ldg(p.cls + c) + __ldg(p.pos + c);
            o1 = __ldg(p.cls + c + 1) + __ldg(p.pos + c + 1);
          } else {
            const float2 pt = __ldg(reinterpret_cast<const float2*>(p.pos + (size_t)t * p.D + c));
            const __nv_bfloat162 bb = __ldg(reinterpret_cast<const __nv_bfloat162*>(p.bias + c));
            o0 = rbf(o0 + bf(bb.x)) + rbf(pt.x);
            o1 = rbf(o1 + bf(bb.y)) + rbf(pt.y);
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(p.out + dst[hh] + c) = __floats2bfloat162_rn(o0, o1);
      }
    }
    __syncthreads();  // the next iteration's load overwrites this buffer
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n > 0 ? n : 1;
}

template <int MODE, int NT>
cudaError_t launch_rows_nt(const RowArgs& p, cudaStream_t st) {
  // per instance: the shared memory last set and the blocks per SM it allows
  static size_t set_smem = 0;
  static int per_sm = 0;
  const size_t smem = rows_smem(MODE, p.D, p.Pc);
  if (smem != set_smem) {
    cudaError_t e = cudaFuncSetAttribute(pe_rows_kernel<MODE, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pe_rows_kernel<MODE, NT>,
                                                        ROW_THREADS, smem);
    if (e != cudaSuccess) return e;
    set_smem = smem;
  }
  const int tiles = (p.rows + PE_ROWS - 1) / PE_ROWS;
  const int full = (per_sm > 0 ? per_sm : 1) * sm_count();
  const int grid = tiles < full ? tiles : full;
  pe_rows_kernel<MODE, NT><<<grid, ROW_THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_rows(const RowArgs& p, cudaStream_t st) {
  const int width = MODE == PE_FWD ? p.D : p.Pc;
  return pad16(width) / 8 <= 20 ? launch_rows_nt<MODE, 10>(p, st)
                                : launch_rows_nt<MODE, 16>(p, st);
}

// ---------------------------------------------------------------------------
// dW | d(cls_pos)^T | db = dy^T [X | E | e] over the kept rows, split-K
// ---------------------------------------------------------------------------

struct DwArgs {
  const bf16* dy;       // [rows][D]
  const bf16* patches;  // [B*N][Pc]
  Rows map;             // each row's token (the index, or none)
  int rows, D, Pc;
  int NCP;              // Pc + L + 1 columns, padded to DW_BN
  int chunk;            // rows per split, a multiple of DW_BK
  float* part;          // [splits][D][NCP]
};

inline size_t dw_smem(int MT) {
  return (size_t)DW_STAGES * DW_BK * (MT * 16 + 8 + DW_BN + 8) * 2;
}

// MT: 16-row tiles of D, D's bucket (9: D = 144); a warp holds half of them
// for 16 of the block's 64 columns
template <int MT>
__global__ void __launch_bounds__(DW_THREADS) pe_dw_kernel(const DwArgs p) {
  constexpr int YLD = MT * 16 + 8, XLD = DW_BN + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ys = reinterpret_cast<bf16*>(smem);  // [DW_STAGES][DW_BK][YLD] dy rows [r][d]
  bf16* Xs = Ys + DW_STAGES * DW_BK * YLD;   // [DW_STAGES][DW_BK][XLD] [X | E | e] rows
  const int Dp = pad16(p.D), L = p.map.L;
  const int n0 = blockIdx.x * DW_BN;
  const int r0 = blockIdx.y * p.chunk, r1 = min(p.rows, r0 + p.chunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool yvec = vec16(p.dy, p.D), pvec = vec16(p.patches, p.Pc);

  auto load_stage = [&](int buf, int k0) {
    for (int i = threadIdx.x; i < DW_BK * (Dp / 8); i += DW_THREADS) {
      const int row = i / (Dp / 8), c = (i - row * (Dp / 8)) * 8, r = k0 + row;
      chunk8(Ys + (buf * DW_BK + row) * YLD + c,
             r < r1 && c < p.D ? p.dy + (size_t)r * p.D + c : nullptr, yvec);
    }
    // DW_THREADS / DW_BK threads a row, one token lookup each
    constexpr int TPR = DW_THREADS / DW_BK;
    const int row = threadIdx.x / TPR, r = k0 + row;
    const int t = r < r1 ? row_token(p.map, r) : -1;
    const long long pr = patch_of(p.map, r, t);
    for (int n = n0 + (threadIdx.x % TPR) * 8; n < n0 + DW_BN; n += TPR * 8) {
      bf16* dst = Xs + (buf * DW_BK + row) * XLD + (n - n0);
      if (n < p.Pc) {
        chunk8(dst, pr >= 0 ? p.patches + pr * p.Pc + n : nullptr, pvec);
        continue;
      }
      const bool valid = t >= 0 && t < L;
      union {
        uint4 u;
        bf16 h[8];
      } v;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = n + e - p.Pc;  // token column, or L for db
        const bool one = valid && (col == t || (col == L && t >= 1));
        v.h[e] = __float2bfloat16(one ? 1.f : 0.f);
      }
      *reinterpret_cast<uint4*>(dst) = v.u;
    }
  };

  constexpr int MH = (MT + 1) / 2;  // 16-row tiles of D a warp holds
  const int cw = warp & 3, m0 = (warp >> 2) * MH;
  float acc[MH][2][4] = {};
  const int nk = (r1 - r0 + DW_BK - 1) / DW_BK;
  for (int i = 0; i < DW_STAGES - 1; ++i) {
    if (i < nk) load_stage(i, r0 + i * DW_BK);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    const int ahead = i + DW_STAGES - 1, buf = i % DW_STAGES;
    if (ahead < nk) load_stage(ahead % DW_STAGES, r0 + ahead * DW_BK);
    cp_async_commit();
    cp_async_wait<DW_STAGES - 1>();  // stage i has landed
    __syncthreads();
    const bf16* Xb = Xs + buf * DW_BK * XLD;
    const bf16* Yb = Ys + buf * DW_BK * YLD;
#pragma unroll
    for (int ks = 0; ks < DW_BK / 16; ++ks) {
      unsigned xb[4];
      ldsm_x4_t(xb, Xb + ld_a(ks * 16, cw * 16, XLD, lane));
#pragma unroll
      for (int mt = 0; mt < MH; ++mt) {
        if ((m0 + mt) * 16 < Dp) {
          unsigned ya[4];
          ldsm_x4_t(ya, Yb + ld_b(ks * 16, (m0 + mt) * 16, YLD, lane));
          mma16816(acc[mt][0], ya, xb[0], xb[1]);
          mma16816(acc[mt][1], ya, xb[2], xb[3]);
        }
      }
    }
    __syncthreads();
  }

  const int g = lane >> 2, tq = lane & 3;
  float* out = p.part + (size_t)blockIdx.y * p.D * p.NCP;
#pragma unroll
  for (int mt = 0; mt < MH; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int d = (m0 + mt) * 16 + g + 8 * hh, n = n0 + cw * 16 + j * 8 + 2 * tq;
        if (d < p.D)
          *reinterpret_cast<float2*>(out + (size_t)d * p.NCP + n) =
              make_float2(acc[mt][j][2 * hh], acc[mt][j][2 * hh + 1]);
      }
}

template <int MT>
cudaError_t launch_dw(const DwArgs& a, dim3 grid, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      pe_dw_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dw_smem(MT));
  if (e != cudaSuccess) return e;
  pe_dw_kernel<MT><<<grid, DW_THREADS, dw_smem(MT), st>>>(a);
  return cudaGetLastError();
}

// dw[d][c], dcp[t][d] and db[d] from the split partials, summed in split
// order
__global__ void pe_fold_kernel(const float* __restrict__ part, int S, int D, int Pc, int L,
                               int NCP, float* __restrict__ dw, float* __restrict__ dcp,
                               float* __restrict__ db) {
  const int NC = Pc + L + 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= D * NC) return;
  const int d = i / NC, n = i - d * NC;
  float s = 0.f;
#pragma unroll 8
  for (int sp = 0; sp < S; ++sp) s += part[((size_t)sp * D + d) * NCP + n];
  if (n < Pc) dw[(size_t)d * Pc + n] = s;
  else if (n < Pc + L) dcp[(size_t)(n - Pc) * D + d] = s;
  else db[d] = s;
}

// dpatches with an index: one warp per kept row r of image b. The row counts
// when its token t is a patch (1 <= t < L) that no earlier row of b holds;
// then dsum[r] = bf16(the f32 sum, in row order, of b's dy rows that hold t)
// and map[r] = t, else map[r] = -1.
__global__ void pe_dsum_kernel(const bf16* __restrict__ dy, const long long* __restrict__ idx,
                               int rows, int K, int L, int D, bf16* __restrict__ dsum,
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
  float acc[8] = {};
  const int c = 8 * lane;
  for (int j0 = k; j0 < K; j0 += 32) {
    unsigned hits = __ballot_sync(0xffffffffu, j0 + lane < K && ib[j0 + lane] == t);
    while (hits) {
      const int j = j0 + __ffs(hits) - 1;
      hits &= hits - 1;
      if (c < D) {
        const bf16* y = dy + ((size_t)b * K + j) * D + c;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += bf(y[e]);
      }
    }
  }
  if (c < D)
#pragma unroll
    for (int e = 0; e < 8; ++e) dsum[(size_t)r * D + c + e] = tobf(acc[e]);
}

struct BwdPlan {
  int ncp, splits, chunk;
};

BwdPlan bwd_plan(int B, int Pc, int D, int K, int L) {
  BwdPlan p;
  const int rows = B * K;
  p.ncp = cdiv(Pc + L + 1, DW_BN) * DW_BN;
  int s = cdiv(DW_BLOCKS, p.ncp / DW_BN);
  const int most = cdiv(rows, 256);  // >= 256 rows a split
  s = s < most ? s : most;
  s = s > 1 ? s : 1;
  p.chunk = cdiv(cdiv(rows, s), DW_BK) * DW_BK;
  p.splits = cdiv(rows, p.chunk);
  return p;
}

size_t bwd_carve(Carver& c, int B, int Pc, int D, int K, int L, bool has_idx, bf16** dsum,
                 int** map, float** part) {
  const BwdPlan p = bwd_plan(B, Pc, D, K, L);
  *part = c.take<float>((size_t)p.splits * D * p.ncp);
  *dsum = has_idx ? c.take<bf16>((size_t)B * K * D) : nullptr;
  *map = has_idx ? c.take<int>((size_t)B * K) : nullptr;
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
  RowArgs p{};
  p.src = static_cast<const bf16*>(patches);
  p.w = static_cast<const bf16*>(w);
  p.D = D; p.Pc = Pc; p.rows = B * K;
  p.map = Rows{static_cast<const long long*>(idx), nullptr, K, N, N + 1};
  p.bias = static_cast<const bf16*>(bias);
  p.cls = static_cast<const float*>(cls);
  p.pos = static_cast<const float*>(pos);
  p.out = static_cast<bf16*>(out);
  return (int)launch_rows<PE_FWD>(p, static_cast<cudaStream_t>(stream));
}

long long ssrl_patch_embed_bwd_workspace(int B, int N, int Pc, int D, int K,
                                         int has_idx) {
  Carver c{nullptr};
  bf16* dsum;
  int* map;
  float* part;
  return (long long)bwd_carve(c, B, Pc, D, K, N + 1, has_idx != 0, &dsum, &map, &part);
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
  const int L = N + 1, rows = B * K;
  const BwdPlan plan = bwd_plan(B, Pc, D, K, L);
  Carver c{static_cast<char*>(ws)};
  bf16* dsum;
  int* map;
  float* part;
  bwd_carve(c, B, Pc, D, K, L, has_idx, &dsum, &map, &part);
  const long long* idx64 = static_cast<const long long*>(idx);
  const bf16* dyb = static_cast<const bf16*>(dy);

  DwArgs a{};
  a.dy = dyb;
  a.patches = static_cast<const bf16*>(patches);
  a.map = Rows{idx64, nullptr, K, N, L};
  a.rows = rows; a.D = D; a.Pc = Pc;
  a.NCP = plan.ncp;
  a.chunk = plan.chunk;
  a.part = part;
  const dim3 grid(plan.ncp / DW_BN, plan.splits);
  const cudaError_t e = pad16(D) / 16 <= 9 ? launch_dw<9>(a, grid, st) : launch_dw<16>(a, grid, st);
  if (e != cudaSuccess) return (int)e;
  const int outs = D * (Pc + L + 1);
  pe_fold_kernel<<<cdiv(outs, 256), 256, 0, st>>>(part, plan.splits, D, Pc, L, plan.ncp,
                                                  static_cast<float*>(dw),
                                                  static_cast<float*>(dcp),
                                                  static_cast<float*>(db));

  if (dpatches) {
    cudaError_t e = cudaMemsetAsync(dpatches, 0, (size_t)B * N * Pc * sizeof(bf16), st);
    if (e != cudaSuccess) return (int)e;
    RowArgs d{};
    d.src = dyb;  // without an index every row is a distinct token
    d.map = Rows{nullptr, nullptr, K, N, L};
    if (has_idx) {
      pe_dsum_kernel<<<cdiv((long long)rows * 32, 256), 256, 0, st>>>(dyb, idx64, rows, K, L,
                                                                       D, dsum, map);
      d.src = dsum;
      d.map = Rows{nullptr, map, K, N, L};
    }
    d.w = static_cast<const bf16*>(w);
    d.D = D; d.Pc = Pc; d.rows = rows;
    d.out = static_cast<bf16*>(dpatches);
    e = launch_rows<PE_DP>(d, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
