// The MLP half of a pre-LN block as one kernel each way on Hopper (sm_90a),
// for the whole-block kernel (csrc/fused_block.cu) and the chained-block
// kernel (csrc/block_chain.cu):
//   out = x + bf16(h W2^T + b2),  h = bf16(gelu(z)),  z = bf16(LN2(x)) W1^T + b1
// with z rounded to bf16 (the chain) or kept in f32 (the whole block), and
// its backward from the gradient at out.
//
// Serves the TPU kernels of ssrl_vit_mae_jepa_tpu/ops/block_pallas.py
// _fb_fwd_impl (:408) and _fb_vjp_bwd (:442), the MLP half of
// _block_fwd_one / _block_bwd_one (:256-317), and of ops/block_chain.py
// _chain_fwd_only (:235), _chain_fwd (:261) and _chain_bwd (:288), the MLP
// half of their bodies (:85-117, :141-166). The split MLP branch
// (csrc/mlp_branch.cu) does not use it.
//
// What bounds it on the H100: per row 4DF MACs forward and 6DF backward
// (z again, dh, dy2) at D = 96-192, F = 4D, against 2D bf16 bytes of input
// and output: a few hundred FLOP/byte, near the card's ~295 ridge. As a
// sequence of products (csrc/mlp_branch.cu) it is bound by the F-wide
// intermediates each product writes and the next reads back: z (f32 for
// the whole block, 4F bytes a row), h, dz, dy2, and y2.
//
// What this design does about it: one block per 128 rows (two consumer
// warpgroups of 64 rows, one producer warpgroup) walks F in chunks of 64:
//   - LN2 in the prologue: f32 row statistics as common.cuh's ln_fwd_kernel
//     takes them (the same warp-per-row order, so y2 has its bits), y2
//     written as bf16 straight into the 128B-swizzled tile wgmma reads;
//   - the producer keeps a ring of (W1 chunk, W2 chunk) stages full by TMA;
//     the W1 chunk is K-major for z and MN-major for dy2, the W2 chunk
//     K-major for the forward's fc2 and MN-major for the backward's dh, so
//     each stage is loaded once for both products of its pass;
//   - forward, per chunk: z = y2 W1c^T by wgmma into registers, bias, the
//     rounding of the epilogue it replaces (EPI_BIAS_GELU or EPI_BIAS_GELU32)
//     and the GELU in registers, h into a swizzled shared tile, then
//     out += h W2c^T by wgmma into a 64 x D f32 register tile; fc1 sums
//     K = D and fc2 K = F in 64-wide slices in ascending order as
//     gemm_sm90.cuh's NT kernel does, so the chain's forward keeps the split
//     kernels' bits; the epilogue adds b2 and the residual at
//     EPI_BIAS_RESID's rounding points and leaves through TMA stores;
//   - backward, per chunk: z again and dh = g W2c (K = D) by wgmma, h and
//     dz = dh gelu'(z) in registers, both bf16 into shared tiles that TMA
//     stores write once for the split-K weight-gradient products (dW2 =
//     g^T h, dW1 = dz^T y2, csrc/gemm_sm90.cuh), db1's per-warp column
//     partials from the f32 dz, and dy2 += dz W1c by wgmma into a 64 x D
//     f32 register tile; the epilogue runs the LN2 backward on that tile
//     (dx = g + LN2'(dy2), and the d ln_s, d ln_b, d b2 partials), so dy2
//     never reaches memory either.
// z never reaches device memory, dz is read once (by dW1). Every sum runs
// in one fixed order (per-warp partials, common.cuh::reduce_rows): no
// atomics, the same bits on every call.
#include "common.cuh"
#include "branch.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int HALF_ROWS = 128;                      // rows a block: two warpgroups of 64
constexpr int HALF_FC = 64;                         // the F chunk: one 128-byte swizzle span
constexpr int HALF_CONSUMERS = 256;                 // two warpgroups
// + a producer warpgroup, whose first warp issues every load: a whole
// warpgroup, so that setmaxnreg can move its registers to the consumers
// (40 a thread there, 232 here)
constexpr int HALF_THREADS = HALF_CONSUMERS + 128;
constexpr int HALF_WARPS = HALF_CONSUMERS / 32;     // per-warp partial rows a block

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,\n"
      " %8, %9, %10, %11, %12, %13, %14, %15,\n"
      " %16, %17, %18, %19, %20, %21, %22, %23,\n"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,\n"
      " %8, %9, %10, %11, %12, %13, %14, %15,\n"
      " %16, %17, %18, %19, %20, %21, %22, %23,\n"
      " %24, %25, %26, %27, %28, %29, %30, %31,\n"
      " %32, %33, %34, %35, %36, %37, %38, %39,\n"
      " %40, %41, %42, %43, %44, %45, %46, %47,\n"
      " %48, %49, %50, %51, %52, %53, %54, %55,\n"
      " %56, %57, %58, %59, %60, %61, %62, %63,\n"
      " %64, %65, %66, %67, %68, %69, %70, %71,\n"
      " %72, %73, %74, %75, %76, %77, %78, %79,\n"
      " %80, %81, %82, %83, %84, %85, %86, %87,\n"
      " %88, %89, %90, %91, %92, %93, %94, %95,\n"
      " %96, %97, %98, %99, %100, %101, %102, %103,\n"
      " %104, %105, %106, %107, %108, %109, %110, %111,\n"
      " %112, %113, %114, %115, %116, %117, %118, %119,\n"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_w(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == 64) wgmma_n64<TA, TB>(d, a, b, acc);
  else if constexpr (N == 96) wgmma_n96<TA, TB>(d, a, b, acc);
  else if constexpr (N == 144) wgmma_n144<TA, TB>(d, a, b, acc);
  else if constexpr (N == 192) wgmma_n192<TA, TB>(d, a, b, acc);
  else wgmma_n256<TA, TB>(d, a, b, acc);
}

// The byte offset of element (r, c), c < 64, in a box of 64-element rows of
// 128 bytes as TMA's 128-byte swizzle lays it out (the box 1024-aligned):
// the 16-byte unit c / 8 of row r sits at unit (c / 8) ^ (r % 8).
__device__ __forceinline__ int swz(int r, int c) {
  return r * SW_BYTES + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1);
}

// D padded to the products' width: the wgmma N of fc2 / dy2 and 16 x the
// k steps of fc1 / dh. The block geometries' 96, 144 and 192 run unpadded.
inline int half_dp(int D) { return D <= 64 ? 64 : D <= 96 ? 96 : D <= 144 ? 144 : D <= 192 ? 192 : 256; }

// Shared memory, every region 1024-aligned. Forward: the x tile (TMA; LN2's
// input and the residual), the y2 tile, the stages, the h chunk.
// Backward: the y2 tile (x lands there by TMA and LN2 writes y2 in place),
// the g tile, the stages, the h and dz chunks, the row statistics. After
// the F loop the y2 tile and the stages hold the two warpgroups' f32
// accumulators for the epilogue (acc_to_smem). Tiles are [2
// warpgroups][KB boxes][64 rows][128 bytes]; a stage is a W1 chunk [KB
// boxes][64 rows of F][128 bytes of D] and a W2 chunk [DP rows of D][128
// bytes of F]; the h and dz chunks [2 warpgroups][64 rows][128 bytes].
template <int DP, bool BWD>
struct HalfSmem {
  static constexpr int KB = (DP + 63) / 64;
  static constexpr int TILE = 2 * KB * BOX_BYTES;
  static constexpr int W1 = KB * BOX_BYTES;
  static constexpr int W2 = DP * SW_BYTES;
  static constexpr int STAGE = W1 + W2;
  static constexpr int STAGES = DP > 192 ? 1 : 2;  // 227 KB at D = 256
  static constexpr int X = 0;
  static constexpr int Y2 = X + (BWD ? 0 : TILE);
  static constexpr int G = Y2 + TILE;
  static constexpr int ST = G + (BWD ? TILE : 0);
  static constexpr int H = ST + STAGES * STAGE;
  static constexpr int DZ = H + 2 * BOX_BYTES;
  static constexpr int STATS = DZ + (BWD ? 2 * BOX_BYTES : 0);  // mean, 1/std: [2][128] f32
  static constexpr int BARS = STATS + (BWD ? 2 * HALF_ROWS * 4 : 0);
  // full, empty a stage; the x (and g) tiles
  static constexpr int BYTES = 1024 + BARS + (2 * STAGES + 1) * 8;  // + alignment slack
  static_assert(BYTES <= 232448, "the MLP half's shared memory exceeds the SM's");
  // the epilogues' f32 accumulator tiles (acc_to_smem): 64 rows of 64 KB
  static_assert(TILE >= 64 * KB * 64 * 4 && STAGES * STAGE >= 64 * KB * 64 * 4,
                "an accumulator tile does not fit its region");
};

// The block's x and parameters, and for the backward its gradients.
struct HalfArgs {
  const bf16* x;  // [M][D], the MLP half's input (the block's x_mid)
  bf16* out;      // [M][D], the forward's output
  const float* ln_s;
  const float* ln_b;
  const bf16* b1;
  const bf16* b2;
  int M, D, F;
  // backward
  const bf16* gy;     // [M][D] the gradient at out, bf16 (the products' operand)
  const float* gy32;  // its f32 form, or null (then gy is the gradient)
  bf16* dx;           // [M][D] gy + LN2'(dy2)
  float* dx32;        // and its f32 form, or null
  float* colpart;     // [8 m_tiles][F]: db1, each warp's 16 rows
  float* lnpart;      // [8 m_tiles][3][D]: d ln_s, d ln_b, d b2, each warp's rows
};

__device__ __forceinline__ float2 ldg_bf16x2(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

// element (r, c) of a swizzled [KB boxes][64 rows][128 bytes] bf16 tile
__device__ __forceinline__ bf16* tile_at(uint8_t* t, int r, int c) {
  return reinterpret_cast<bf16*>(t + (c >> 6) * BOX_BYTES + swz(r, c & 63));
}

// full and empty barriers a stage, then `extra` single-arrival ones
__device__ __forceinline__ void half_barriers_init(uint64_t* full, uint64_t* empty, int stages,
                                                    int extra) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(&full[s], 1);
    mbar_init(&empty[s], HALF_CONSUMERS);
  }
  for (int i = 0; i < extra; ++i) mbar_init(&empty[stages + i], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer: the block's 128 rows of `a` (and of `b`) into their tiles,
// then the (W1, W2) chunks of F, in order, through the stage ring.
template <typename S>
__device__ __forceinline__ void half_produce(uint8_t* smem, uint64_t* full, uint64_t* empty,
                                             uint64_t* in_full, const CUtensorMap* a, int a_at,
                                             const CUtensorMap* b, int b_at,
                                             const CUtensorMap* w1, const CUtensorMap* w2,
                                             int m0, int F) {
  mbar_expect_tx(in_full, (b ? 2 : 1) * S::TILE);
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int k = 0; k < S::KB; ++k) {
      const int o = (w * S::KB + k) * BOX_BYTES;
      tma_load(smem + a_at + o, a, in_full, 64 * k, m0 + 64 * w);
      if (b) tma_load(smem + b_at + o, b, in_full, 64 * k, m0 + 64 * w);
    }
  int s = 0, ph = 0;
  for (int f0 = 0; f0 < F; f0 += HALF_FC) {
    mbar_wait(&empty[s], ph ^ 1);
    mbar_expect_tx(&full[s], S::STAGE);
    uint8_t* st = smem + S::ST + s * S::STAGE;
#pragma unroll
    for (int k = 0; k < S::KB; ++k) tma_load(st + k * BOX_BYTES, w1, &full[s], 64 * k, f0);
    tma_load(st + S::W1, w2, &full[s], f0, 0);
    if (++s == S::STAGES) { s = 0; ph ^= 1; }
  }
}

// common.cuh's ln_stats for RB rows at once, each row's operations in
// ln_stats's order (so the same bits), the rows' steps side by side: each
// step of one row waits on shuffles or a division that the others' fill.
template <int RB>
__device__ __forceinline__ void ln_stats_rows(const float (&v)[RB][LN_MAXV], int lane, int D,
                                              float (&mu)[RB], float (&inv)[RB]) {
  float s[RB], q[RB];
#pragma unroll
  for (int k = 0; k < RB; ++k) {
    s[k] = 0.f;
#pragma unroll
    for (int i = 0; i < LN_MAXV; ++i) s[k] += v[k][i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < RB; ++k) s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
#pragma unroll
  for (int k = 0; k < RB; ++k) mu[k] = s[k] / (float)D;
#pragma unroll
  for (int k = 0; k < RB; ++k) {
    q[k] = 0.f;
#pragma unroll
    for (int i = 0; i < LN_MAXV; ++i) {
      const float d = (lane + 32 * i < D) ? v[k][i] - mu[k] : 0.f;
      q[k] += d * d;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < RB; ++k) q[k] += __shfl_xor_sync(0xffffffffu, q[k], o);
#pragma unroll
  for (int k = 0; k < RB; ++k) inv[k] = rsqrtf(q[k] / (float)D + kLnEps);
}

// y2 = bf16(LN2(x)) of the block's rows from the x tile into the y2 tile
// (the same tile in the backward: each lane reads its elements before it
// writes them), zero past D and past M; consumer warp w takes rows 16w ..
// 16w + 15 (its warpgroup's), four at a time, with ln_fwd_kernel's lanes and
// order, so y2 has the split kernels' bits. With `mu_s` the rows' mean and
// 1/std are kept too.
template <int KB>
__device__ __forceinline__ void ln_tile(const HalfArgs& p, int m0, uint8_t* xt, uint8_t* y2,
                                        float* mu_s, float* inv_s, int warp, int lane) {
  float sl[LN_MAXV], bl[LN_MAXV];
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    const int c = lane + 32 * i;
    sl[i] = c < p.D ? __ldg(p.ln_s + c) : 0.f;
    bl[i] = c < p.D ? __ldg(p.ln_b + c) : 0.f;
  }
  constexpr int RB = 4;
#pragma unroll 1
  for (int rr = 0; rr < 16; rr += RB) {
    float v[RB][LN_MAXV], mu[RB], inv[RB];
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int lr = warp * 16 + rr + k;
      const bool in = m0 + lr < p.M;
      uint8_t* xb = xt + (lr >> 6) * KB * BOX_BYTES;
#pragma unroll
      for (int i = 0; i < LN_MAXV; ++i) {
        const int c = lane + 32 * i;
        v[k][i] = in && c < p.D ? bf(*tile_at(xb, lr & 63, c)) : 0.f;
      }
    }
    ln_stats_rows<RB>(v, lane, p.D, mu, inv);
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int lr = warp * 16 + rr + k;
      const bool in = m0 + lr < p.M;
      uint8_t* yb = y2 + (lr >> 6) * KB * BOX_BYTES;
#pragma unroll
      for (int i = 0; i < LN_MAXV; ++i) {
        const int c = lane + 32 * i;
        if (c < KB * 64)
          *tile_at(yb, lr & 63, c) =
              in && c < p.D ? tobf((v[k][i] - mu[k]) * inv[k] * sl[i] + bl[i]) : tobf(0.f);
      }
      if (mu_s && lane == 0) {
        mu_s[lr] = mu[k];
        inv_s[lr] = inv[k];
      }
    }
  }
}

// A warpgroup's 64 x D f32 accumulator, out of the wgmma fragments into
// shared memory for a warp-per-row epilogue: row r, column c at r * P +
// (c ^ 8 (r % 8)), P = 64 KB (the XOR spreads a fragment's 8 rows over the
// banks); warpgroup 0's tile in the y2 tile's place, 1's in the stages'
// (each fits: P <= 64 KB, and STAGES * STAGE >= 256 DP).
template <int DP>
__device__ __forceinline__ float* acc_to_smem(const float (&acc)[DP / 2], float* t, int lr,
                                              int tq) {
  constexpr int P = (DP + 63) / 64 * 64;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lr + 8 * h, c = 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(t + r * P + (c ^ ((r & 7) << 3))) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  return t;
}

// element pair (r, c), (r, c + 1) of such a tile
template <int DP>
__device__ __forceinline__ float2 acc_at(const float* t, int r, int c) {
  constexpr int P = (DP + 63) / 64 * 64;
  return *reinterpret_cast<const float2*>(t + r * P + (c ^ ((r & 7) << 3)));
}

// the block's rows [r0, r0 + rows) of a row-major [M][width] tensor into L2
__device__ __forceinline__ void prefetch_rows(const void* base, int r0, int rows, int M,
                                              int row_bytes) {
  const int n = min(rows, M - r0);
  if (n > 0)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                     static_cast<const char*>(base) + (size_t)r0 * row_bytes),
                 "r"(n * row_bytes)
                 : "memory");
}

// z + b1 at one accumulator pair, rounded to bf16 where the contract says
template <bool ROUND>
__device__ __forceinline__ float2 pre_act(float v0, float v1, float2 b) {
  float z0 = v0 + b.x, z1 = v1 + b.y;
  if constexpr (ROUND) {
    z0 = rbf(z0);
    z1 = rbf(z1);
  }
  return make_float2(z0, z1);
}

// ROUND: z rounded to bf16 before the GELU (the chain), else kept in f32
template <int DP, bool ROUND>
__global__ void __launch_bounds__(HALF_THREADS, 1)
    mlp_half_fwd_kernel(const __grid_constant__ CUtensorMap tma_w1,
                        const __grid_constant__ CUtensorMap tma_w2,
                        const __grid_constant__ CUtensorMap tma_x, const HalfArgs p) {
  using S = HalfSmem<DP, false>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + S::STAGES;
  uint64_t* in_full = empty + S::STAGES;  // the x tile has landed
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) half_barriers_init(full, empty, S::STAGES, 1);
  __syncthreads();
  const int m0 = blockIdx.x * HALF_ROWS;

  if (warp >= HALF_WARPS) {  // the producer warpgroup, on few registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == HALF_WARPS && lane == 0)
      half_produce<S>(smem, full, empty, in_full, &tma_x, S::X, nullptr, 0, &tma_w1, &tma_w2,
                      m0, p.F);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp >> 2, g = lane >> 2, tq = lane & 3;
    const int lr = (warp & 3) * 16 + g;  // the thread's row in its warpgroup's 64 (and lr + 8)
    mbar_wait(in_full, 0);
    ln_tile<S::KB>(p, m0, smem + S::X, smem + S::Y2, nullptr, nullptr, warp, lane);
    fence_async_smem();
    named_sync(1 + wg, 128);
    uint8_t* xt = smem + S::X + wg * S::KB * BOX_BYTES;
    uint8_t* ht = smem + S::H + wg * BOX_BYTES;
    const uint32_t y2 = smem_u32(smem + S::Y2 + wg * S::KB * BOX_BYTES), h_desc = smem_u32(ht);

    float out[DP / 2], z[HALF_FC / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) out[i] = 0.f;
#pragma unroll
    for (int i = 0; i < HALF_FC / 2; ++i) z[i] = 0.f;
    int s = 0, ph = 0, prev = -1;
    for (int f0 = 0; f0 < p.F; f0 += HALF_FC) {
      mbar_wait(&full[s], ph);
      const uint32_t w1 = smem_u32(smem + S::ST + s * S::STAGE), w2 = w1 + S::W1;
      // z = y2 W1c^T, K = D in k16 steps, ascending
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_n64<0, 0>(z, sw128_desc(y2 + (kk >> 2) * BOX_BYTES + (kk & 3) * 32, 16, 1024),
                        sw128_desc(w1 + (kk >> 2) * BOX_BYTES + (kk & 3) * 32, 16, 1024), kk > 0);
      wg_commit();
      wg_wait<0>();  // this z, and the last chunk's fc2: its stage and the h tile are free
      acc_fence(z);
      acc_fence(out);
      if (prev >= 0) mbar_arrive(&empty[prev]);
      named_sync(1 + wg, 128);
      // h = bf16(gelu(z + b1)) into the warpgroup's h tile
#pragma unroll
      for (int j = 0; j < HALF_FC / 8; ++j) {
        const int c = f0 + 8 * j + 2 * tq;
        const float2 b = c < p.F ? ldg_bf16x2(p.b1 + c) : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 zz = pre_act<ROUND>(z[4 * j + 2 * h], z[4 * j + 2 * h + 1], b);
          *reinterpret_cast<uint32_t*>(ht + swz(lr + 8 * h, 8 * j + 2 * tq)) =
              pack_bf16(gelu_f(zz.x), gelu_f(zz.y));
        }
      }
      fence_async_smem();
      named_sync(1 + wg, 128);
      // out += h W2c^T, K = the chunk's 64 in k16 steps
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HALF_FC / 16; ++kk)
        wgmma_w<DP, 0, 0>(out, sw128_desc(h_desc + kk * 32, 16, 1024),
                          sw128_desc(w2 + kk * 32, 16, 1024), 1);
      wg_commit();
      if constexpr (S::STAGES == 1) {  // the producer waits on this stage: free it now
        wg_wait<0>();
        acc_fence(out);
        mbar_arrive(&empty[s]);
      } else {
        prev = s;
      }
      if (++s == S::STAGES) { s = 0; ph ^= 1; }
    }
    wg_wait<0>();
    acc_fence(out);

    // out = bf16(x + bf16(acc + b2)): the accumulator into shared memory,
    // then a warp per row (lane: columns 64 i + 2 lane, + 1), x from the x
    // tile, stores of whole rows
    // both warpgroups' last products have read the y2 tiles and the stages
    asm volatile("bar.sync 3, %0;\n" ::"n"(HALF_CONSUMERS) : "memory");
    float* acc = acc_to_smem<DP>(
        out, reinterpret_cast<float*>(smem + (wg == 0 ? S::Y2 : S::ST)), lr, tq);
    named_sync(1 + wg, 128);
    float2 bias[S::KB];
#pragma unroll
    for (int i = 0; i < S::KB; ++i) {
      const int c = 64 * i + 2 * lane;
      bias[i] = c < p.D ? ldg_bf16x2(p.b2 + c) : make_float2(0.f, 0.f);
    }
#pragma unroll 2
    for (int r = (warp & 3) * 16; r < (warp & 3) * 16 + 16; ++r) {
      const int row = m0 + wg * 64 + r;
      if (row >= p.M) break;
#pragma unroll
      for (int i = 0; i < S::KB; ++i) {
        const int c = 64 * i + 2 * lane;
        if (c < p.D) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(tile_at(xt, r, c)));
          const float2 v = acc_at<DP>(acc, r, c);
          *reinterpret_cast<uint32_t*>(p.out + (size_t)row * p.D + c) =
              pack_bf16(xv.x + rbf(v.x + bias[i].x), xv.y + rbf(v.y + bias[i].y));
        }
      }
    }
  }
}

template <int DP, bool ROUND>
__global__ void __launch_bounds__(HALF_THREADS, 1)
    mlp_half_bwd_kernel(const __grid_constant__ CUtensorMap tma_w1,
                        const __grid_constant__ CUtensorMap tma_w2,
                        const __grid_constant__ CUtensorMap tma_x,
                        const __grid_constant__ CUtensorMap tma_g,
                        const __grid_constant__ CUtensorMap tma_y2,
                        const __grid_constant__ CUtensorMap tma_h,
                        const __grid_constant__ CUtensorMap tma_dz, const HalfArgs p) {
  using S = HalfSmem<DP, true>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + S::STAGES;
  uint64_t* in_full = empty + S::STAGES;  // the x and g tiles have landed
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) half_barriers_init(full, empty, S::STAGES, 1);
  __syncthreads();
  const int m0 = blockIdx.x * HALF_ROWS;

  if (warp >= HALF_WARPS) {  // the producer warpgroup, on few registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == HALF_WARPS && lane == 0)
      half_produce<S>(smem, full, empty, in_full, &tma_x, S::Y2, &tma_g, S::G, &tma_w1, &tma_w2,
                      m0, p.F);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp >> 2, g = lane >> 2, tq = lane & 3;
    const int lr = (warp & 3) * 16 + g;
    const bool lead = threadIdx.x % 128 == 0;  // the warpgroup's TMA thread
    const bool rows_in = m0 + wg * 64 < p.M;
    float* mu_s = reinterpret_cast<float*>(smem + S::STATS);
    float* inv_s = mu_s + HALF_ROWS;
    mbar_wait(in_full, 0);
    ln_tile<S::KB>(p, m0, smem + S::Y2, smem + S::Y2, mu_s, inv_s, warp, lane);
    fence_async_smem();
    named_sync(1 + wg, 128);
    uint8_t* y2t = smem + S::Y2 + wg * S::KB * BOX_BYTES;
    uint8_t* gt = smem + S::G + wg * S::KB * BOX_BYTES;
    uint8_t* ht = smem + S::H + wg * BOX_BYTES;
    uint8_t* dzt = smem + S::DZ + wg * BOX_BYTES;
    if (lead && rows_in) {  // y2 for dW1 = dz^T y2, once
      for (int k = 0; k < S::KB && 64 * k < p.D; ++k)
        tma_store(&tma_y2, y2t + k * BOX_BYTES, 64 * k, m0 + wg * 64);
      bulk_commit();
    }
    const uint32_t y2 = smem_u32(y2t), gd = smem_u32(gt), dz_desc = smem_u32(dzt);

    float dy[DP / 2], z[HALF_FC / 2], dh[HALF_FC / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dy[i] = 0.f;
#pragma unroll
    for (int i = 0; i < HALF_FC / 2; ++i) z[i] = dh[i] = 0.f;
    float* colpart = p.colpart + (size_t)(blockIdx.x * HALF_WARPS + warp) * p.F;
    int s = 0, ph = 0, prev = -1;
    for (int f0 = 0; f0 < p.F; f0 += HALF_FC) {
      mbar_wait(&full[s], ph);
      if (lead && f0 + HALF_FC >= p.F) {  // the epilogue's x and f32 gradient rows into L2
        prefetch_rows(p.x, m0 + wg * 64, 64, p.M, p.D * 2);
        if (p.gy32) prefetch_rows(p.gy32, m0 + wg * 64, 64, p.M, p.D * 4);
      }
      const uint32_t w1 = smem_u32(smem + S::ST + s * S::STAGE), w2 = w1 + S::W1;
      // z = y2 W1c^T and dh = g W2c, K = D
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_n64<0, 0>(z, sw128_desc(y2 + (kk >> 2) * BOX_BYTES + (kk & 3) * 32, 16, 1024),
                        sw128_desc(w1 + (kk >> 2) * BOX_BYTES + (kk & 3) * 32, 16, 1024), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_n64<0, 1>(dh, sw128_desc(gd + (kk >> 2) * BOX_BYTES + (kk & 3) * 32, 16, 1024),
                        sw128_desc(w2 + kk * 16 * SW_BYTES, BOX_BYTES, 1024), kk > 0);
      wg_commit();
      wg_wait<0>();  // these, and the last chunk's dy2: its stage and the dz tile are free
      acc_fence(z);
      acc_fence(dh);
      acc_fence(dy);
      if (prev >= 0) mbar_arrive(&empty[prev]);
      if (lead) bulk_wait_read();  // the last chunk's h and dz stores have read
      named_sync(1 + wg, 128);
      // h = bf16(gelu(z)), dz = dh gelu'(z): bf16 into the tiles; db1 from the f32 dz
#pragma unroll
      for (int j = 0; j < HALF_FC / 8; ++j) {
        const int c = f0 + 8 * j + 2 * tq;
        const bool cin = c < p.F;
        const float2 b = cin ? ldg_bf16x2(p.b1 + c) : make_float2(0.f, 0.f);
        float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 zz = pre_act<ROUND>(z[4 * j + 2 * h], z[4 * j + 2 * h + 1], b);
          const float d0 = dh[4 * j + 2 * h] * gelu_grad(zz.x);
          const float d1 = dh[4 * j + 2 * h + 1] * gelu_grad(zz.y);
          const int o = swz(lr + 8 * h, 8 * j + 2 * tq);
          *reinterpret_cast<uint32_t*>(ht + o) = pack_bf16(gelu_f(zz.x), gelu_f(zz.y));
          *reinterpret_cast<uint32_t*>(dzt + o) = pack_bf16(d0, d1);
          cs0 += d0;
          cs1 += d1;
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          cs0 += __shfl_xor_sync(0xffffffffu, cs0, o);
          cs1 += __shfl_xor_sync(0xffffffffu, cs1, o);
        }
        if (g == 0 && cin) *reinterpret_cast<float2*>(colpart + c) = make_float2(cs0, cs1);
      }
      fence_async_smem();
      named_sync(1 + wg, 128);
      if (lead && rows_in) {
        tma_store(&tma_h, ht, f0, m0 + wg * 64);
        tma_store(&tma_dz, dzt, f0, m0 + wg * 64);
        bulk_commit();
      }
      // dy2 += dz W1c, K = the chunk's 64; W1c read MN-major (n = D)
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HALF_FC / 16; ++kk)
        wgmma_w<DP, 0, 1>(dy, sw128_desc(dz_desc + kk * 32, 16, 1024),
                          sw128_desc(w1 + kk * 16 * SW_BYTES, BOX_BYTES, 1024), 1);
      wg_commit();
      if constexpr (S::STAGES == 1) {  // the producer waits on this stage: free it now
        wg_wait<0>();
        acc_fence(dy);
        mbar_arrive(&empty[s]);
      } else {
        prev = s;
      }
      if (++s == S::STAGES) { s = 0; ph ^= 1; }
    }
    wg_wait<0>();
    acc_fence(dy);

    // The LN2 backward, dx = g + LN2'(dy2): the accumulator into shared
    // memory once both warpgroups are done with the y2 tiles and the
    // stages, then a warp per row (lane: columns 64 i + 2 lane, + 1) with
    // the rows' statistics from the prologue, x and the f32 gradient from
    // device memory (prefetched into L2 during the last chunk; eight rows'
    // in one round trip), g from its tile; whole rows of dx stored; each
    // warp's column partials of (dy2 xhat, dy2, g).
    if (lead) bulk_wait_read();
    asm volatile("bar.sync 3, %0;\n" ::"n"(HALF_CONSUMERS) : "memory");
    float* acc = acc_to_smem<DP>(
        dy, reinterpret_cast<float*>(smem + (wg == 0 ? S::Y2 : S::ST)), lr, tq);
    named_sync(1 + wg, 128);
    float2 sc[S::KB], as[S::KB], ab[S::KB], ag[S::KB];
#pragma unroll
    for (int i = 0; i < S::KB; ++i) {
      const int c = 64 * i + 2 * lane;
      sc[i] = c < p.D ? __ldg(reinterpret_cast<const float2*>(p.ln_s + c)) : make_float2(0.f, 0.f);
      as[i] = ab[i] = ag[i] = make_float2(0.f, 0.f);
    }
    constexpr int RB = 8;  // rows whose x and g are loaded in one round trip
#pragma unroll 1
    for (int rb = (warp & 3) * 16; rb < (warp & 3) * 16 + 16; rb += RB) {
      float2 xv[RB][S::KB], gv[RB][S::KB];
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        const int row = m0 + wg * 64 + rb + k;
#pragma unroll
        for (int i = 0; i < S::KB; ++i) {
          const int c = 64 * i + 2 * lane;
          const size_t o = (size_t)row * p.D + c;
          xv[k][i] = gv[k][i] = make_float2(0.f, 0.f);
          if (row < p.M && c < p.D) {
            xv[k][i] = ldg_bf16x2(p.x + o);
            gv[k][i] = p.gy32 ? __ldg(reinterpret_cast<const float2*>(p.gy32 + o))
                              : __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                    tile_at(gt, rb + k, c)));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        const int r = rb + k, row = m0 + wg * 64 + r;
        if (row < p.M) {  // the warp's row: uniform
          const float mu = mu_s[wg * 64 + r], inv = inv_s[wg * 64 + r];
          float2 d[S::KB], xh[S::KB];
          float s1 = 0.f, s2 = 0.f;
#pragma unroll
          for (int i = 0; i < S::KB; ++i) {
            const int c = 64 * i + 2 * lane;
            d[i] = c < p.D ? acc_at<DP>(acc, r, c) : make_float2(0.f, 0.f);
            xh[i] = make_float2((xv[k][i].x - mu) * inv, (xv[k][i].y - mu) * inv);
            const float g0 = d[i].x * sc[i].x, g1 = d[i].y * sc[i].y;
            s1 += g0 + g1;
            s2 += g0 * xh[i].x + g1 * xh[i].y;
          }
          const float m1 = warp_sum(s1) / (float)p.D, m2 = warp_sum(s2) / (float)p.D;
#pragma unroll
          for (int i = 0; i < S::KB; ++i) {
            const int c = 64 * i + 2 * lane;
            if (c < p.D) {
              const size_t o = (size_t)row * p.D + c;
              const float2 g2 = gv[k][i];
              const float r0 = g2.x + (d[i].x * sc[i].x - m1 - xh[i].x * m2) * inv;
              const float r1 = g2.y + (d[i].y * sc[i].y - m1 - xh[i].y * m2) * inv;
              *reinterpret_cast<uint32_t*>(p.dx + o) = pack_bf16(r0, r1);
              if (p.dx32) *reinterpret_cast<float2*>(p.dx32 + o) = make_float2(r0, r1);
              as[i].x += d[i].x * xh[i].x;
              as[i].y += d[i].y * xh[i].y;
              ab[i].x += d[i].x;
              ab[i].y += d[i].y;
              ag[i].x += g2.x;
              ag[i].y += g2.y;
            }
          }
        }
      }
    }
    float* lnpart = p.lnpart + (size_t)(blockIdx.x * HALF_WARPS + warp) * 3 * p.D;
#pragma unroll
    for (int i = 0; i < S::KB; ++i) {
      const int c = 64 * i + 2 * lane;
      if (c < p.D) {
        *reinterpret_cast<float2*>(lnpart + c) = as[i];
        *reinterpret_cast<float2*>(lnpart + p.D + c) = ab[i];
        *reinterpret_cast<float2*>(lnpart + 2 * p.D + c) = ag[i];
      }
    }
    if (lead) bulk_wait();
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

bool half_args_ok(const void* const* ps, int n) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ps[i]) & 15) return false;  // TMA: 16-byte aligned
  return true;
}

template <int DP, bool ROUND>
cudaError_t launch_half_fwd(const HalfArgs& a, const bf16* w1, const bf16* w2,
                            cudaStream_t st) {
  using S = HalfSmem<DP, false>;
  CUtensorMap m1, m2, mx;
  SSRL_TRY(tensor_map(&m1, w1, a.F, a.D, a.D, 64));  // W1 [F][D]: 64 rows by 64 columns
  SSRL_TRY(tensor_map(&m2, w2, a.D, a.F, a.F, DP));  // W2 [D][F]: DP rows by 64 columns
  SSRL_TRY(tensor_map(&mx, a.x, a.M, a.D, a.D, 64));
  auto kernel = mlp_half_fwd_kernel<DP, ROUND>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (attr != cudaSuccess) return attr;
  kernel<<<cdiv(a.M, HALF_ROWS), HALF_THREADS, S::BYTES, st>>>(m1, m2, mx, a);
  return cudaGetLastError();
}

template <int DP, bool ROUND>
cudaError_t launch_half_bwd(const HalfArgs& a, const bf16* w1, const bf16* w2, bf16* y2,
                            bf16* h, bf16* dz, cudaStream_t st) {
  using S = HalfSmem<DP, true>;
  CUtensorMap m1, m2, mx, mg, my, mh, mz;
  SSRL_TRY(tensor_map(&m1, w1, a.F, a.D, a.D, 64));
  SSRL_TRY(tensor_map(&m2, w2, a.D, a.F, a.F, DP));
  SSRL_TRY(tensor_map(&mx, a.x, a.M, a.D, a.D, 64));
  SSRL_TRY(tensor_map(&mg, a.gy, a.M, a.D, a.D, 64));
  SSRL_TRY(tensor_map(&my, y2, a.M, a.D, a.D, 64));
  SSRL_TRY(tensor_map(&mh, h, a.M, a.F, a.F, 64));
  SSRL_TRY(tensor_map(&mz, dz, a.M, a.F, a.F, 64));
  auto kernel = mlp_half_bwd_kernel<DP, ROUND>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (attr != cudaSuccess) return attr;
  kernel<<<cdiv(a.M, HALF_ROWS), HALF_THREADS, S::BYTES, st>>>(m1, m2, mx, mg, my, mh, mz, a);
  return cudaGetLastError();
}

// The kernels by D's padded width (half_dp).
template <bool ROUND>
cudaError_t half_fwd_dp(const HalfArgs& a, const bf16* w1, const bf16* w2, cudaStream_t st) {
  switch (half_dp(a.D)) {
    case 64: return launch_half_fwd<64, ROUND>(a, w1, w2, st);
    case 96: return launch_half_fwd<96, ROUND>(a, w1, w2, st);
    case 144: return launch_half_fwd<144, ROUND>(a, w1, w2, st);
    case 192: return launch_half_fwd<192, ROUND>(a, w1, w2, st);
    default: return launch_half_fwd<256, ROUND>(a, w1, w2, st);
  }
}

template <bool ROUND>
cudaError_t half_bwd_dp(const HalfArgs& a, const bf16* w1, const bf16* w2, bf16* y2, bf16* h,
                        bf16* dz, cudaStream_t st) {
  switch (half_dp(a.D)) {
    case 64: return launch_half_bwd<64, ROUND>(a, w1, w2, y2, h, dz, st);
    case 96: return launch_half_bwd<96, ROUND>(a, w1, w2, y2, h, dz, st);
    case 144: return launch_half_bwd<144, ROUND>(a, w1, w2, y2, h, dz, st);
    case 192: return launch_half_bwd<192, ROUND>(a, w1, w2, y2, h, dz, st);
    default: return launch_half_bwd<256, ROUND>(a, w1, w2, y2, h, dz, st);
  }
}

// Split-K plans of the two weight-gradient products and the scratch they
// and the reductions need.
struct HalfPlan {
  int k_w2, k_w1, parts;
  size_t part, tmp;
};

HalfPlan half_plan(int M, int D, int F) {
  HalfPlan p;
  int s_w2, s_w1;
  p.k_w2 = ssrl::gemm_splitk(D, F, M, &s_w2);
  p.k_w1 = ssrl::gemm_splitk(F, D, M, &s_w1);
  p.parts = HALF_WARPS * cdiv(M, HALF_ROWS);
  p.part = (size_t)(s_w2 > s_w1 ? s_w2 : s_w1) * D * F;
  p.tmp = (size_t)64 * (F > 3 * D ? F : 3 * D);
  return p;
}

size_t half_bwd_carve(Carver& c, int M, int D, int F, bf16** y2, bf16** h, bf16** dz,
                      float** colpart, float** lnpart, float** part, float** tmp) {
  const HalfPlan p = half_plan(M, D, F);
  *y2 = c.take<bf16>((size_t)M * D);
  *h = c.take<bf16>((size_t)M * F);
  *dz = c.take<bf16>((size_t)M * F);
  *colpart = c.take<float>((size_t)p.parts * F);
  *lnpart = c.take<float>((size_t)p.parts * 3 * D);
  *part = c.take<float>(p.part);
  *tmp = c.take<float>(p.tmp);
  return c.off;
}

}  // namespace

namespace ssrl {

cudaError_t mlp_half_fwd(const bf16* x, const BranchParams& p, bf16* out, int M, int D, int F,
                         bool round_z, cudaStream_t st) {
  const void* ptrs[4] = {x, p.wa, p.wb, out};
  if (!mlp_shape_ok(M, D, F) || !half_args_ok(ptrs, 4)) return cudaErrorInvalidValue;
  HalfArgs a{};
  a.x = x; a.out = out; a.ln_s = p.ln_s; a.ln_b = p.ln_b; a.b1 = p.ba; a.b2 = p.bb;
  a.M = M; a.D = D; a.F = F;
  return round_z ? half_fwd_dp<true>(a, p.wa, p.wb, st) : half_fwd_dp<false>(a, p.wa, p.wb, st);
}

size_t mlp_half_bwd_workspace(int M, int D, int F) {
  Carver c{nullptr};
  bf16 *y2, *h, *dz;
  float *colpart, *lnpart, *part, *tmp;
  return half_bwd_carve(c, M, D, F, &y2, &h, &dz, &colpart, &lnpart, &part, &tmp);
}

cudaError_t mlp_half_bwd(const bf16* x, const BranchParams& p, GradIn gy, GradOut dx,
                         const BranchGrads& d, void* ws, int M, int D, int F, bool round_z,
                         cudaStream_t st) {
  const void* ptrs[4] = {x, p.wa, p.wb, gy.op};
  if (!mlp_shape_ok(M, D, F) || !half_args_ok(ptrs, 4)) return cudaErrorInvalidValue;
  const HalfPlan plan = half_plan(M, D, F);
  Carver c{static_cast<char*>(ws)};
  bf16 *y2, *h, *dz;
  float *colpart, *lnpart, *part, *tmp;
  half_bwd_carve(c, M, D, F, &y2, &h, &dz, &colpart, &lnpart, &part, &tmp);
  HalfArgs a{};
  a.x = x; a.ln_s = p.ln_s; a.ln_b = p.ln_b; a.b1 = p.ba; a.b2 = p.bb;
  a.M = M; a.D = D; a.F = F;
  a.gy = gy.op; a.gy32 = gy.f32; a.dx = dx.bf; a.dx32 = dx.f32;
  a.colpart = colpart; a.lnpart = lnpart;
  SSRL_TRY(round_z ? half_bwd_dp<true>(a, p.wa, p.wb, y2, h, dz, st)
                   : half_bwd_dp<false>(a, p.wa, p.wb, y2, h, dz, st));
  // db1, and d ln_s, d ln_b, d b2, from the per-warp partials
  reduce_rows(colpart, plan.parts, F, d.dba, tmp, st);
  reduce_rows(lnpart, plan.parts, 3 * D, d.dln3, tmp, st);
  // dW2 = gy^T h and dW1 = dz^T y2 (split over the M rows)
  GemmArgs w{};
  w.A = gy.op; w.lda = D;
  w.B = h; w.ldb = F;
  w.M = D; w.N = F; w.K = M;
  w.k_chunk = plan.k_w2;
  w.C = part; w.ldc = F; w.c_split = (long long)D * F;
  SSRL_TRY(gemm(GEMM_TN, EPI_F32, w, st));
  reduce_rows(part, cdiv(M, plan.k_w2), D * F, d.dwb, tmp, st);
  GemmArgs w1g{};
  w1g.A = dz; w1g.lda = F;
  w1g.B = y2; w1g.ldb = D;
  w1g.M = F; w1g.N = D; w1g.K = M;
  w1g.k_chunk = plan.k_w1;
  w1g.C = part; w1g.ldc = D; w1g.c_split = (long long)F * D;
  SSRL_TRY(gemm(GEMM_TN, EPI_F32, w1g, st));
  reduce_rows(part, cdiv(M, plan.k_w1), F * D, d.dwa, tmp, st);
  return cudaGetLastError();
}

}  // namespace ssrl

extern "C" {

// x, out: [M][D] bf16; ln_s, ln_b: [D] f32; w1: [F][D], b1: [F], w2: [D][F],
// b2: [D] bf16 (torch Linear layout); z rounded to bf16 unless round_z is 0.
int ssrl_mlp_half_fwd(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                      const void* b1, const void* w2, const void* b2, void* out, int M, int D,
                      int F, int round_z, void* stream) {
  const void* p[6] = {ln_s, ln_b, w1, b1, w2, b2};
  return (int)ssrl::mlp_half_fwd(static_cast<const bf16*>(x), ssrl::branch_params(p),
                                 static_cast<bf16*>(out), M, D, F, round_z != 0,
                                 static_cast<cudaStream_t>(stream));
}

long long ssrl_mlp_half_bwd_workspace(int M, int D, int F) {
  return (long long)ssrl::mlp_half_bwd_workspace(M, D, F);
}

// From x and the gradient at out (gy [M][D] bf16, with its f32 form gy32 or
// null): dx = gy + the half's input gradient, [M][D] bf16 and, where dx32
// is set, f32; dln3 [3][D] f32 = (d ln_s, d ln_b, d b2); dw1 [F][D], db1
// [F], dw2 [D][F] f32.
int ssrl_mlp_half_bwd(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                      const void* b1, const void* w2, const void* gy, const void* gy32,
                      void* dx, void* dx32, void* dln3, void* dw1, void* db1, void* dw2,
                      void* ws, int M, int D, int F, int round_z, void* stream) {
  const void* p[6] = {ln_s, ln_b, w1, b1, w2, nullptr};
  const ssrl::BranchGrads d{static_cast<float*>(dln3), static_cast<float*>(dw1),
                            static_cast<float*>(db1), static_cast<float*>(dw2)};
  return (int)ssrl::mlp_half_bwd(
      static_cast<const bf16*>(x), ssrl::branch_params(p),
      {static_cast<const bf16*>(gy), static_cast<const float*>(gy32)},
      {static_cast<bf16*>(dx), static_cast<float*>(dx32)}, d, ws, M, D, F, round_z != 0,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
