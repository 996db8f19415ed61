// The branch kernels' GEMM on Hopper (sm_90a): wgmma.mma_async fed by TMA.
//
// Replaces the WMMA tile of the first port. Every product of
// csrc/attn_branch.cu and csrc/mlp_branch.cu (ssrl_vit_mae_jepa_tpu/ops/
// block_pallas.py::_ab_fwd/_ab_fwd_only/_ab_bwd/_mb_fwd/_mb_bwd, and through
// csrc/branch.cuh the whole-block and chained-block kernels) runs here:
// the forward x W^T (NT), the data gradients dY W (NN) and the weight
// gradients dY^T X (TN), each with the epilogue of its contract (gemm.cuh).
//
// What bounds it on the H100: K is D = 96-192 (or F = 4D, 3D), so an
// output element costs a few hundred MACs against ~2 bf16 bytes of it and
// of its row of A: the products sit at or below the card's ~295 FLOP/byte
// ridge, bound by the bytes of their activations once the tensor cores run
// at wgmma's rate.
//
// What this design does about it:
//   - a persistent grid, one block per SM (two for the GELU epilogues), walks
//     over work units (a 128-row M tile by an N tile, and for TN a split of
//     K); units are ordered with N tiles (and for TN the M and N tiles)
//     fastest, so blocks that run at the same time read the same rows of A
//     and B, once from device memory;
//   - one producer warp keeps a ring of 2-4 shared-memory stages full by TMA
//     (cp.async.bulk.tensor, 128-byte swizzle, out-of-bounds rows and
//     columns zero-filled), signalling mbarriers; it runs ahead into the
//     next unit while the consumers finish this one;
//   - two consumer warpgroups each issue wgmma.mma_async m64nBNk16 on their
//     64 rows, straight from shared memory; K-major operands (A of NT and
//     NN, B of NT) and MN-major ones (B of NN, both of TN: the descriptor's
//     transpose bits) are read in place, so nothing is transposed;
//   - the N tile is the output width where it is <= 192 (96, 144, 192) and
//     an even split of it above (gemm_bn), so no column block idles; the
//     GELU epilogues take 96 columns, two blocks a SM;
//   - every epilogue works on the accumulator registers: no f32 staging
//     tile; f32 results are stored 8 bytes a thread as they lie; bf16
//     results go into a bf16 tile in shared memory and out by TMA stores
//     that drain while the next unit runs, and the bf16 tensor an epilogue
//     reads (the residual, the GELU's pre-activation) comes in by TMA into
//     the same tile while the unit's products run (direct 4-8-byte loads
//     and stores, 16 rows a warp instruction, took twice as long on fc1);
//     the GELU backward's column sums go warp shuffle -> shared memory ->
//     one fixed-order sum a column, per M tile;
//   - weight gradients are split over K into f32 partials that
//     common.cuh::reduce_rows sums in a fixed order: no atomics, the same
//     bits on every call.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; no libcuda link)
#include <stdint.h>

#include "common.cuh"
#include "gemm.cuh"

namespace {

constexpr int GEMM_STAGES = 4;
constexpr int GEMM_CONSUMERS = 256;                 // two warpgroups
constexpr int GEMM_THREADS = GEMM_CONSUMERS + 32;   // + one producer warp
constexpr int SW_BYTES = 128;                       // the swizzle span: 64 bf16
constexpr int BOX_BYTES = 64 * kGemmBK * 2;         // a 64 x 64 bf16 box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// the box of `map` at (c0 innermost, c1) into dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// the box of `map` at (c0 innermost, c1) from src (bulk group of this thread)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// until this thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory, visible to the async proxy (TMA)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// barrier `id` over `n` threads
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across wgmma
template <int R>
__device__ __forceinline__ void acc_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1). The
// atoms are 8 rows of 128 bytes, 1024-byte aligned (base offset 0).
//   K-major (rows of 64 k): LBO unused (1), SBO = 1024 between 8-row groups;
//   MN-major (rows of 64 m or n at one k): LBO = the stride between 64-wide
//   boxes, SBO = 1024 between groups of 8 k.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> f32, both operands from shared
// memory; TA/TB: 1 = MN-major (transposed) operand; acc = 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n96(float (&d)[48], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,\n"
      " %8, %9, %10, %11, %12, %13, %14, %15,\n"
      " %16, %17, %18, %19, %20, %21, %22, %23,\n"
      " %24, %25, %26, %27, %28, %29, %30, %31,\n"
      " %32, %33, %34, %35, %36, %37, %38, %39,\n"
      " %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, %51, %52;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n144(float (&d)[72], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,\n"
      " %8, %9, %10, %11, %12, %13, %14, %15,\n"
      " %16, %17, %18, %19, %20, %21, %22, %23,\n"
      " %24, %25, %26, %27, %28, %29, %30, %31,\n"
      " %32, %33, %34, %35, %36, %37, %38, %39,\n"
      " %40, %41, %42, %43, %44, %45, %46, %47,\n"
      " %48, %49, %50, %51, %52, %53, %54, %55,\n"
      " %56, %57, %58, %59, %60, %61, %62, %63,\n"
      " %64, %65, %66, %67, %68, %69, %70, %71}, "
      "%72, %73, p, 1, 1, %75, %76;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,\n"
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
      " %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (BN == 96) wgmma_n96<TA, TB>(d, a, b, acc);
  else if constexpr (BN == 144) wgmma_n144<TA, TB>(d, a, b, acc);
  else wgmma_n192<TA, TB>(d, a, b, acc);
}

__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The bf16 outputs leave through shared memory and TMA stores: each
// warpgroup writes its 64 rows into slabs of 16 columns (64 rows x 32 bytes,
// the store box), one thread stores them, and the next unit's products run
// while the stores drain. The bf16 tensor an epilogue reads (the residual R,
// the pre-activation Zin) comes in by TMA the same way, into the same tile,
// loaded by the producer while the unit's products run; each thread reads
// its elements there and writes its results in their place.
constexpr int OUT_COLS = 16;
constexpr int OUT_SLAB = 64 * OUT_COLS * 2;

// The GELU epilogues' work (an erf and an exponential an element) leaves
// the tensor cores idle, so they run two blocks a SM on 96-column tiles with
// 2 stages each, one block's epilogue beside the other's products.
template <int EPI>
__host__ __device__ constexpr int gemm_blocks_per_sm() {
  return EPI == EPI_BIAS_GELU || EPI == EPI_GELU_BWD || EPI == EPI_BIAS_GELU32 ||
                 EPI == EPI_GELU32_BWD
             ? 2
             : 1;
}

template <bool AMN, bool BMN, int BN, int EPI>
struct GemmSmem {
  static constexpr bool BWD = EPI == EPI_GELU_BWD || EPI == EPI_GELU32_BWD;
  static constexpr bool TMA_IN = EPI == EPI_BIAS_RESID || EPI == EPI_GELU_BWD;
  // bf16 outputs: none (f32), C, or C and z
  static constexpr int NOUT = EPI == EPI_F32 ? 0 : EPI == EPI_BIAS_GELU ? 2 : 1;
  static constexpr int STAGES = gemm_blocks_per_sm<EPI>() > 1 ? 2 : NOUT == 2 ? 3 : GEMM_STAGES;
  static constexpr int A_BYTES = kGemmBM * kGemmBK * 2;  // two 64-row (or 64-wide) boxes
  static constexpr int B_BOXES = (BN + 63) / 64;
  static constexpr int B_BYTES = BMN ? B_BOXES * BOX_BYTES : BN * SW_BYTES;
  static constexpr int STAGE = A_BYTES + B_BYTES;  // a multiple of 1024
  static constexpr int OUT_TILE = 64 * BN * 2;     // one warpgroup's rows of one output
  static constexpr int OUTS = STAGES * STAGE;      // [NOUT][2 warpgroups][BN / 16 slabs]
  static constexpr int BARS = OUTS + NOUT * 2 * OUT_TILE;
  static constexpr int COLS = BARS + 2 * STAGES * 8 + 4 * 8;  // + in_full, out_free
  static constexpr int BYTES = 1024 + COLS + (BWD ? 8 * BN * 4 : 0);  // + alignment slack
};

// units: m_tiles * n_tiles (* splits for TN), unit u -> split u / (m_tiles *
// n_tiles), then M tile, then N tile fastest; kcs chunks of kGemmBK a split.
template <bool AMN, bool BMN, int BN, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, gemm_blocks_per_sm<EPI>())
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap tma_a,
                     const __grid_constant__ CUtensorMap tma_b,
                     const __grid_constant__ CUtensorMap tma_c,
                     const __grid_constant__ CUtensorMap tma_x, const GemmArgs p, int m_tiles,
                     int n_tiles, int units, int kcs) {
  using S = GemmSmem<AMN, BMN, BN, EPI>;
  constexpr bool BWD = S::BWD;
  constexpr int STAGES = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* in_full = empty + STAGES;  // [2 warpgroups]: their input tile has landed
  uint64_t* out_free = in_full + 2;    // [2]: their last stores have read the tile
  float* colbuf = reinterpret_cast<float*>(smem + S::COLS);  // [8 warps][BN]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], GEMM_CONSUMERS);
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(&in_full[w], 1);
      mbar_init(&out_free[w], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles = m_tiles * n_tiles;

  if (warp == GEMM_CONSUMERS / 32) {
    // producer: one thread issues every load
    if (lane != 0) return;
    int s = 0, ph = 0, k_unit = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int split = u / tiles, t = u - split * tiles;
      const int m0 = (t / n_tiles) * kGemmBM, n0 = (t % n_tiles) * BN;
      const int kb = split * kcs * kGemmBK, ke = min(p.K, kb + kcs * kGemmBK);
      for (int k0 = kb; k0 < ke; k0 += kGemmBK) {
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], S::STAGE);
        uint8_t* a = smem + s * S::STAGE;
        uint8_t* b = a + S::A_BYTES;
        if (AMN) {
          tma_load(a, &tma_a, &full[s], m0, k0);
          tma_load(a + BOX_BYTES, &tma_a, &full[s], m0 + 64, k0);
        } else {
          tma_load(a, &tma_a, &full[s], k0, m0);
        }
        if (BMN) {
#pragma unroll
          for (int j = 0; j < S::B_BOXES; ++j)
            tma_load(b + j * BOX_BYTES, &tma_b, &full[s], n0 + 64 * j, k0);
        } else {
          tma_load(b, &tma_b, &full[s], k0, n0);
        }
        if (++s == STAGES) { s = 0; ph ^= 1; }
      }
      if (S::TMA_IN) {  // each warpgroup's rows of R or Zin, once its tile is free
        const int slabs = min(BN / OUT_COLS, (p.N - n0 + OUT_COLS - 1) / OUT_COLS);
        for (int w = 0; w < 2; ++w) {
          uint8_t* tile = smem + S::OUTS + w * S::OUT_TILE;
          mbar_wait(&out_free[w], (k_unit & 1) ^ 1);
          mbar_expect_tx(&in_full[w], slabs * OUT_SLAB);
          for (int sl = 0; sl < slabs; ++sl)
            tma_load(tile + sl * OUT_SLAB, &tma_x, &in_full[w], n0 + sl * OUT_COLS, m0 + w * 64);
        }
      }
      ++k_unit;
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg*64 .. wg*64+63 of the M tile
  const int wg = warp >> 2;
  const int g = lane >> 2, tq = lane & 3;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int s = 0, ph = 0, k_unit = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++k_unit) {
    const int split = u / tiles, t = u - split * tiles;
    const int mt = t / n_tiles;
    const int m0 = mt * kGemmBM, n0 = (t % n_tiles) * BN;
    const int kb = split * kcs * kGemmBK, ke = min(p.K, kb + kcs * kGemmBK);
    const int nk = (ke - kb + kGemmBK - 1) / kGemmBK;
    int prev = 0;
    for (int i = 0; i < nk; ++i) {
      mbar_wait(&full[s], ph);
      const uint32_t a = smem_u32(smem + s * S::STAGE) + wg * BOX_BYTES;
      const uint32_t b = smem_u32(smem + s * S::STAGE + S::A_BYTES);
      acc_fence(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmBK / 16; ++kk) {
        // a k16 step: 32 bytes along a K-major row, 16 rows of an MN-major box
        const uint64_t da = AMN ? sw128_desc(a + kk * 16 * SW_BYTES, BOX_BYTES, 1024)
                                : sw128_desc(a + kk * 32, 16, 1024);
        const uint64_t db = BMN ? sw128_desc(b + kk * 16 * SW_BYTES, BOX_BYTES, 1024)
                                : sw128_desc(b + kk * 32, 16, 1024);
        wgmma_bn<BN, AMN ? 1 : 0, BMN ? 1 : 0>(acc, da, db, (i > 0 || kk > 0) ? 1 : 0);
      }
      wg_commit();
      acc_fence(acc);
      if (S::NOUT && i == 0 && k_unit > 0 && threadIdx.x % 128 == 0) {
        // the previous unit's stores have read the output tile
        bulk_wait_read();
        if (S::TMA_IN) mbar_arrive(&out_free[wg]);
      }
      wg_wait<1>();  // the previous stage's products are done: release it
      if (i > 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == STAGES) { s = 0; ph ^= 1; }
    }
    wg_wait<0>();
    acc_fence(acc);
    mbar_arrive(&empty[prev]);

    // epilogue from the accumulator: thread (warp w, lane g*4+tq) holds, for
    // each 8-column block j, rows r and r + 8 at columns c, c + 1. It goes JC
    // blocks at a time, every load of a step issued before the step's first
    // store, so that the loads' latencies overlap.
    const int r = m0 + wg * 64 + (warp & 3) * 16 + g;
    const int lr = (warp & 3) * 16 + g;  // the row within the warpgroup's 64
    uint8_t* out_c = smem + S::OUTS + wg * S::OUT_TILE;
    uint8_t* out_z = out_c + 2 * S::OUT_TILE;
    if (S::TMA_IN) {
      mbar_wait(&in_full[wg], k_unit & 1);  // the input tile (after the stores' reads)
    } else if (S::NOUT) {
      named_sync(2 + wg, 128);  // thread 0 has seen the previous stores read the tile
    }
    constexpr bool HAS_BIAS = EPI == EPI_BIAS_BF16 || EPI == EPI_BIAS_RESID ||
                              EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU32;
    constexpr int JC = gemm_blocks_per_sm<EPI>() > 1 ? 3 : 6;
    static_assert((BN / 8) % JC == 0, "the epilogue steps must tile BN");
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += JC) {
      float2 bias[JC], in2[JC][2];
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) {
        const int c = n0 + 8 * (j0 + jj) + 2 * tq;
        bias[jj] = make_float2(0.f, 0.f);
        if (HAS_BIAS && c < p.N) bias[jj] = ld_bf16x2(p.bias + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + 8 * h;
          const size_t o = (size_t)row * p.ldc + c;
          in2[jj][h] = make_float2(0.f, 0.f);
          if constexpr (S::TMA_IN) {  // from the tile: rows of 32 bytes in 16-column slabs
            const int j = j0 + jj;
            in2[jj][h] = ld_bf16x2(reinterpret_cast<const bf16*>(
                out_c + (j >> 1) * OUT_SLAB + (lr + 8 * h) * 32 + (j & 1) * 16 + tq * 4));
          } else if (EPI == EPI_GELU32_BWD && c < p.N && row < p.M) {
            in2[jj][h] = *reinterpret_cast<const float2*>(p.Zin32 + o);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) {
        const int j = j0 + jj;
        const int c = n0 + 8 * j + 2 * tq;
        const bool cin = c < p.N;
        const float2 b2 = bias[jj];
        uint32_t pk[2], pz[2];
        float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + 8 * h;
          const bool in = cin && row < p.M;
          const size_t o = (size_t)row * p.ldc + c;
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          const float2 x = in2[jj][h];
          if (EPI == EPI_F32) {
            if (in)
              *reinterpret_cast<float2*>(static_cast<float*>(p.C) + (size_t)split * p.c_split +
                                         o) = make_float2(v0, v1);
          } else if (EPI == EPI_BF16) {
            pk[h] = pack_bf16(v0, v1);
          } else if (EPI == EPI_BIAS_BF16) {
            pk[h] = pack_bf16(v0 + b2.x, v1 + b2.y);
          } else if (EPI == EPI_BIAS_RESID) {  // x: the residual
            pk[h] = pack_bf16(x.x + rbf(v0 + b2.x), x.y + rbf(v1 + b2.y));
          } else if (EPI == EPI_BIAS_GELU) {
            const float z0 = rbf(v0 + b2.x), z1 = rbf(v1 + b2.y);
            pz[h] = pack_bf16(z0, z1);
            pk[h] = pack_bf16(gelu_f(z0), gelu_f(z1));
          } else if (EPI == EPI_BIAS_GELU32) {
            const float z0 = v0 + b2.x, z1 = v1 + b2.y;
            if (in && p.Zout32) *reinterpret_cast<float2*>(p.Zout32 + o) = make_float2(z0, z1);
            pk[h] = pack_bf16(gelu_f(z0), gelu_f(z1));
          } else if (BWD) {  // x: the pre-activation
            const float d0 = in ? v0 * gelu_grad(x.x) : 0.f;
            const float d1 = in ? v1 * gelu_grad(x.y) : 0.f;
            pk[h] = pack_bf16(d0, d1);
            cs0 += d0;
            cs1 += d1;
          }
        }
        // into the 16-column slab j / 2: rows of 32 bytes
        const int so = (j >> 1) * OUT_SLAB + lr * 32 + (j & 1) * 16 + tq * 4;
        if (EPI != EPI_F32) {
          *reinterpret_cast<uint32_t*>(out_c + so) = pk[0];
          *reinterpret_cast<uint32_t*>(out_c + so + 8 * 32) = pk[1];
        }
        if (EPI == EPI_BIAS_GELU) {
          *reinterpret_cast<uint32_t*>(out_z + so) = pz[0];
          *reinterpret_cast<uint32_t*>(out_z + so + 8 * 32) = pz[1];
        }
        if (BWD) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            cs0 += __shfl_xor_sync(0xffffffffu, cs0, o);
            cs1 += __shfl_xor_sync(0xffffffffu, cs1, o);
          }
          if (g == 0) {
            colbuf[warp * BN + 8 * j + 2 * tq] = cs0;
            colbuf[warp * BN + 8 * j + 2 * tq + 1] = cs1;
          }
        }
      }
    }
    if (S::NOUT) {  // the warpgroup's tiles to global memory, by one thread
      fence_async_smem();
      named_sync(2 + wg, 128);
      if (threadIdx.x % 128 == 0) {
        const int rows = m0 + wg * 64;
        for (int sl = 0; sl < BN / OUT_COLS && n0 + sl * OUT_COLS < p.N; ++sl) {
          tma_store(&tma_c, out_c + sl * OUT_SLAB, n0 + sl * OUT_COLS, rows);
          if (EPI == EPI_BIAS_GELU && p.Zout)
            tma_store(&tma_x, out_z + sl * OUT_SLAB, n0 + sl * OUT_COLS, rows);
        }
        bulk_commit();
      }
    }
    if (BWD) {
      // the M tile's column sums: the 8 warps' 16-row sums in a fixed order
      asm volatile("bar.sync 1, %0;\n" ::"n"(GEMM_CONSUMERS) : "memory");
      const int col = threadIdx.x;
      if (col < BN && n0 + col < p.N) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < GEMM_CONSUMERS / 32; ++w) sum += colbuf[w * BN + col];
        p.colpart[(size_t)mt * p.N + n0 + col] = sum;
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(GEMM_CONSUMERS) : "memory");
    }
  }
  if (S::NOUT && threadIdx.x % 128 == 0) bulk_wait();
}

// ---------------------------------------------------------------------------
// Host side: tensor maps (cuTensorMapEncodeTiled through the runtime's
// driver entry point, so the library needs no -lcuda) and the launch.
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess || q != cudaDriverEntryPointSuccess)
      f = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault) != cudaSuccess)
      f = nullptr;
#endif
    return reinterpret_cast<EncodeTiledFn>(f);
  }();
  return fn;
}

// A row-major bf16 matrix (rows x cols, leading dimension ld elements) as
// boxes of box_cols columns by box_rows rows: 64-column boxes, 128-byte
// swizzled, for the operands; 16-column boxes, plain, for the outputs.
inline cudaError_t tensor_map(CUtensorMap* map, const bf16* base, int rows, int cols, int ld,
                              int box_rows, int box_cols = 64) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return cudaErrorSymbolNotFound;  // no cuTensorMapEncodeTiled: fail loudly
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(base), dims,
                         strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, c = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    return c > 0 ? c : 132;
  }();
  return n;
}

inline bool gemm_args_ok(const GemmArgs& p) {
  auto aligned = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; };
  return p.M >= 1 && p.N >= 8 && p.K >= 1 && p.N % 8 == 0 && p.lda % 8 == 0 && p.ldb % 8 == 0 &&
         p.ldc % 8 == 0 && aligned(p.A) && aligned(p.B) && aligned(p.C);
}

template <bool AMN, bool BMN, int BN, int EPI>
cudaError_t launch_sm90(const GemmArgs& p, int splits, cudaStream_t st) {
  using S = GemmSmem<AMN, BMN, BN, EPI>;
  CUtensorMap ta, tb, tc, tx;
  cudaError_t e = AMN ? tensor_map(&ta, p.A, p.K, p.M, p.lda, kGemmBK)
                      : tensor_map(&ta, p.A, p.M, p.K, p.lda, kGemmBM);
  if (e != cudaSuccess) return e;
  e = BMN ? tensor_map(&tb, p.B, p.K, p.N, p.ldb, kGemmBK)
          : tensor_map(&tb, p.B, p.N, p.K, p.ldb, BN);
  if (e != cudaSuccess) return e;
  tc = tx = ta;  // f32 outputs: unused
  if (S::NOUT) {
    e = tensor_map(&tc, static_cast<const bf16*>(p.C), p.M, p.N, p.ldc, 64, OUT_COLS);
    if (e != cudaSuccess) return e;
  }
  // the second bf16 tile: z out, or the epilogue's input
  const bf16* x = S::NOUT == 2 ? p.Zout : EPI == EPI_BIAS_RESID ? p.R : EPI == EPI_GELU_BWD ? p.Zin
                                                                                            : nullptr;
  if (x) {
    e = tensor_map(&tx, x, p.M, p.N, p.ldc, 64, OUT_COLS);
    if (e != cudaSuccess) return e;
  }
  auto kernel = gemm_sm90_kernel<AMN, BMN, BN, EPI>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (attr != cudaSuccess) return attr;
  const int m_tiles = cdiv(p.M, kGemmBM), n_tiles = cdiv(p.N, BN);
  const int kcs = splits > 1 ? p.k_chunk / kGemmBK : cdiv(p.K, kGemmBK);
  const int units = m_tiles * n_tiles * splits;
  const int slots = gemm_blocks_per_sm<EPI>() * sm_count();
  const int grid = units < slots ? units : slots;
  kernel<<<grid, GEMM_THREADS, S::BYTES, st>>>(ta, tb, tc, tx, p, m_tiles, n_tiles, units, kcs);
  return cudaGetLastError();
}

template <bool AMN, bool BMN, int EPI>
cudaError_t launch_bn(const GemmArgs& p, int splits, cudaStream_t st) {
  if (!gemm_args_ok(p)) return cudaErrorInvalidValue;
  if constexpr (gemm_blocks_per_sm<EPI>() > 1) {
    return launch_sm90<AMN, BMN, 96, EPI>(p, splits, st);
  } else {
    switch (ssrl::gemm_bn(p.N)) {
      case 96: return launch_sm90<AMN, BMN, 96, EPI>(p, splits, st);
      case 144: return launch_sm90<AMN, BMN, 144, EPI>(p, splits, st);
      default: return launch_sm90<AMN, BMN, 192, EPI>(p, splits, st);
    }
  }
}

}  // namespace
