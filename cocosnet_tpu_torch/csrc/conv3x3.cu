// Fused 3x3 stride-1 convolution with an optional instance-norm statistics
// epilogue, NHWC activations, HWIO weights.
//
// Replaces: cocosnet_tpu/ops/pallas_conv.py `_conv3x3_pallas` (`_conv_kernel`
// + `_mxu_tail`), reached as `conv3x3_fused`, `conv3x3_fused_stats` and the
// dx of the fused conv's backward (`_bwd`).
//
// Bound on the H100: operations. At the flagship shapes (64..512 channels,
// 64x64..256x256 pixels, batch 6) a conv does 2*B*H*W*9*Cin*Cout flops on
// bf16 operands against ~2 bytes per activation element, far above the
// card's ~295 flop/byte balance point, so the tensor cores are the limit.
//
// Design: implicit GEMM, M = output pixels of one sample, N = Cout, K = 9
// taps x Cin. A tile is TM output pixels of one sample (so its statistics
// are that sample's) x TN output channels. Its K loop walks the 9 taps x
// Cin in stages of BK = 64 channels of one tap; the A tile of a stage is the
// tap-shifted input pixels, read straight from the NHWC tensor (no copy of
// the input with its ring, no im2col); the last stage of a tap issues only
// the k16 steps that hold channels (407 channels: 6 x 64 + 32, not 7 x 64).
//
// bf16 (the flagship's type), warp-specialized for Hopper. A block is three
// warpgroups, one block an SM, a persistent grid of at most one block an
// SM walking the tiles t = blockIdx.x, + gridDim.x, ... in the same order in
// every role, with no state carried from one launch to the next (the
// serve graph replays it). The shared memory holds a ring of 4-8 stages
// (as many as 227 KB take), each with a full barrier (its copies have
// landed), an empty barrier (the consumers are done with it) and, on the
// box path, a ready barrier (its ring cells are in).
// - The producer (warpgroup 0, its registers cut to 56 by setmaxnreg)
//   waits on a stage's empty barrier, then starts the B tile (TN output
//   channels x 64, from a copy of the weights that k_major_weights_kernel
//   lays out tile by tile exactly as the tile lands, swizzle included; at a
//   tile's last stage also the tile's bias) as bulk copies completing on
//   the full barrier, and fills the A tile one of two ways:
//   "box" (where the tile is whole row segments of the image): one tensor
//   copy (TMA) a row segment at the tap's shifted coordinates, zeros
//   outside the image (the zero ring); the reflect ring's rows by the row
//   coordinate, its cells in the first and last column by warp 1 from the
//   segment's own rows once the copy has landed (then the ready barrier);
//   "gather": every producer thread copies its 16-byte chunks of the rows
//   by cp.async, the zero or reflect ring in the per-row source index
//   (computed once per tap), and hands the full barrier an arrival that
//   lands with its copies (cp.async.mbarrier.arrive).
// - Two consumer warpgroups (224 registers each) wait on the full (and
//   ready) barrier, run wgmma m64nWNk16 on the stage, both operands K-major
//   in shared memory with the 128-byte swizzle, accumulators in registers,
//   and keep one group in flight (wait_group 1): the stage before goes back
//   to the producer through its empty barrier (one arrival a consumer warp)
//   once its group has completed. No __syncthreads() in the K loop. At a
//   tile's end the consumers run the epilogue while the producer already
//   fills the ring for the next tile.
// The epilogue works from the accumulators: f32 bias, LeakyReLU, one
// rounding to bf16 into a staging buffer, stored from there as whole rows;
// the statistics variant reduces each column's sum and sum of squares over
// the tile's valid rows (shuffles, then the warps in a fixed order through
// shared memory, between named barriers of the consumers) and writes
// per-(sample, pixel tile, channel) partials, reduced outside in a fixed
// order (deterministic, no atomics).
//
// The tile rule (ops/conv3x3.py `tile_config`, from (B, H, W, Cin, Cout)
// alone) picks (TM, TN) from COCOSNET_CONV3X3_TILES and the path: TM 256 or
// 128 (each consumer TM / 2 pixel rows x TN) or 64 (both consumers the 64
// rows, each TN / 2 columns), TN 64, 128, 144, 208 or 256 (407 channels: 2
// x 208, not 4 x 128). It minimizes a model of the call's time: rounds of
// tiles over the SMs x the K steps of a tile x the longer of a k-step's
// tensor time and its operand traffic, plus a fixed cost a step, its
// constants fitted to the flagship's shapes on the H100. What bounds a
// shape (PERF.md): the 64 x 64 maps of 128 to 512 channels at B6 run 128 x
// 256 tiles in three rounds, their stages fed near the shared memory's and
// the L2's rate; the 256 x 256 maps of 64 to 154 channels 256-pixel tiles
// by tensor copy; a B1 request's 64 x 64 calls 64-pixel tiles, 128 of them
// (one round), bound by the latency of their K steps one after the other.
//
// An input whose channel count is not a multiple of 8 (151, 154 and 407
// at the flagship; the dx launch swaps the counts) is first copied with its
// rows padded to a multiple of 8 channels (conv3x3_common.cuh
// `pad_channels`): both paths need 16-byte rows.
//
// f32 (the parity path): exact f32 FMA from single-buffered shared memory,
// never TF32.

#include <cuda.h>  // CUtensorMap; its encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_common.cuh"

namespace {

using conv3x3::ring;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;  // output pixels per block of the f32 path
constexpr int NT = 256;

// ------------------------------------------------------------ bf16 path

constexpr int BK = 64;           // channels a stage: one 128-byte swizzle row
constexpr int WG = 128;          // threads of a warpgroup
constexpr int WS_THREADS = 3 * WG;  // the producer and two consumers
constexpr int SMEM_MAX = 232448;    // dynamic shared memory a block may use
// setmaxnreg: 128 x 56 + 256 x 224 = 64512 of the SM's 65536 registers
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;

// A tile of TM output pixels x TN output channels. TM 128 or 256: consumer
// warpgroup g owns the WM = TM / 2 pixel rows from g WM and every column;
// TM 64: both own the 64 rows, g the WN = TN / 2 columns from g WN. A
// warpgroup runs WM / 64 wgmma m64nWNk16 a k16 step. The shared memory, from
// a base rounded up to 1024 bytes (the swizzle's period): STAGES x (A: TM
// rows, B: TN rows of 128 bytes), each K-major with the 128-byte swizzle
// (16-byte chunk c of row r at r * 128 + (c ^ (r % 8)) * 16, the layout of
// the wgmma descriptors and of the tensor copies, so that neither the
// copies nor the wgmma reads conflict on banks); then the epilogue's 2 x 16
// KB, a staging buffer of two 64 x 64 bf16 blocks for each consumer
// warpgroup, which first holds the statistics' per-warp sums [2][8][TN]
// f32; then the tile's bias (TN f32); then the full, empty and ready
// barriers of each stage.
template <int TM, int TN>
struct Tile {
  static constexpr int WM = TM == 64 ? 64 : TM / 2;
  static constexpr int WN = TM == 64 ? TN / 2 : TN;
  static constexpr int MS = WM / 64;   // m64 wgmma a k16 step
  static constexpr int NACC = WN / 2;  // f32 accumulators of one m64
  static constexpr int A_BYTES = TM * 128;
  static constexpr int B_BYTES = TN * 128;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGING = 16384;  // a consumer warpgroup's
  static constexpr int FIT =
      (SMEM_MAX - 1024 - 2 * STAGING - TN * 4 - 3 * 8 * 8) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGING +
                              TN * 4 + 3 * STAGES * 8;
  static_assert(STAGES >= 4, "a ring of at least 4 stages");
  static_assert(WN % 8 == 0 && WN <= 256 && MS * NACC <= 128 && TN <= 2 * WG,
                "tile widths");
  static_assert(2 * 8 * TN * 4 <= 2 * STAGING, "statistics");
};

__device__ __forceinline__ int swizzle128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled tile at
// addr: stride between 8-row groups 1024 bytes, layout type 1 (128B swizzle)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x N per warpgroup, f32) += A (64 x 16) B (16 x N), bf16, both
// operands K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da,
                                           uint64_t db);

// The operand lists of wgmma m64nNk16, N / 8 groups of four accumulators:
// COCOSNET_S<g> names them in the instruction, COCOSNET_R<g> binds them.
#define COCOSNET_F4(i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define COCOSNET_S1 "%0, %1, %2, %3"
#define COCOSNET_S2 COCOSNET_S1 ", %4, %5, %6, %7"
#define COCOSNET_S3 COCOSNET_S2 ", %8, %9, %10, %11"
#define COCOSNET_S4 COCOSNET_S3 ", %12, %13, %14, %15"
#define COCOSNET_S5 COCOSNET_S4 ", %16, %17, %18, %19"
#define COCOSNET_S6 COCOSNET_S5 ", %20, %21, %22, %23"
#define COCOSNET_S7 COCOSNET_S6 ", %24, %25, %26, %27"
#define COCOSNET_S8 COCOSNET_S7 ", %28, %29, %30, %31"
#define COCOSNET_S9 COCOSNET_S8 ", %32, %33, %34, %35"
#define COCOSNET_S10 COCOSNET_S9 ", %36, %37, %38, %39"
#define COCOSNET_S11 COCOSNET_S10 ", %40, %41, %42, %43"
#define COCOSNET_S12 COCOSNET_S11 ", %44, %45, %46, %47"
#define COCOSNET_S13 COCOSNET_S12 ", %48, %49, %50, %51"
#define COCOSNET_S14 COCOSNET_S13 ", %52, %53, %54, %55"
#define COCOSNET_S15 COCOSNET_S14 ", %56, %57, %58, %59"
#define COCOSNET_S16 COCOSNET_S15 ", %60, %61, %62, %63"
#define COCOSNET_S17 COCOSNET_S16 ", %64, %65, %66, %67"
#define COCOSNET_S18 COCOSNET_S17 ", %68, %69, %70, %71"
#define COCOSNET_S19 COCOSNET_S18 ", %72, %73, %74, %75"
#define COCOSNET_S20 COCOSNET_S19 ", %76, %77, %78, %79"
#define COCOSNET_S21 COCOSNET_S20 ", %80, %81, %82, %83"
#define COCOSNET_S22 COCOSNET_S21 ", %84, %85, %86, %87"
#define COCOSNET_S23 COCOSNET_S22 ", %88, %89, %90, %91"
#define COCOSNET_S24 COCOSNET_S23 ", %92, %93, %94, %95"
#define COCOSNET_S25 COCOSNET_S24 ", %96, %97, %98, %99"
#define COCOSNET_S26 COCOSNET_S25 ", %100, %101, %102, %103"
#define COCOSNET_S27 COCOSNET_S26 ", %104, %105, %106, %107"
#define COCOSNET_S28 COCOSNET_S27 ", %108, %109, %110, %111"
#define COCOSNET_S29 COCOSNET_S28 ", %112, %113, %114, %115"
#define COCOSNET_S30 COCOSNET_S29 ", %116, %117, %118, %119"
#define COCOSNET_S31 COCOSNET_S30 ", %120, %121, %122, %123"
#define COCOSNET_S32 COCOSNET_S31 ", %124, %125, %126, %127"
#define COCOSNET_R1 COCOSNET_F4(0)
#define COCOSNET_R2 COCOSNET_R1, COCOSNET_F4(4)
#define COCOSNET_R3 COCOSNET_R2, COCOSNET_F4(8)
#define COCOSNET_R4 COCOSNET_R3, COCOSNET_F4(12)
#define COCOSNET_R5 COCOSNET_R4, COCOSNET_F4(16)
#define COCOSNET_R6 COCOSNET_R5, COCOSNET_F4(20)
#define COCOSNET_R7 COCOSNET_R6, COCOSNET_F4(24)
#define COCOSNET_R8 COCOSNET_R7, COCOSNET_F4(28)
#define COCOSNET_R9 COCOSNET_R8, COCOSNET_F4(32)
#define COCOSNET_R10 COCOSNET_R9, COCOSNET_F4(36)
#define COCOSNET_R11 COCOSNET_R10, COCOSNET_F4(40)
#define COCOSNET_R12 COCOSNET_R11, COCOSNET_F4(44)
#define COCOSNET_R13 COCOSNET_R12, COCOSNET_F4(48)
#define COCOSNET_R14 COCOSNET_R13, COCOSNET_F4(52)
#define COCOSNET_R15 COCOSNET_R14, COCOSNET_F4(56)
#define COCOSNET_R16 COCOSNET_R15, COCOSNET_F4(60)
#define COCOSNET_R17 COCOSNET_R16, COCOSNET_F4(64)
#define COCOSNET_R18 COCOSNET_R17, COCOSNET_F4(68)
#define COCOSNET_R19 COCOSNET_R18, COCOSNET_F4(72)
#define COCOSNET_R20 COCOSNET_R19, COCOSNET_F4(76)
#define COCOSNET_R21 COCOSNET_R20, COCOSNET_F4(80)
#define COCOSNET_R22 COCOSNET_R21, COCOSNET_F4(84)
#define COCOSNET_R23 COCOSNET_R22, COCOSNET_F4(88)
#define COCOSNET_R24 COCOSNET_R23, COCOSNET_F4(92)
#define COCOSNET_R25 COCOSNET_R24, COCOSNET_F4(96)
#define COCOSNET_R26 COCOSNET_R25, COCOSNET_F4(100)
#define COCOSNET_R27 COCOSNET_R26, COCOSNET_F4(104)
#define COCOSNET_R28 COCOSNET_R27, COCOSNET_F4(108)
#define COCOSNET_R29 COCOSNET_R28, COCOSNET_F4(112)
#define COCOSNET_R30 COCOSNET_R29, COCOSNET_F4(116)
#define COCOSNET_R31 COCOSNET_R30, COCOSNET_F4(120)
#define COCOSNET_R32 COCOSNET_R31, COCOSNET_F4(124)

// wgmma m64nNk16 with its N / 2 accumulators %0 .. %(N/2 - 1), then the
// descriptors %IA, %IB and the scale-d flag %IP
#define COCOSNET_WGMMA(N, G, IA, IB, IP)                                    \
  template <>                                                              \
  __device__ __forceinline__ void wgmma_bf16<N>(float (&d)[N / 2],         \
                                                uint64_t da, uint64_t db) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IP ", 0;\n"         \
                 "wgmma.mma_async.sync.aligned.m64n" #N                    \
                 "k16.f32.bf16.bf16 {" COCOSNET_S##G "}, %" #IA ", %" #IB  \
                 ", p, 1, 1, 0, 0;\n}\n"                                   \
                 : COCOSNET_R##G                                           \
                 : "l"(da), "l"(db), "r"(1));                              \
  }

COCOSNET_WGMMA(32, 4, 16, 17, 18)
COCOSNET_WGMMA(64, 8, 32, 33, 34)
COCOSNET_WGMMA(72, 9, 36, 37, 38)
COCOSNET_WGMMA(104, 13, 52, 53, 54)
COCOSNET_WGMMA(128, 16, 64, 65, 66)
COCOSNET_WGMMA(144, 18, 72, 73, 74)
COCOSNET_WGMMA(208, 26, 104, 105, 106)
COCOSNET_WGMMA(256, 32, 128, 129, 130)

// ---- mbarriers, bulk and tensor copies, per-thread copies

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// spins until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          bar)
      : "memory");
}

// one arrival that also expects `bytes` more of transfers on the phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

// `bytes` contiguous bytes global -> shared by the copy engine, completing
// that many transfer bytes on the barrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the box of the 4-D tensor map at (c, w, h, b) -> shared memory in the
// map's swizzle, completing its bytes on the barrier; cells outside the
// tensor read zeros
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c,
                                            int w, int h, int b,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(b),
      "r"(bar)
      : "memory");
}

// one arrival on the barrier once this thread's cp.async copies so far have
// landed (the arrival is counted in the barrier's init count)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

struct ConvArgs {
  CUtensorMap xmap;  // the box path: x as (ldx, W, H, B), boxes (64, sw, 1, 1)
  const bf16* x;     // (B, H, W, ldx): rows ldx elements apart
  const bf16* wt;    // the tiled K-major weights (k_major_weights_kernel)
  const float* bt;   // the bias, zeros past Cout, n_tiles x TN (its tail)
  bf16* out;         // (B, H, W, Cout)
  float* stats;      // null or (B, m_tiles, 2, Cout)
  int H, W, Cin, Cout, ldx, reflect, has_leaky;
  float slope;
  int kc;        // stages a tap: ceil(ldx / BK)
  int last_k16;  // k16 steps of a tap's last stage
  int m_tiles, n_tiles, tiles;
  int sw;  // pixels of a box (a row segment of the tile), or 0: the gather
};

// the tile of this block's q-th stage, and its tap and first channel
struct StageAt {
  int nt, mt, b, j, tap, c0;
  __device__ StageAt(const ConvArgs& a, int q, int nst) {
    const int t = blockIdx.x + (q / nst) * gridDim.x;
    j = q - (q / nst) * nst;
    nt = t % a.n_tiles;
    mt = (t / a.n_tiles) % a.m_tiles;
    b = t / (a.n_tiles * a.m_tiles);
    tap = j / a.kc;
    c0 = (j - tap * a.kc) * BK;
  }
};

// x rows (pixels) ldx elements apart (Cin, or its padded copy's multiple of
// 8). A tile's K loop: 9 taps x kc stages of BK channels, the last stage of
// a tap cut to the k16 steps that hold channels.
template <int TM, int TN>
__global__ void __launch_bounds__(WS_THREADS, 1)
    conv3x3_bf16_kernel(const __grid_constant__ ConvArgs a) {
  using T = Tile<TM, TN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = conv3x3::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* staging =
      smem_raw + (base - raw) + T::STAGES * T::STAGE_BYTES;
  float* red = reinterpret_cast<float*>(staging);
  const float* sbias = reinterpret_cast<const float*>(staging +
                                                      2 * T::STAGING);
  const uint32_t sbias_at = base + T::STAGES * T::STAGE_BYTES +
                            2 * T::STAGING;
  const uint32_t full0 = sbias_at + TN * 4;
  const uint32_t empty0 = full0 + 8 * T::STAGES;
  const uint32_t ready0 = empty0 + 8 * T::STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      // the box path: the copies' bytes and one arrival; the gather: every
      // producer thread's cp.async as well
      mbar_init(full0 + 8 * s, a.sw ? 1 : WG + 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival a consumer warp
      mbar_init(ready0 + 8 * s, 32);  // the box path's ring cells: warp 1
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int HW = a.H * a.W, nst = 9 * a.kc;
  // stages of this block: its tiles blockIdx.x, + gridDim.x, ... x nst
  const int total = (a.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * nst;

  if (tid < WG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (a.sw) {
      // ---- producer, box path (the tile is TM / sw row segments of sw
      // pixels, sw = min(TM, W)). For every stage, once its slot is free:
      // one thread of warp 0 starts a tensor copy a row segment (the
      // tap-shifted pixels x 64 channels, zeros outside the image: the
      // zero ring; the reflect ring's rows by the row coordinate) and the
      // weights (at a tile's last stage also its bias) by bulk copy, all
      // completing on the full barrier. Warp 1 fills the reflect ring's
      // cells (a segment's first pixel at tap column 0, its last at column
      // 2, where the segment meets the image's edge) from the segment's
      // own rows once the copies have landed, and arrives on the stage's
      // ready barrier; on other stages it arrives at once. So the copies
      // never wait for the ring.
      if (warp > 1) return;
      const int nseg = TM / a.sw;
      int stage = 0;
      uint32_t phase = 0;
      for (int q = 0; q < total; ++q) {
        const StageAt st(a, q, nst);
        const uint32_t full = full0 + 8 * stage;
        const uint32_t sa = base + stage * T::STAGE_BYTES;
        const int m0 = st.mt * TM, oh0 = m0 / a.W, ow0 = m0 - oh0 * a.W;
        const int dy = st.tap / 3, dx = st.tap % 3;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        if (warp == 0) {
          if (lane == 0) {
            const bool last = st.j == nst - 1;
            mbar_arrive_expect_tx(
                full, T::A_BYTES + T::B_BYTES + (last ? TN * 4 : 0));
            for (int s = 0; s < nseg; ++s) {
              int r = oh0 + s + dy - 1;
              if (a.reflect) r = ring(r, a.H, true);
              tma_load_4d(sa + s * a.sw * 128, &a.xmap, st.c0, ow0 + dx - 1,
                          r, st.b, full);
            }
            bulk_load(sa + T::A_BYTES,
                      a.wt + ((size_t)st.nt * nst + st.j) * TN * BK,
                      T::B_BYTES, full);
            if (last) bulk_load(sbias_at, a.bt + st.nt * TN, TN * 4, full);
          }
          __syncwarp();
        } else {
          if (a.reflect && dx != 1 &&
              (dx == 0 ? ow0 == 0 : ow0 + a.sw == a.W)) {
            // the reflected cell is in the segment already: at tap column
            // 0, row 0 (pixel -1) takes row 2's (pixel 1); at column 2, row
            // sw - 1 (pixel W) takes row sw - 3's (pixel W - 2)
            mbar_wait(full, phase);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            const int sg = lane >> 3, ch = lane & 7;
            if (sg < nseg) {
              unsigned char* tile = smem_raw + (sa - raw);
              const int row = sg * a.sw + (dx == 0 ? 0 : a.sw - 1);
              const int src = dx == 0 ? row + 2 : row - 2;
              *reinterpret_cast<uint4*>(tile + swizzle128(row, ch)) =
                  *reinterpret_cast<const uint4*>(tile + swizzle128(src, ch));
            }
          }
          mbar_arrive(ready0 + 8 * stage);
        }
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      return;
    }
    // ---- producer, gather path: for every stage, wait for its slot, then
    // the weights (and at a tile's last stage its bias) by bulk copy and
    // the tap-shifted pixel rows by cp.async, chunk lc = tid % 8 of rows lr
    // + 16 i
    const int lc = tid & 7, lr = tid >> 3;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      const int nt = t % a.n_tiles, mt = (t / a.n_tiles) % a.m_tiles;
      const int b = t / (a.n_tiles * a.m_tiles), m0 = mt * TM;
      const bf16* xb = a.x + (size_t)b * HW * a.ldx;
      const bf16* wtile = a.wt + (size_t)nt * nst * TN * BK;
      int pix[TM / 16];  // source pixel of each row at the tap, or -1
      for (int j = 0, tap = 0, c0 = 0; j < nst; ++j) {
        if (c0 == 0) {
          const int dy = tap / 3, dx = tap % 3;
#pragma unroll
          for (int i = 0; i < TM / 16; ++i) {
            const int p = m0 + lr + 16 * i;
            int src = -1;
            if (p < HW) {
              const int oh = p / a.W;
              const int r = ring(oh + dy - 1, a.H, a.reflect);
              const int c = ring(p - oh * a.W + dx - 1, a.W, a.reflect);
              if (r >= 0 && c >= 0) src = r * a.W + c;
            }
            pix[i] = src;
          }
        }
        const uint32_t full = full0 + 8 * stage;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t sa = base + stage * T::STAGE_BYTES;
        if (tid == 0) {
          const bool last = j == nst - 1;
          mbar_arrive_expect_tx(full, T::B_BYTES + (last ? TN * 4 : 0));
          bulk_load(sa + T::A_BYTES, wtile + (size_t)j * TN * BK, T::B_BYTES,
                    full);
          if (last) bulk_load(sbias_at, a.bt + nt * TN, TN * 4, full);
        }
        const int c = c0 + 8 * lc;
#pragma unroll
        for (int i = 0; i < TM / 16; ++i) {
          const bool ok = pix[i] >= 0 && c < a.ldx;
          conv3x3::cp_async16(sa + swizzle128(lr + 16 * i, lc),
                        ok ? xb + (size_t)pix[i] * a.ldx + c : xb, ok);
        }
        cp_async_arrive(full);
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
        c0 += BK;
        if (c0 >= a.ldx) {
          c0 = 0;
          ++tap;
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumers: wgmma on each stage as it arrives, one group left in
  // flight; a stage goes back to the producer once the group that read it
  // has completed
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int ct = tid - WG, g = ct >> 7, cw = ct >> 5;  // cw: consumer warp
  const int row0 = TM == 64 ? 0 : g * T::WM, col0 = TM == 64 ? g * T::WN : 0;
  int stage = 0;
  uint32_t phase = 0;
  float d[T::MS][T::NACC];
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const int nt = t % a.n_tiles, mt = (t / a.n_tiles) % a.m_tiles;
    const int b = t / (a.n_tiles * a.m_tiles), m0 = mt * TM, n0 = nt * TN;
#pragma unroll
    for (int ms = 0; ms < T::MS; ++ms)
#pragma unroll
      for (int i = 0; i < T::NACC; ++i) d[ms][i] = 0.f;
    int prev = 0;
    for (int j = 0, kc = 0; j < nst; ++j) {
      const int k16 = kc == a.kc - 1 ? a.last_k16 : BK / 16;
      if (++kc == a.kc) kc = 0;
      mbar_wait(full0 + 8 * stage, phase);
      if (a.sw) mbar_wait(ready0 + 8 * stage, phase);
      // the gather's rows (cp.async) and the box path's ring cells came
      // through the generic proxy; wgmma reads through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint32_t sa = base + stage * T::STAGE_BYTES + row0 * 128;
      const uint32_t sb = base + stage * T::STAGE_BYTES + T::A_BYTES +
                          col0 * 128;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)
        if (k < k16)
#pragma unroll
          for (int ms = 0; ms < T::MS; ++ms)
            wgmma_bf16<T::WN>(d[ms], desc_sw128(sa + ms * 64 * 128 + k * 32),
                              desc_sw128(sb + k * 32));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (j > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
      prev = stage;
      if (++stage == T::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (lane == 0) mbar_arrive(empty0 + 8 * prev);

    // epilogue, while the producer fills the ring for the next tile.
    // d[ms][4 j + 2 h + e] holds row 64 ms + (warp % 4) * 16 + lane / 4 +
    // 8 h of the warpgroup's WM and column 8 j + 2 (lane % 4) + e of its
    // WN. Bias (the tile's, in shared memory since its last stage) +
    // LeakyReLU in f32 in place.
#pragma unroll
    for (int j = 0; j < T::WN / 8; ++j) {
      const int col = col0 + 8 * j + 2 * (lane & 3);
      const float b0 = sbias[col], b1 = sbias[col + 1];
#pragma unroll
      for (int ms = 0; ms < T::MS; ++ms)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = d[ms][4 * j + 2 * h] + b0;
          float v1 = d[ms][4 * j + 2 * h + 1] + b1;
          if (a.has_leaky) {
            v0 = v0 >= 0.f ? v0 : a.slope * v0;
            v1 = v1 >= 0.f ? v1 : a.slope * v1;
          }
          d[ms][4 * j + 2 * h] = v0;
          d[ms][4 * j + 2 * h + 1] = v1;
        }
    }
    const int prow = m0 + row0 + (cw & 3) * 16 + (lane >> 2);  // h 0, ms 0
    if (a.stats != nullptr) {
      // each column's sum and sum of squares over the warp's valid rows by
      // shuffles, then over the warps that hold the column, in order,
      // through shared memory (the staging buffers, once both warpgroups
      // are done with them)
      asm volatile("bar.sync 1, %0;\n" ::"n"(2 * WG) : "memory");
#pragma unroll
      for (int j = 0; j < T::WN / 8; ++j) {
        float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
        for (int ms = 0; ms < T::MS; ++ms)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (prow + 64 * ms + 8 * h >= HW) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = d[ms][4 * j + 2 * h + e];
              s1[e] += v;
              s2[e] += v * v;
            }
          }
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], off);
            s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], off);
          }
        if (lane < 4) {
          const int col = col0 + 8 * j + 2 * lane;
          red[cw * TN + col] = s1[0];
          red[cw * TN + col + 1] = s1[1];
          red[(8 + cw) * TN + col] = s2[0];
          red[(8 + cw) * TN + col + 1] = s2[1];
        }
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(2 * WG) : "memory");
      if (ct < TN && n0 + ct < a.Cout) {
        // TM 128, 256: all 8 warps hold the column; TM 64: the 4 of its
        // warpgroup
        const int w0 = TM == 64 ? 4 * (ct / T::WN) : 0;
        const int nw = TM == 64 ? 4 : 8;
        float s = 0.f, q = 0.f;
        for (int w = w0; w < w0 + nw; ++w) {
          s += red[w * TN + ct];
          q += red[(8 + w) * TN + ct];
        }
        float* st = a.stats + ((size_t)b * a.m_tiles + mt) * 2 * a.Cout;
        st[n0 + ct] = s;
        st[a.Cout + n0 + ct] = q;
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(2 * WG) : "memory");
    }

    // the output, rounded once to bf16, through the warpgroup's staging
    // buffer (two blocks of 64 rows x 64 columns, 128 bytes a row in the
    // 128-byte swizzle: no bank conflicts either way), a pass of 128
    // columns at a time, so that the stores to device memory are whole
    // rows: 16 bytes a thread where Cout is a multiple of 8, else 4-byte
    // pairs (a warp's contiguous 128 bytes).
    unsigned char* stg = staging + g * T::STAGING;
    const int wt = ct & 127;
    bf16* out = a.out + (size_t)b * HW * a.Cout;
    auto at = [&](int r, int c) {  // the staged byte offset of (row, column)
      return (c >> 6) * 8192 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
             2 * (c & 7);
    };
#pragma unroll
    for (int ms = 0; ms < T::MS; ++ms)
#pragma unroll
      for (int ps = 0; ps < (T::WN + 127) / 128; ++ps) {
        const int ncol = T::WN - 128 * ps < 128 ? T::WN - 128 * ps : 128;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int j = 16 * ps + jj;
          if (j >= T::WN / 8) break;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = (cw & 3) * 16 + (lane >> 2) + 8 * h;
            *reinterpret_cast<__nv_bfloat162*>(
                stg + at(r, 8 * jj + 2 * (lane & 3))) =
                __floats2bfloat162_rn(d[ms][4 * j + 2 * h],
                                      d[ms][4 * j + 2 * h + 1]);
          }
        }
        asm volatile("bar.sync %0, %1;\n" ::"r"(2 + g), "n"(WG) : "memory");
        const int p0 = m0 + row0 + 64 * ms;
        const int c0 = n0 + col0 + 128 * ps;
        if ((a.Cout & 7) == 0) {
          const int nch = ncol / 8;
          for (int q = wt; q < 64 * nch; q += WG) {
            const int r = q / nch, c = q - r * nch;
            const int p = p0 + r, co = c0 + 8 * c;
            if (p < HW && co < a.Cout)
              *reinterpret_cast<uint4*>(out + (size_t)p * a.Cout + co) =
                  *reinterpret_cast<const uint4*>(stg + at(r, 8 * c));
          }
        } else {
          // a row of the tile starts at any element: one 2-byte store
          // where the row starts odd, then 4-byte pairs, the last element
          // alone where one is left
          const int nvalid = a.Cout - c0 < ncol ? a.Cout - c0 : ncol;
          for (int r = cw & 3; r < 64; r += 4) {
            const int p = p0 + r;
            if (p >= HW || nvalid <= 0) continue;
            const size_t e = (size_t)p * a.Cout + c0;
            const int o = (int)(e & 1), units = (nvalid + o + 1) >> 1;
            auto el = [&](int c) {
              return *reinterpret_cast<const unsigned short*>(stg + at(r, c));
            };
            for (int u = lane; u < units; u += 32) {
              const int c = 2 * u - o;
              unsigned short* dst =
                  reinterpret_cast<unsigned short*>(out + e) + c;
              if (c < 0)
                dst[1] = el(0);
              else if (c + 1 < nvalid)
                *reinterpret_cast<uint32_t*>(dst) =
                    el(c) | ((uint32_t)el(c + 1) << 16);
              else
                dst[0] = el(c);
            }
          }
        }
        asm volatile("bar.sync %0, %1;\n" ::"r"(2 + g), "n"(WG) : "memory");
      }
  }
}

// wt = the (9, Cin, Cout) weights w as the kernel's B tiles, laid out as
// they land in shared memory: for each output-channel tile nt, tap and
// stage kc, TN rows (output channels nt TN ..) of BK channels (kc BK ..),
// 128 bytes a row in the 128-byte swizzle, zeros past Cout and Cin; then bt,
// the bias as n_tiles x TN f32, zeros past Cout. Each thread writes 16
// bytes of wt; neighbouring threads read neighbouring Cout.
__global__ void k_major_weights_kernel(const bf16* __restrict__ w,
                                       const float* __restrict__ bias,
                                       bf16* __restrict__ wt,
                                       float* __restrict__ bt, int Cin,
                                       int Cout, int TN, int n_tiles,
                                       int kc) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(w);
  const int np = n_tiles * TN, cpt = kc * BK / 8;  // chunks a tap
  const long long n = 9LL * cpt * np;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long q = first; q < np; q += step)
    bt[q] = q < Cout ? bias[q] : 0.f;
  for (long long q = first; q < n; q += step) {
    const int co = (int)(q % np);
    const long long tj = q / np;
    const int j = (int)(tj % cpt), tap = (int)(tj / cpt);
    uint32_t e[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = 8 * j + k;
      e[k] = c < Cin && co < Cout
                 ? __ldg(s + ((size_t)tap * Cin + c) * Cout + co)
                 : 0u;
    }
    const int nt = co / TN, r = co - nt * TN;
    const size_t block = ((size_t)nt * 9 + tap) * kc + j / 8;
    *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(
        wt + block * TN * BK) + swizzle128(r, j % 8)) =
        make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                   e[4] | (e[5] << 16), e[6] | (e[7] << 16));
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// the driver library), or null
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                   cudaEnableDefault, &q) == cudaSuccess &&
                   q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The box path where a tile is whole row segments of the image: sw = TM
// pixels of one row (W a multiple of TM) or TM / W <= 4 whole rows (TM a
// multiple of W, W a multiple of 8); then x's tensor map, boxes of 64
// channels x sw pixels. Else sw = 0, the gather path.
void box_path(ConvArgs& a, int B, int tm, int box) {
  a.sw = 0;
  const int W = a.W;
  EncodeTiled encode = encode_tiled();
  const int sw = tm <= W ? (W % tm == 0 ? tm : 0)
                         : (tm % W == 0 && tm / W <= 4 && W % 8 == 0 ? W : 0);
  if (!box || sw == 0 || encode == nullptr) return;
  const cuuint64_t dims[4] = {(cuuint64_t)a.ldx, (cuuint64_t)W,
                              (cuuint64_t)a.H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)a.ldx * 2,
                                 (cuuint64_t)W * a.ldx * 2,
                                 (cuuint64_t)a.H * W * a.ldx * 2};
  const cuuint32_t xbox[4] = {BK, (cuuint32_t)sw, 1, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (encode(&a.xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<bf16*>(a.x), dims, strides, xbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS)
    a.sw = sw;
}

template <int TM, int TN>
cudaError_t launch_bf16(const ConvArgs& a, int sms, cudaStream_t s) {
  auto kern = conv3x3_bf16_kernel<TM, TN>;
  constexpr int smem = Tile<TM, TN>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int grid = a.tiles < sms ? a.tiles : sms;
  kern<<<grid, WS_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

// The tiles the kernel is instantiated for, (TM, TN): ops/conv3x3.py
// CONV_TILES, which chooses one a call, holds the same list.
#define COCOSNET_CONV3X3_TILES(X)                                          \
  X(256, 128) X(256, 64) X(128, 256) X(128, 208) X(128, 144) X(128, 128)   \
  X(128, 64) X(64, 256) X(64, 208) X(64, 144) X(64, 128) X(64, 64)

cudaError_t launch_tile(int tm, int tn, const ConvArgs& a, int sms,
                        cudaStream_t s) {
#define COCOSNET_LAUNCH(M, N) \
  if (tm == M && tn == N) return launch_bf16<M, N>(a, sms, s);
  COCOSNET_CONV3X3_TILES(COCOSNET_LAUNCH)
#undef COCOSNET_LAUNCH
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------- f32 path

constexpr int FBN = 64;
constexpr int FBK = 32;
constexpr int LDA_F = BM + 4;   // A tile, k-major [FBK][LDA_F]
constexpr int LDB_F = FBN + 4;  // B tile [FBK][LDB_F]
constexpr int LDC = FBN + 4;    // accumulator tile [BM][LDC]
constexpr int F_SMEM = BM * LDC * 4;
static_assert(FBK * LDA_F * 4 + FBK * LDB_F * 4 <= F_SMEM, "f32 tiles");

__global__ void __launch_bounds__(NT)
    conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ out,
                       float* __restrict__ stats, int H, int W, int Cin,
                       int Cout, int reflect, int has_leaky, float slope) {
  __shared__ __align__(128) unsigned char smem[F_SMEM];
  __shared__ int s_row[3][BM];
  __shared__ int s_col[3][BM];
  __shared__ float s_red[2][NT / FBN][FBN];

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * FBN;
  const int HW = H * W;
  const int tid = threadIdx.x;
  x += (size_t)b * HW * Cin;
  out += (size_t)b * HW * Cout;

  if (tid < BM) {
    const int p = m0 + tid;
    const int oh = p / W, ow = p % W;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      s_row[d][tid] = p < HW ? ring(oh + d - 1, H, reflect) : -1;
      s_col[d][tid] = p < HW ? ring(ow + d - 1, W, reflect) : -1;
    }
  }
  __syncthreads();

  float* Cs = reinterpret_cast<float*>(smem);
  const int kchunks = (Cin + FBK - 1) / FBK;
  float* As = reinterpret_cast<float*>(smem);  // [FBK][LDA_F]
  float* Bs = As + FBK * LDA_F;                // [FBK][LDB_F]
  const int tx = tid % 16, ty = tid / 16;      // cols tx+16j, rows ty+16i
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    for (int kc = 0; kc < kchunks; ++kc) {
      const int c0 = kc * FBK;
#pragma unroll 4
      for (int i = 0; i < BM * FBK / NT; ++i) {
        const int idx = tid + i * NT;
        const int m = idx / FBK, k = idx % FBK, c = c0 + k;
        const int r = s_row[dy][m], cc = s_col[dx][m];
        float v = 0.f;
        if (r >= 0 && cc >= 0 && c < Cin) v = x[((size_t)r * W + cc) * Cin + c];
        As[k * LDA_F + m] = v;
      }
#pragma unroll 4
      for (int i = 0; i < FBK * FBN / NT; ++i) {
        const int idx = tid + i * NT;
        const int k = idx / FBN, n = idx % FBN, c = c0 + k, co = n0 + n;
        float v = 0.f;
        if (c < Cin && co < Cout) v = w[((size_t)tap * Cin + c) * Cout + co];
        Bs[k * LDB_F + n] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < FBK; ++k) {
        float a[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = As[k * LDA_F + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[k * LDB_F + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Cs[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
  __syncthreads();

  // epilogue: bias + LeakyReLU
#pragma unroll 4
  for (int i = 0; i < BM * FBN / NT; ++i) {
    const int idx = tid + i * NT;
    const int m = idx / FBN, n = idx % FBN;
    const int p = m0 + m, co = n0 + n;
    float v = Cs[m * LDC + n] + (co < Cout ? bias[co] : 0.f);
    if (has_leaky) v = v >= 0.f ? v : slope * v;
    Cs[m * LDC + n] = v;
    if (p < HW && co < Cout) out[(size_t)p * Cout + co] = v;
  }
  if (stats == nullptr) return;
  __syncthreads();
  {
    const int n = tid % FBN, g = tid / FBN;  // NT / FBN row groups
    constexpr int ROWS = BM / (NT / FBN);
    float s = 0.f, ss = 0.f;
    for (int r = 0; r < ROWS; ++r) {
      const int m = g * ROWS + r;
      if (m0 + m < HW) {
        const float v = Cs[m * LDC + n];
        s += v;
        ss += v * v;
      }
    }
    s_red[0][g][n] = s;
    s_red[1][g][n] = ss;
  }
  __syncthreads();
  if (tid < FBN && n0 + tid < Cout) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int g = 0; g < NT / FBN; ++g) {
      s += s_red[0][g][tid];
      ss += s_red[1][g][tid];
    }
    float* st = stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * Cout;
    st[n0 + tid] = s;
    st[Cout + n0 + tid] = ss;
  }
}

}  // namespace

extern "C" int cocosnet_conv3x3_tile_pixels() { return BM; }

// x: (B, H, W, Cin), w: (3, 3, Cin, Cout), bias: (Cout,) f32, out: (B, H, W,
// Cout) in x's type, stats: null or (B, ceil(H*W/pixel tile), 2, Cout) f32,
// the pixel tile tm for bf16 and cocosnet_conv3x3_tile_pixels() for f32. All
// contiguous. bf16: the tile (tm, tn), one of COCOSNET_CONV3X3_TILES; w_t is
// scratch of ceil(Cout/tn) x (9 x ceil(Cin8/64) x 64 + 2) x tn bf16 for the
// tiled weights and the bias the kernel reads (Cin8 = Cin rounded up to 8),
// and, with Cin not
// a multiple of 8, x_pad scratch of (B, H, W, Cin8) bf16 for the
// channel-padded copy of x (null otherwise); sms: the card's SMs, the most
// blocks of the persistent grid. Returns the first cudaError_t that is not
// success.
extern "C" int cocosnet_conv3x3(const void* x, const void* w, const void* bias,
                                void* out, void* stats, void* x_pad,
                                void* w_t, int B, int H, int W, int Cin,
                                int Cout, int reflect, int has_leaky,
                                float slope, int is_bf16, int tm, int tn,
                                int box, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const auto* xb = static_cast<const bf16*>(x);
    auto* wtb = static_cast<bf16*>(w_t);
    const int ldx = (Cin + 7) / 8 * 8;
    const int kc = (ldx + BK - 1) / BK;
    const int n_tiles = (Cout + tn - 1) / tn;
    cudaError_t e = cudaSuccess;
    if (ldx != Cin) {
      e = conv3x3::pad_channels(xb, static_cast<bf16*>(x_pad),
                                (long long)B * H * W, Cin, ldx, s);
      xb = static_cast<const bf16*>(x_pad);
    }
    // the bias as n_tiles x tn f32 after the weight tiles
    auto* bt = reinterpret_cast<float*>(wtb + (size_t)n_tiles * 9 * kc * tn *
                                                  BK);
    if (e == cudaSuccess) {
      const long long n = 9LL * (kc * BK / 8) * n_tiles * tn;
      const long long want = (n + 255) / 256;
      k_major_weights_kernel<<<(int)(want < 132 * 16 ? want : 132 * 16), 256,
                               0, s>>>(static_cast<const bf16*>(w),
                                       static_cast<const float*>(bias), wtb,
                                       bt, Cin, Cout, tn, n_tiles, kc);
      e = cudaGetLastError();
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    ConvArgs a;
    a.x = xb;
    a.wt = wtb;
    a.bt = bt;
    a.out = static_cast<bf16*>(out);
    a.stats = static_cast<float*>(stats);
    a.H = H;
    a.W = W;
    a.Cin = Cin;
    a.Cout = Cout;
    a.ldx = ldx;
    a.reflect = reflect;
    a.has_leaky = has_leaky;
    a.slope = slope;
    a.kc = kc;
    a.last_k16 = (ldx - (kc - 1) * BK + 15) / 16;
    a.m_tiles = (H * W + tm - 1) / tm;
    a.n_tiles = n_tiles;
    a.tiles = B * a.m_tiles * n_tiles;
    box_path(a, B, tm, box);
    return static_cast<int>(launch_tile(tm, tn, a, sms, s));
  }
  dim3 grid((H * W + BM - 1) / BM, (Cout + FBN - 1) / FBN, B);
  conv3x3_f32_kernel<<<grid, NT, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out),
      static_cast<float*>(stats), H, W, Cin, Cout, reflect, has_leaky, slope);
  return static_cast<int>(cudaGetLastError());
}
