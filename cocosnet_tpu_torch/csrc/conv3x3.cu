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
// taps x Cin. A block owns BM = 128 output pixels of one sample (so its
// statistics are that sample's) x BN output channels (128, or 64 where Cout
// <= 64). The K loop walks the 9 taps x Cin in stages; the A tile of a stage
// is the tap-shifted input pixels, gathered straight from the NHWC tensor
// with the zero or reflect ring in the per-row source index (computed once
// per tap for the rows a thread loads), so no copy of the input with its
// ring and no im2col exist.
//
// bf16 (the flagship's type): two warpgroups each run wgmma m64nBNk16 on 64
// of the pixel rows, both operands K-major in shared memory with the
// 128-byte swizzle, accumulators in registers. A stage is BK = 64 channels
// of one tap: A (128 pixels x 64) and B (BN output channels x 64, from a
// K-major copy of the weights that a small kernel writes first). Every
// thread loads 16-byte chunks by cp.async into a ring of 3 stages (zero fill
// for ring cells, ragged pixel and channel edges), so the loads of stage
// k+2 overlap the wgmma of stage k; two blocks fit on an SM. An input whose
// channel count is not a multiple of 8 (151, 407 at the flagship; the dx
// launch swaps the counts) is first copied with its rows padded to a
// multiple of 8 channels (conv3x3_common.cuh `pad_channels`). The epilogue
// works from the accumulators: f32 bias, LeakyReLU, one rounding on the
// store; the statistics variant reduces each column's sum and sum of
// squares over the tile's valid rows (shuffles, then the warps in a fixed
// order) and writes per-(sample, pixel tile, channel) partials, reduced
// outside in a fixed order (deterministic, no atomics).
//
// f32 (the parity path): exact f32 FMA from single-buffered shared memory,
// never TF32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_common.cuh"

namespace {

using conv3x3::ring;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;  // output pixels per block, both paths
constexpr int NT = 256;

// ------------------------------------------------------------ bf16 path

constexpr int BK = 64;  // channels per stage: one 128-byte swizzle row
constexpr int STAGES = 3;
constexpr int A_BYTES = BM * BK * 2;

// The shared memory of one block: STAGES x (A tile, B tile), each a
// K-major tile of 128-byte rows (BK bf16), 16-byte chunk c of row r at
// r * 128 + (c ^ (r % 8)) * 16: the 128-byte swizzle of the wgmma
// descriptors, so that neither the cp.async stores nor the wgmma reads
// conflict on banks. The base is rounded up to 1024 bytes (the swizzle's
// period).
template <int BN>
struct Tiles {
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;
  static constexpr int NACC = BN / 2;  // f32 accumulators a thread
  static_assert(2 * 8 * BN * 4 <= STAGES * STAGE_BYTES, "statistics");
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

// d (64 x BN per warpgroup, f32) += A (64 x 16) B (16 x BN), bf16, both
// operands K-major in shared memory
template <int BN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db);

#define COCOSNET_WGMMA_REGS8(i)                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : COCOSNET_WGMMA_REGS8(0), COCOSNET_WGMMA_REGS8(8),
        COCOSNET_WGMMA_REGS8(16), COCOSNET_WGMMA_REGS8(24),
        COCOSNET_WGMMA_REGS8(32), COCOSNET_WGMMA_REGS8(40),
        COCOSNET_WGMMA_REGS8(48), COCOSNET_WGMMA_REGS8(56)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : COCOSNET_WGMMA_REGS8(0), COCOSNET_WGMMA_REGS8(8),
        COCOSNET_WGMMA_REGS8(16), COCOSNET_WGMMA_REGS8(24)
      : "l"(da), "l"(db), "r"(1));
}

#undef COCOSNET_WGMMA_REGS8

// x rows (pixels) ldx elements apart (Cin, or its padded copy's multiple of
// 8); wt: the K-major weights (Cout, 9, ldx)
template <int BN>
__global__ void __launch_bounds__(NT, 2)
    conv3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                        const float* __restrict__ bias, bf16* __restrict__ out,
                        float* __restrict__ stats, int H, int W, int Cin,
                        int Cout, int ldx, int reflect, int has_leaky,
                        float slope) {
  using T = Tiles<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = conv3x3::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;  // warpgroup: pixel rows 64 wg .. 64 wg + 63
  const int b = blockIdx.z, m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int HW = H * W;
  x += (size_t)b * HW * ldx;
  out += (size_t)b * HW * Cout;

  // loads: chunk lc = tid % 8 of A rows lr + 32 i and of B rows lr + 32 i
  const int lc = tid & 7, lr = tid >> 3;
  int a_pix[BM / 32];  // source pixel of each A row, or -1
  auto set_tap = [&](int tap) {
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll
    for (int i = 0; i < BM / 32; ++i) {
      const int p = m0 + lr + 32 * i;
      int pix = -1;
      if (p < HW) {
        const int oh = p / W;
        const int r = ring(oh + dy - 1, H, reflect);
        const int c = ring(p - oh * W + dx - 1, W, reflect);
        if (r >= 0 && c >= 0) pix = r * W + c;
      }
      a_pix[i] = pix;
    }
  };
  int ld_tap = 0, ld_c0 = 0;  // the next stage to load
  set_tap(0);
  const int kchunks = (Cin + BK - 1) / BK;
  const int nstages = 9 * kchunks;

  auto fetch = [&](int stage) {
    unsigned char* sa = smem + (stage % STAGES) * T::STAGE_BYTES;
    unsigned char* sb = sa + A_BYTES;
    const int c = ld_c0 + 8 * lc;
#pragma unroll
    for (int i = 0; i < BM / 32; ++i) {
      const int r = lr + 32 * i;
      const bool ok = a_pix[i] >= 0 && c < Cin;
      conv3x3::cp_async16(sa + swizzle128(r, lc),
                          ok ? x + (size_t)a_pix[i] * ldx + c : x, ok);
    }
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) {
      const int r = lr + 32 * i, co = n0 + r;
      const bool ok = co < Cout && c < Cin;
      conv3x3::cp_async16(
          sb + swizzle128(r, lc),
          ok ? wt + ((size_t)co * 9 + ld_tap) * ldx + c : wt, ok);
    }
    ld_c0 += BK;
    if (ld_c0 >= Cin) {
      ld_c0 = 0;
      if (++ld_tap < 9) set_tap(ld_tap);
    }
  };

  float d[T::NACC];
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) d[i] = 0.f;

  // stage s: fetched (cp.async) at iteration s - STAGES + 1; at s, made
  // visible to the async proxy, then read by the warpgroups' wgmma
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nstages) fetch(s);
    conv3x3::cp_async_commit();
  }
  for (int s = 0; s < nstages; ++s) {
    conv3x3::cp_async_wait<STAGES - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (s + STAGES - 1 < nstages) fetch(s + STAGES - 1);
    conv3x3::cp_async_commit();
    const uint32_t sa = base + (s % STAGES) * T::STAGE_BYTES;
    const uint32_t sb = sa + A_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)
      wgmma_bf16<BN>(d, desc_sw128(sa + wg * 64 * 128 + k * 32),
                     desc_sw128(sb + k * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  conv3x3::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the tiles

  // epilogue: bias + LeakyReLU in f32, one rounding on the store. d[4 j +
  // 2 h + e] holds row (warp % 4) * 16 + lane / 4 + 8 h of the warpgroup's
  // 64 and column 8 j + 2 (lane % 4) + e. The statistics: each column's sum
  // and sum of squares over the warp's valid rows by shuffles, then the 8
  // warps in order through shared memory.
  float* red = reinterpret_cast<float*>(smem);  // [2][8 warps][BN]
  const bool pair_store = (Cout & 1) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3), co = n0 + col;
    const float b0 = co < Cout ? bias[co] : 0.f;
    const float b1 = co + 1 < Cout ? bias[co + 1] : 0.f;
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * h;
      float v0 = d[4 * j + 2 * h] + b0, v1 = d[4 * j + 2 * h + 1] + b1;
      if (has_leaky) {
        v0 = v0 >= 0.f ? v0 : slope * v0;
        v1 = v1 >= 0.f ? v1 : slope * v1;
      }
      if (p >= HW) continue;
      s1[0] += v0;
      s1[1] += v1;
      s2[0] += v0 * v0;
      s2[1] += v1 * v1;
      bf16* o = out + (size_t)p * Cout + co;
      if (pair_store && co + 1 < Cout) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (co < Cout) o[0] = __float2bfloat16(v0);
        if (co + 1 < Cout) o[1] = __float2bfloat16(v1);
      }
    }
    if (stats == nullptr) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], off);
        s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], off);
      }
    if (lane < 4) {
      red[warp * BN + col] = s1[0];
      red[warp * BN + col + 1] = s1[1];
      red[(8 + warp) * BN + col] = s2[0];
      red[(8 + warp) * BN + col + 1] = s2[1];
    }
  }
  if (stats == nullptr) return;
  __syncthreads();
  if (tid < BN && n0 + tid < Cout) {
    float a = 0.f, q = 0.f;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      a += red[g * BN + tid];
      q += red[(8 + g) * BN + tid];
    }
    // stats: (B, pixel tiles, 2, Cout)
    float* st = stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * Cout;
    st[n0 + tid] = a;
    st[Cout + n0 + tid] = q;
  }
}

// wt (Cout, 9, ldk) = the (9, Cin, Cout) weights w with K = (tap, channel)
// contiguous, zeros in channels Cin .. ldk-1: the K-major B operand. Each
// thread writes 16 bytes; neighbouring threads read neighbouring Cout.
__global__ void k_major_weights_kernel(const bf16* __restrict__ w,
                                       bf16* __restrict__ wt, int Cin,
                                       int Cout, int ldk) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(w);
  const int cpr = ldk / 8;
  const long long n = 9LL * cpr * Cout;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < n;
       q += (long long)gridDim.x * blockDim.x) {
    const int co = (int)(q % Cout);
    const long long tj = q / Cout;
    const int j = (int)(tj % cpr), tap = (int)(tj / cpr);
    uint32_t e[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = 8 * j + k;
      e[k] = c < Cin ? __ldg(s + ((size_t)tap * Cin + c) * Cout + co) : 0u;
    }
    *reinterpret_cast<uint4*>(wt + ((size_t)co * 9 + tap) * ldk + 8 * j) =
        make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                   e[4] | (e[5] << 16), e[6] | (e[7] << 16));
  }
}

template <int BN>
cudaError_t launch_bf16(const bf16* x, const bf16* wt, const float* bias,
                        bf16* out, float* stats, int B, int H, int W, int Cin,
                        int Cout, int ldx, int reflect, int has_leaky,
                        float slope, cudaStream_t s) {
  auto kern = conv3x3_bf16_kernel<BN>;
  constexpr int smem = Tiles<BN>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((H * W + BM - 1) / BM, (Cout + BN - 1) / BN, B);
  kern<<<grid, NT, smem, s>>>(x, wt, bias, out, stats, H, W, Cin, Cout, ldx,
                              reflect, has_leaky, slope);
  return cudaGetLastError();
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
// Cout) in x's type, stats: null or (B, ceil(H*W/BM), 2, Cout) f32. All
// contiguous. bf16: w_t is scratch of (Cout, 3, 3, Cin rounded up to 8) bf16
// for the K-major weights the kernel reads, and, with Cin not a multiple of
// 8, x_pad scratch of (B, H, W, Cin rounded up to 8) bf16 for the
// channel-padded copy of x (null otherwise). Returns the first cudaError_t
// that is not success.
extern "C" int cocosnet_conv3x3(const void* x, const void* w, const void* bias,
                                void* out, void* stats, void* x_pad,
                                void* w_t, int B, int H, int W, int Cin,
                                int Cout, int reflect, int has_leaky,
                                float slope, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const auto* xb = static_cast<const bf16*>(x);
    auto* wtb = static_cast<bf16*>(w_t);
    const int ldx = (Cin + 7) / 8 * 8;
    cudaError_t e = cudaSuccess;
    if (ldx != Cin) {
      e = conv3x3::pad_channels(xb, static_cast<bf16*>(x_pad),
                                (long long)B * H * W, Cin, ldx, s);
      xb = static_cast<const bf16*>(x_pad);
    }
    if (e == cudaSuccess) {
      const long long n = 9LL * (ldx / 8) * Cout;
      const long long want = (n + 255) / 256;
      k_major_weights_kernel<<<(int)(want < 132 * 16 ? want : 132 * 16), 256,
                               0, s>>>(static_cast<const bf16*>(w), wtb, Cin,
                                       Cout, ldx);
      e = cudaGetLastError();
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    const auto* bb = static_cast<const float*>(bias);
    auto* ob = static_cast<bf16*>(out);
    auto* sb = static_cast<float*>(stats);
    e = Cout <= 64 ? launch_bf16<64>(xb, wtb, bb, ob, sb, B, H, W, Cin, Cout,
                                     ldx, reflect, has_leaky, slope, s)
                   : launch_bf16<128>(xb, wtb, bb, ob, sb, B, H, W, Cin, Cout,
                                      ldx, reflect, has_leaky, slope, s);
    return static_cast<int>(e);
  }
  dim3 grid((H * W + BM - 1) / BM, (Cout + FBN - 1) / FBN, B);
  conv3x3_f32_kernel<<<grid, NT, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out),
      static_cast<float*>(stats), H, W, Cin, Cout, reflect, has_leaky, slope);
  return static_cast<int>(cudaGetLastError());
}
