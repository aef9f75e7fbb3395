// Weight and bias gradient of a 3x3 stride-1 convolution with a zero or
// reflect ring, NHWC activations, HWIO gradient.
//
// Replaces: cocosnet_tpu/ops/pallas_conv.py `conv3x3_dw` (`_dw_kernel`), the
// dW/db half of the training route `conv3x3_xla_pdw`.
//
// Computes dW[dy][dx][ci][co] = sum_{b,h,w} xpad[b][h+dy][w+dx][ci] *
// g[b][h][w][co] and db[co] = sum_{b,h,w} g[b][h][w][co], f32 results, for x
// (B, H, W, Cin) and g (B, H, W, Cout) in one type (f32 or bf16).
//
// Bound on the H100: operations. 2*B*H*W*9*Cin*Cout flops (38.65 GFLOP at
// 128->512, 64x64, batch 8) against (B*H*W*(Cin + Cout) + 9*Cin*Cout) operand
// bytes, far above the card's balance point for bf16: the tensor cores are
// the limit.
//
// Design: a GEMM of (9 Cin) x Cout over the contraction K = B*H*W, the
// batch and the space folded together as the Pallas kernel folds them. A
// block owns one tap, a tile of input channels x a tile of output channels,
// and one split of the pixels; it walks its split in chunks of 32 pixels,
// gathering the tap-shifted input pixels straight from the NHWC tensor with
// the zero or reflect ring in the index math (as conv3x3.cu does), and the
// matching g pixels. The (sample, row, column) of a chunk's first pixel is
// stepped by 32 each chunk and a row's pixel found from it, so no division
// runs in the loop. The blocks of tap 0 and the first input-channel tile
// also sum the g tile's columns from shared memory for db. K = 32768 at the
// flagship needs more blocks than the tiles give, so the pixels are split
// into ranges of whole chunks, enough for two waves of two blocks per SM on
// 132 SMs; each split writes its own partial dW and db, and a second kernel
// sums the partials in split order. No atomics: two runs give the same bits.
//
// bf16: 128 x 128 tiles; a ring of STAGES = 4 chunks in dynamic shared
// memory filled by 16-byte cp.async (zero fill for ring cells and the ends of
// the split), so the loads of chunk k+3 overlap the MMAs of chunk k. Both
// operands are channel-contiguous, so x^T (the A operand, input channels x
// pixels) and g (pixels x output channels) come out of shared memory through
// ldmatrix.trans into mma.sync m16n8k16 (f32 accumulators in registers, 8
// warps of 64 x 32). An operand whose channel count is not a multiple of 8
// is first copied with its rows padded to a multiple of 8 channels
// (conv3x3_common.cuh `pad_channels`), and the kernel reads the copy. f32
// (the parity path): 64 x 64 tiles, exact f32 FMA from single-buffered
// shared memory, never TF32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_common.cuh"

namespace {

using conv3x3::ring;
using bf16 = __nv_bfloat16;

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(conv3x3::smem_u32(p)));
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(conv3x3::smem_u32(p)));
}

// d += a (16x16, row major) * b (16x8, column major), bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stages spans of ROWS rows x COLS channels of a channel-contiguous tensor
// into a ring of STAGES tiles in shared memory (row stride LD elements), run
// by NT threads, each moving the same 8-channel chunk of ITERS rows with one
// 16-byte cp.async a chunk. The caller gives, per row of the thread, a
// pointer to the first channel of the stage's span in that row (16-byte
// aligned; null: a row of zeros) and how many channels of the span exist:
// chunks wholly past them are zeros, a chunk across the end is read whole
// (the row's padding, see pad_channels).
template <int ROWS, int COLS, int LD, int NT, int STAGES>
struct RowTile {
  static constexpr int CPR = COLS / 8;        // chunks per tile row
  static constexpr int RSTEP = NT / CPR;      // rows between a thread's rows
  static constexpr int ITERS = ROWS / RSTEP;  // rows a thread moves
  static constexpr int TILE_ELEMS = ROWS * LD;
  static constexpr int BYTES = STAGES * TILE_ELEMS * 2;
  static_assert(COLS % 8 == 0 && NT % CPR == 0 && ROWS % RSTEP == 0 &&
                    LD % 8 == 0,
                "tile geometry");

  __nv_bfloat16* tiles;
  int r0, j0;  // the thread's first row and its chunk

  __device__ __forceinline__ RowTile(unsigned char* smem, int tid)
      : tiles(reinterpret_cast<__nv_bfloat16*>(smem)),
        r0(tid / CPR),
        j0(tid % CPR) {}

  __device__ __forceinline__ int row(int i) const { return r0 + i * RSTEP; }

  __device__ __forceinline__ const __nv_bfloat16* tile(int stage) const {
    return tiles + (stage % STAGES) * TILE_ELEMS;
  }

  // base: any address of the tensor, given to the copies that read nothing
  __device__ __forceinline__ void fetch(int stage, int i,
                                        const __nv_bfloat16* span, int n,
                                        const __nv_bfloat16* base) {
    const bool ok = span != nullptr && 8 * j0 < n;
    conv3x3::cp_async16(
        tiles + (stage % STAGES) * TILE_ELEMS + row(i) * LD + 8 * j0,
        ok ? span + 8 * j0 : base, ok);
  }
};

constexpr int BK = 32;  // pixels per chunk of the contraction, both paths
constexpr int NT = 256;
constexpr int TARGET_BLOCKS = 4 * 132;

// Pixel range [p0, p1) of split s: whole chunks, ceil(chunks / splits) of
// them (a split past the end is empty and writes zeros).
__device__ __forceinline__ void split_range(int P, int splits, int s, int& p0,
                                            int& p1) {
  const int chunks = (P + BK - 1) / BK;
  const int cps = (chunks + splits - 1) / splits;
  p0 = min(P, s * cps * BK);
  p1 = min(P, p0 + cps * BK);
}

// ------------------------------------------------------------ bf16 path

constexpr int BM = 128;  // input channels per block: rows of the dW tile
constexpr int BN = 128;  // output channels per block
constexpr int STAGES = 4;
constexpr int LDX = BM + 8;  // x tile [BK][LDX], input channels contiguous
constexpr int LDG = BN + 8;  // g tile [BK][LDG], output channels contiguous
constexpr int WARPS_N = 4;
constexpr int WTM = BM / (8 / WARPS_N);  // 64 rows per warp
constexpr int MI = WTM / 16;
constexpr int NI = 4;                     // 32 columns per warp

// The shared-memory loaders: the x tile holds the tap-shifted pixels of a
// chunk x BM input channels, the g tile the chunk's pixels x BN output
// channels.
using TX = RowTile<BK, BM, LDX, NT, STAGES>;
using TG = RowTile<BK, BN, LDG, NT, STAGES>;
constexpr int SMEM = TX::BYTES + TG::BYTES;

// x rows (pixels) ldx elements apart, g rows ldg apart: Cin and Cout, or
// their channel-padded copies' multiples of 8.
__global__ void __launch_bounds__(NT, 2)
    conv3x3_dw_bf16_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ g, float* __restrict__ dw,
                           float* __restrict__ db, int B, int H, int W,
                           int Cin, int Cout, int ldx, int ldg, int reflect,
                           int splits) {
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int nci = (Cin + BM - 1) / BM, nco = (Cout + BN - 1) / BN;
  const int co_t = blockIdx.x % nco;
  const int ci_t = (blockIdx.x / nco) % nci;
  const int tap = blockIdx.x / (nco * nci);
  const int dy = tap / 3, dx = tap % 3;
  const int ci0 = ci_t * BM, n0 = co_t * BN;
  const int split = blockIdx.y;
  const int HW = H * W;
  int p0, p1;
  split_range(B * HW, splits, split, p0, p1);
  const int nst = (p1 - p0 + BK - 1) / BK;
  const bool do_db = tap == 0 && ci_t == 0;

  // (cb, ch, cw): the sample, row and column of the next chunk's first
  // pixel, the same in every thread
  TX tx(smem, tid);
  TG tg(smem + TX::BYTES, tid);
  int cp = p0, cb = p0 / HW, ch = (p0 % HW) / W, cw = p0 % W;

  auto fetch = [&](int stage) {
#pragma unroll
    for (int i = 0; i < TX::ITERS; ++i) {
      // the pixel of row r: step (cb, ch, cw) by r columns
      const int r = tx.row(i);
      int pix = -1;
      if (cp + r < p1) {
        int b = cb, h = ch, w = cw + r;
        while (w >= W) {
          w -= W;
          if (++h == H) {
            h = 0;
            ++b;
          }
        }
        const int sr = ring(h + dy - 1, H, reflect);
        const int sc = ring(w + dx - 1, W, reflect);
        if (sr >= 0 && sc >= 0) pix = (b * H + sr) * W + sc;
      }
      tx.fetch(stage, i, pix >= 0 ? x + (size_t)pix * ldx + ci0 : nullptr,
               Cin - ci0, x);
    }
#pragma unroll
    for (int i = 0; i < TG::ITERS; ++i) {
      const int q = cp + tg.row(i);
      tg.fetch(stage, i, q < p1 ? g + (size_t)q * ldg + n0 : nullptr,
               Cout - n0, g);
    }
    cp += BK;
    cw += BK;
    while (cw >= W) {
      cw -= W;
      if (++ch == H) {
        ch = 0;
        ++cb;
      }
    }
  };
  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float db_acc = 0.f;

  // chunk s: fetched (cp.async) at iteration s - STAGES + 1, read by the
  // MMAs at s
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) fetch(s);
    conv3x3::cp_async_commit();
  }

  for (int s = 0; s < nst; ++s) {
    conv3x3::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < nst) fetch(s + STAGES - 1);
    conv3x3::cp_async_commit();

    const bf16* xs = tx.tile(s);
    const bf16* gs = tg.tile(s);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MI][4], bfr[NI / 2][4];
      // x^T fragments: the stored rows are pixels (k), the columns input
      // channels (m); matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k
      // 8-15), (m 8-15, k 8-15)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldsm_x4_t(
            af[mi], xs + (kk + (lane & 7) + ((lane >> 4) << 3)) * LDX +
                        wm * WTM + mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj)
        ldsm_x4_t(bfr[nj], gs + (kk + (lane & 15)) * LDG + wn * 32 +
                                        nj * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bfr[ni / 2][(ni & 1) * 2],
                            bfr[ni / 2][(ni & 1) * 2 + 1]);
    }
    if (do_db && tid < BN) {
#pragma unroll 8
      for (int k = 0; k < BK; ++k)
        db_acc += __bfloat162float(gs[k * LDG + tid]);
    }
  }
  conv3x3::cp_async_wait<0>();

  // this split's partial: dW (9, Cin, Cout) then db (Cout), or the results
  // themselves when there is one split
  const size_t nw = (size_t)9 * Cin * Cout;
  float* out_w = splits > 1 ? dw + (size_t)split * (nw + Cout) : dw;
  float* out_b = splits > 1 ? out_w + nw : db;
  const bool pair_store = (Cout & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = ci0 + wm * WTM + mi * 16 + (lane >> 2) + h * 8;
      if (ci >= Cin) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int co = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
        float* o = out_w + ((size_t)tap * Cin + ci) * Cout + co;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (pair_store && co + 1 < Cout) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (co < Cout) o[0] = v0;
          if (co + 1 < Cout) o[1] = v1;
        }
      }
    }
  if (do_db && tid < BN && n0 + tid < Cout) out_b[n0 + tid] = db_acc;
}

cudaError_t launch_bf16(const bf16* x, const bf16* g, float* out_w,
                        float* out_b, int B, int H, int W, int Cin, int Cout,
                        int ldx, int ldg, int reflect, int splits,
                        cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      conv3x3_dw_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = 9 * ((Cin + BM - 1) / BM) * ((Cout + BN - 1) / BN);
  conv3x3_dw_bf16_kernel<<<dim3(tiles, splits), NT, SMEM, s>>>(
      x, g, out_w, out_b, B, H, W, Cin, Cout, ldx, ldg, reflect, splits);
  return cudaGetLastError();
}

// ------------------------------------------------------------- f32 path

constexpr int FBM = 64;  // input channels per block
constexpr int FBN = 64;  // output channels per block
constexpr int LDA_F = FBM + 4;  // x tile [BK][LDA_F]
constexpr int LDB_F = FBN + 4;  // g tile [BK][LDB_F]
constexpr int LDC = FBN + 4;    // result tile [FBM][LDC]
constexpr int F_SMEM = FBM * LDC * 4;
static_assert(BK * LDA_F * 4 + BK * LDB_F * 4 <= F_SMEM, "f32 tiles");

__global__ void __launch_bounds__(NT)
    conv3x3_dw_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ g, float* __restrict__ dw,
                          float* __restrict__ db, int B, int H, int W,
                          int Cin, int Cout, int reflect, int splits) {
  __shared__ __align__(128) unsigned char smem[F_SMEM];
  __shared__ int s_src[BK];  // x pixel of each chunk position, or -1
  __shared__ int s_dst[BK];  // g pixel, or -1 past the split

  const int nci = (Cin + FBM - 1) / FBM, nco = (Cout + FBN - 1) / FBN;
  const int co_t = blockIdx.x % nco;
  const int ci_t = (blockIdx.x / nco) % nci;
  const int tap = blockIdx.x / (nco * nci);
  const int dy = tap / 3, dx = tap % 3;
  const int ci0 = ci_t * FBM, n0 = co_t * FBN;
  const int split = blockIdx.y;
  const int HW = H * W;
  int p0, p1;
  split_range(B * HW, splits, split, p0, p1);
  const bool do_db = tap == 0 && ci_t == 0;
  const int tid = threadIdx.x;
  float db_acc = 0.f;

  float* Cs = reinterpret_cast<float*>(smem);
  float* As = reinterpret_cast<float*>(smem);  // [BK][LDA_F]
  float* Bs = As + BK * LDA_F;                 // [BK][LDB_F]
  const int tx = tid % 16, ty = tid / 16;      // cols tx+16j, rows ty+16i
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int p = p0; p < p1; p += BK) {
    // the chunk's pixel table
    if (tid < BK) {
      const int q = p + tid;
      int src = -1, dst = -1;
      if (q < p1) {
        const int b = q / HW, rem = q % HW;
        const int r = ring(rem / W + dy - 1, H, reflect);
        const int c = ring(rem % W + dx - 1, W, reflect);
        if (r >= 0 && c >= 0) src = (b * H + r) * W + c;
        dst = q;
      }
      s_src[tid] = src;
      s_dst[tid] = dst;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < FBM * BK / NT; ++i) {
      const int idx = tid + i * NT;
      const int k = idx / FBM, m = idx % FBM, ci = ci0 + m;
      const int src = s_src[k];
      As[k * LDA_F + m] =
          (src >= 0 && ci < Cin) ? x[(size_t)src * Cin + ci] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BK * FBN / NT; ++i) {
      const int idx = tid + i * NT;
      const int k = idx / FBN, n = idx % FBN, co = n0 + n;
      const int dst = s_dst[k];
      Bs[k * LDB_F + n] =
          (dst >= 0 && co < Cout) ? g[(size_t)dst * Cout + co] : 0.f;
    }
    __syncthreads();
    if (do_db && tid < FBN) {
#pragma unroll 8
      for (int k = 0; k < BK; ++k) db_acc += Bs[k * LDB_F + tid];
    }
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k * LDA_F + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k * LDB_F + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Cs[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
  __syncthreads();

  const size_t nw = (size_t)9 * Cin * Cout;
  float* out_w = splits > 1 ? dw + (size_t)split * (nw + Cout) : dw;
  float* out_b = splits > 1 ? out_w + nw : db;
#pragma unroll 4
  for (int i = 0; i < FBM * FBN / NT; ++i) {
    const int idx = tid + i * NT;
    const int m = idx / FBN, n = idx % FBN, ci = ci0 + m, co = n0 + n;
    if (ci < Cin && co < Cout)
      out_w[((size_t)tap * Cin + ci) * Cout + co] = Cs[m * LDC + n];
  }
  if (do_db && tid < FBN && n0 + tid < Cout) out_b[n0 + tid] = db_acc;
}

// dw[e] and db[e - nw] = sum over s, in order, of part[s][e].
__global__ void reduce_splits(const float* __restrict__ part,
                              float* __restrict__ dw, float* __restrict__ db,
                              int splits, size_t nw, int Cout) {
  const size_t stride = nw + Cout;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < stride;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * stride + e];
    if (e < nw)
      dw[e] = s;
    else
      db[e - nw] = s;
  }
}

}  // namespace

// Splits of the B*H*W pixels the launch uses for this shape: enough blocks
// (tiles x splits) for two waves of two blocks per SM on 132 SMs, and among
// the counts from there to twice that, the one whose last wave is fullest
// (the fewest on a tie); at most one split per 32-pixel chunk. The wrapper
// allocates (splits, 9*Cin*Cout + Cout) f32 of partials when this is more
// than 1.
extern "C" int cocosnet_conv3x3_dw_splits(int B, int H, int W, int Cin,
                                          int Cout, int is_bf16) {
  const int tm = is_bf16 ? BM : FBM, tn = is_bf16 ? BN : FBN;
  const long long tiles = 9LL * ((Cin + tm - 1) / tm) * ((Cout + tn - 1) / tn);
  const long long chunks = ((long long)B * H * W + BK - 1) / BK;
  const long long lo = (TARGET_BLOCKS + tiles - 1) / tiles;
  if (lo >= chunks) return static_cast<int>(chunks < 1 ? 1 : chunks);
  constexpr long long WAVE = TARGET_BLOCKS / 2;
  long long best = lo;
  double best_fill = 0.0;
  for (long long s = lo; s <= 2 * lo && s <= chunks; ++s) {
    const long long blocks = tiles * s;
    const double fill =
        (double)blocks / (double)(((blocks + WAVE - 1) / WAVE) * WAVE);
    if (fill > best_fill + 1e-9) {
      best = s;
      best_fill = fill;
    }
  }
  return static_cast<int>(best);
}

// x: (B, H, W, Cin), g: (B, H, W, Cout), both f32 or both bf16; dw: (3, 3,
// Cin, Cout) f32, db: (Cout,) f32; part: null when splits == 1, else
// (splits, 9*Cin*Cout + Cout) f32 scratch. bf16 with Cin (Cout) not a
// multiple of 8: x_pad (g_pad) is scratch of (B, H, W, Cin (Cout) rounded up
// to 8) bf16 for the channel-padded copy the kernel reads; null otherwise.
// All contiguous. Launches on `stream`; returns the first cudaError_t that
// is not success.
extern "C" int cocosnet_conv3x3_dw(const void* x, const void* g, void* dw,
                                   void* db, void* part, void* x_pad,
                                   void* g_pad, int B, int H, int W, int Cin,
                                   int Cout, int reflect, int is_bf16,
                                   int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out_w = splits > 1 ? static_cast<float*>(part)
                            : static_cast<float*>(dw);
  float* out_b = static_cast<float*>(db);
  cudaError_t e = cudaSuccess;
  if (is_bf16) {
    const auto* xb = static_cast<const bf16*>(x);
    const auto* gb = static_cast<const bf16*>(g);
    const int ldx = (Cin + 7) / 8 * 8, ldg = (Cout + 7) / 8 * 8;
    const long long rows = (long long)B * H * W;
    if (ldx != Cin) {
      e = conv3x3::pad_channels(xb, static_cast<bf16*>(x_pad), rows, Cin, ldx,
                                s);
      xb = static_cast<const bf16*>(x_pad);
    }
    if (e == cudaSuccess && ldg != Cout) {
      e = conv3x3::pad_channels(gb, static_cast<bf16*>(g_pad), rows, Cout,
                                ldg, s);
      gb = static_cast<const bf16*>(g_pad);
    }
    if (e == cudaSuccess)
      e = launch_bf16(xb, gb, out_w, out_b, B, H, W, Cin, Cout, ldx, ldg,
                      reflect, splits, s);
  } else {
    const int tiles = 9 * ((Cin + FBM - 1) / FBM) * ((Cout + FBN - 1) / FBN);
    conv3x3_dw_f32_kernel<<<dim3(tiles, splits), NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), out_w,
        out_b, B, H, W, Cin, Cout, reflect, splits);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t nw = (size_t)9 * Cin * Cout;
  const int blocks = (int)((nw + Cout + NT - 1) / NT < 4096
                               ? (nw + Cout + NT - 1) / NT : 4096);
  reduce_splits<<<blocks, NT, 0, s>>>(static_cast<const float*>(part),
                                      static_cast<float*>(dw), out_b, splits,
                                      nw, Cout);
  return static_cast<int>(cudaGetLastError());
}
