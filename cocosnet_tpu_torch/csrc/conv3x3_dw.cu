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
// block owns one tap, 64 input channels and 64 output channels, and one
// split of the batch's rows; it walks its split in chunks of 32 pixels,
// gathering the tap-shifted input pixels straight from the NHWC tensor into
// shared memory with the zero or reflect ring in the index math (as
// conv3x3.cu does; ReflectionPad2d(1): -1 -> 1, n -> n-2), and the matching
// g pixels. bf16 operands run on the tensor cores through WMMA 16x16x16
// fragments with f32 accumulation; f32 operands on f32 FMA (never TF32).
// The blocks of tap 0 and the first channel tile also sum the g tile's
// columns for db. K = 32768 at the flagship needs more blocks than the
// 9 * Cin/64 * Cout/64 tiles give, so the rows are split (about four waves
// of blocks on 132 SMs); each split writes its own partial dW and db, and a
// second kernel sums the partials in split order. No atomics: two runs give
// the same bits. A first, simple kernel: scalar gathers, single-buffered
// shared memory, no TMA, no wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;   // input channels per block: rows of the dW tile
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // pixels per chunk of the contraction
constexpr int NT = 256;
constexpr int LDA_H = BM + 8;  // bf16 x tile [BK][LDA_H], channels contiguous
constexpr int LDB_H = BN + 8;  // bf16 g tile [BK][LDB_H]
constexpr int LDA_F = BM + 4;  // f32 x tile [BK][LDA_F]
constexpr int LDB_F = BN + 4;  // f32 g tile [BK][LDB_F]
constexpr int LDC = BN + 4;    // f32 result tile [BM][LDC]
constexpr int SMEM_BYTES = BM * LDC * 4;
constexpr int TARGET_BLOCKS = 4 * 132;
constexpr int MIN_SPLIT_PIXELS = 512;

static_assert(BK * LDA_H * 2 + BK * LDB_H * 2 <= SMEM_BYTES, "bf16 tiles");
static_assert(BK * LDA_F * 4 + BK * LDB_F * 4 <= SMEM_BYTES, "f32 tiles");

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Source index along an axis of length n for padded position i, or -1 for a
// zero-ring position.
__device__ __forceinline__ int ring(int i, int n, bool reflect) {
  if (i >= 0 && i < n) return i;
  if (!reflect) return -1;
  return i < 0 ? -i : 2 * n - 2 - i;
}

// Pixel range [p0, p1) of split s: whole rows of the (B * H)-row image
// stack, rows_per_split of them.
__host__ __device__ __forceinline__ int rows_per_split(int rows, int splits) {
  return (rows + splits - 1) / splits;
}

template <typename T>
__global__ void __launch_bounds__(NT)
    conv3x3_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      float* __restrict__ dw, float* __restrict__ db, int B,
                      int H, int W, int Cin, int Cout, int reflect,
                      int splits) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ int s_src[BK];  // x pixel of each chunk position, or -1
  __shared__ int s_dst[BK];  // g pixel, or -1 past the split

  const int nci = (Cin + BM - 1) / BM, nco = (Cout + BN - 1) / BN;
  const int co_t = blockIdx.x % nco;
  const int ci_t = (blockIdx.x / nco) % nci;
  const int tap = blockIdx.x / (nco * nci);
  const int dy = tap / 3, dx = tap % 3;
  const int ci0 = ci_t * BM, n0 = co_t * BN;
  const int split = blockIdx.y;
  const int rps = rows_per_split(B * H, splits);
  const int p0 = split * rps * W;
  const int p1 = min(B * H, (split + 1) * rps) * W;
  const bool do_db = tap == 0 && ci_t == 0;
  const int tid = threadIdx.x;
  const int HW = H * W;
  float db_acc = 0.f;

  // the chunk's pixel table: threads 0..BK-1 fill it for chunk base p
  auto index_chunk = [&](int p) {
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
  };

  float* Cs = reinterpret_cast<float*>(smem);

  if constexpr (sizeof(T) == 2) {
    T* As = reinterpret_cast<T*>(smem);  // [BK][LDA_H]: (ci, pixel) col-major
    T* Bs = As + BK * LDA_H;             // [BK][LDB_H]: (pixel, co) row-major
    const int warp = tid / 32;
    const int wm = warp % 4, wn = warp / 4;  // 4 x 2 warps of 16 x 32
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int p = p0; p < p1; p += BK) {
      index_chunk(p);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < BM * BK / NT; ++i) {
        const int idx = tid + i * NT;
        const int k = idx / BM, m = idx % BM, ci = ci0 + m;
        const int src = s_src[k];
        As[k * LDA_H + m] = (src >= 0 && ci < Cin)
                                ? x[(size_t)src * Cin + ci] : zero<T>();
      }
#pragma unroll
      for (int i = 0; i < BK * BN / NT; ++i) {
        const int idx = tid + i * NT;
        const int k = idx / BN, n = idx % BN, co = n0 + n;
        const int dst = s_dst[k];
        Bs[k * LDB_H + n] = (dst >= 0 && co < Cout)
                                ? g[(size_t)dst * Cout + co] : zero<T>();
      }
      __syncthreads();
      if (do_db && tid < BN) {
#pragma unroll 8
        for (int k = 0; k < BK; ++k) db_acc += to_f(Bs[k * LDB_H + tid]);
      }
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            fa;
        wmma::load_matrix_sync(
            fa, reinterpret_cast<const __nv_bfloat16*>(As) + kk * LDA_H +
                    wm * 16,
            LDA_H);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              fb;
          wmma::load_matrix_sync(
              fb, reinterpret_cast<const __nv_bfloat16*>(Bs) + kk * LDB_H +
                      wn * 32 + j * 16,
              LDB_H);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 16) * LDC + wn * 32 + j * 16, acc[j],
                              LDC, wmma::mem_row_major);
  } else {
    float* As = reinterpret_cast<float*>(smem);  // [BK][LDA_F]
    float* Bs = As + BK * LDA_F;                 // [BK][LDB_F]
    const int tx = tid % 16, ty = tid / 16;      // cols tx+16j, rows ty+16i
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int p = p0; p < p1; p += BK) {
      index_chunk(p);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < BM * BK / NT; ++i) {
        const int idx = tid + i * NT;
        const int k = idx / BM, m = idx % BM, ci = ci0 + m;
        const int src = s_src[k];
        As[k * LDA_F + m] =
            (src >= 0 && ci < Cin) ? to_f(x[(size_t)src * Cin + ci]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < BK * BN / NT; ++i) {
        const int idx = tid + i * NT;
        const int k = idx / BN, n = idx % BN, co = n0 + n;
        const int dst = s_dst[k];
        Bs[k * LDB_F + n] =
            (dst >= 0 && co < Cout) ? to_f(g[(size_t)dst * Cout + co]) : 0.f;
      }
      __syncthreads();
      if (do_db && tid < BN) {
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
      for (int j = 0; j < 4; ++j)
        Cs[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();

  // this split's partial: dW (9, Cin, Cout) then db (Cout), or the results
  // themselves when there is one split
  const size_t nw = (size_t)9 * Cin * Cout;
  float* out_w = splits > 1 ? dw + (size_t)split * (nw + Cout) : dw;
  float* out_b = splits > 1 ? out_w + nw : db;
#pragma unroll 4
  for (int i = 0; i < BM * BN / NT; ++i) {
    const int idx = tid + i * NT;
    const int m = idx / BN, n = idx % BN, ci = ci0 + m, co = n0 + n;
    if (ci < Cin && co < Cout)
      out_w[((size_t)tap * Cin + ci) * Cout + co] = Cs[m * LDC + n];
  }
  if (do_db && tid < BN && n0 + tid < Cout) out_b[n0 + tid] = db_acc;
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

// Splits of the B*H rows the launch uses for this shape: enough blocks for
// about four waves on 132 SMs, each split at least MIN_SPLIT_PIXELS pixels.
// The wrapper allocates (splits, 9*Cin*Cout + Cout) f32 of partials when
// this is more than 1.
extern "C" int cocosnet_conv3x3_dw_splits(int B, int H, int W, int Cin,
                                          int Cout) {
  const int tiles = 9 * ((Cin + BM - 1) / BM) * ((Cout + BN - 1) / BN);
  int s = (TARGET_BLOCKS + tiles - 1) / tiles;
  const long long pixels = (long long)B * H * W;
  const long long by_pixels = pixels / MIN_SPLIT_PIXELS;
  if (s > by_pixels) s = (int)by_pixels;
  if (s > B * H) s = B * H;
  if (s < 1) s = 1;
  // every split must own at least one row
  while (s > 1 && rows_per_split(B * H, s) * (s - 1) >= B * H) --s;
  return s;
}

// x: (B, H, W, Cin), g: (B, H, W, Cout), both f32 or both bf16; dw: (3, 3,
// Cin, Cout) f32, db: (Cout,) f32; part: null when splits == 1, else
// (splits, 9*Cin*Cout + Cout) f32 scratch. All contiguous. Launches on
// `stream`; returns the first cudaError_t that is not success.
extern "C" int cocosnet_conv3x3_dw(const void* x, const void* g, void* dw,
                                   void* db, void* part, int B, int H, int W,
                                   int Cin, int Cout, int reflect, int is_bf16,
                                   int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = 9 * ((Cin + BM - 1) / BM) * ((Cout + BN - 1) / BN);
  dim3 grid(tiles, splits);
  float* out_w = splits > 1 ? static_cast<float*>(part)
                            : static_cast<float*>(dw);
  float* out_b = static_cast<float*>(db);
  if (is_bf16) {
    conv3x3_dw_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), out_w, out_b, B, H, W, Cin, Cout,
        reflect, splits);
  } else {
    conv3x3_dw_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), out_w,
        out_b, B, H, W, Cin, Cout, reflect, splits);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t nw = (size_t)9 * Cin * Cout;
  const int blocks = (int)((nw + Cout + NT - 1) / NT < 4096
                               ? (nw + Cout + NT - 1) / NT : 4096);
  reduce_splits<<<blocks, NT, 0, s>>>(static_cast<const float*>(part),
                                      static_cast<float*>(dw), out_b, splits,
                                      nw, Cout);
  return static_cast<int>(cudaGetLastError());
}
