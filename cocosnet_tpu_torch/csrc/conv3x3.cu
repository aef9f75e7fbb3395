// Fused 3x3 stride-1 convolution with an optional instance-norm statistics
// epilogue, NHWC activations, HWIO weights.
//
// Replaces: cocosnet_tpu/ops/pallas_conv.py `_conv3x3_pallas` (`_conv_kernel`
// + `_mxu_tail`), reached as `conv3x3_fused` and `conv3x3_fused_stats`.
//
// Bound on the H100: operations. At the flagship shapes (64..1024 channels,
// 64x64..256x256 pixels, batch 6) a conv does 2*B*H*W*9*Cin*Cout flops on
// bf16 operands against ~2 bytes per activation element, far above the
// card's ~295 flop/byte balance point, so the tensor cores are the limit.
//
// Design: implicit GEMM. A block owns BM=128 output pixels of one sample
// (a run of whole or partial output rows) x BN=64 output channels. The K
// loop walks the 9 taps x Cin in chunks of BK=32; each chunk gathers the
// tap-shifted input pixels straight from the NHWC tensor into shared memory,
// realising the zero or reflect ring in the index math (ReflectionPad2d(1):
// -1 -> 1, n -> n-2), so no padded copy of the input and no im2col exist.
// bf16 operands run on the tensor cores through WMMA 16x16x16 fragments
// with f32 accumulation; f32 operands run on f32 FMA (never TF32), because
// the f32 path is the parity path. The epilogue adds the f32 bias and the
// optional LeakyReLU before the single rounding to the output type; the
// statistics variant also writes per-(sample, pixel tile, channel) sum and
// sum of squares of that f32 value, so instance norm needs no second pass
// over the output. Partial sums are per tile, reduced outside in a fixed
// order (deterministic, no atomics). A first, simple kernel: no TMA, no
// wgmma, single-buffered shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int NT = 256;
constexpr int LDA_H = BK + 8;  // bf16 A tile [BM][LDA_H], row major
constexpr int LDB_H = BN + 8;  // bf16 B tile [BK][LDB_H]
constexpr int LDA_F = BM + 4;  // f32 A tile, k-major [BK][LDA_F]
constexpr int LDB_F = BN + 4;  // f32 B tile [BK][LDB_F]
constexpr int LDC = BN + 4;    // f32 accumulator tile [BM][LDC]
constexpr int SMEM_BYTES = BM * LDC * 4;

static_assert(BM * LDA_H * 2 + BK * LDB_H * 2 <= SMEM_BYTES, "bf16 tiles");
static_assert(BK * LDA_F * 4 + BK * LDB_F * 4 <= SMEM_BYTES, "f32 tiles");

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// Source index along an axis of length n for padded position i, or -1 for
// a zero-ring position.
__device__ __forceinline__ int ring(int i, int n, bool reflect) {
  if (i >= 0 && i < n) return i;
  if (!reflect) return -1;
  return i < 0 ? -i : 2 * n - 2 - i;
}

template <typename T>
__device__ __forceinline__ void load_tiles_bf16_layout(
    T* As, T* Bs, const T* __restrict__ x, const T* __restrict__ w,
    int (*s_row)[BM], int (*s_col)[BM], int tap, int c0, int n0,
    int W, int Cin, int Cout) {
  const int dy = tap / 3, dx = tap % 3;
  const T zero = from_f<T>(0.f);
#pragma unroll 4
  for (int i = 0; i < BM * BK / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int m = idx / BK, k = idx % BK, c = c0 + k;
    const int r = s_row[dy][m], cc = s_col[dx][m];
    T v = zero;
    if (r >= 0 && cc >= 0 && c < Cin) v = x[((size_t)r * W + cc) * Cin + c];
    As[m * LDA_H + k] = v;
  }
#pragma unroll 4
  for (int i = 0; i < BK * BN / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int k = idx / BN, n = idx % BN, c = c0 + k, co = n0 + n;
    T v = zero;
    if (c < Cin && co < Cout) v = w[((size_t)tap * Cin + c) * Cout + co];
    Bs[k * LDB_H + n] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
    conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ out,
                   float* __restrict__ stats, int H, int W, int Cin, int Cout,
                   int reflect, int has_leaky, float slope) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ int s_row[3][BM];
  __shared__ int s_col[3][BM];
  __shared__ float s_red[2][NT / BN][BN];

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
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
  const int kchunks = (Cin + BK - 1) / BK;

  if constexpr (sizeof(T) == 2) {
    T* As = reinterpret_cast<T*>(smem);
    T* Bs = As + BM * LDA_H;
    const int warp = tid / 32;
    const int wm = warp % 4, wn = warp / 4;  // 4 x 2 warps of 32 x 32
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int tap = 0; tap < 9; ++tap) {
      for (int kc = 0; kc < kchunks; ++kc) {
        load_tiles_bf16_layout<T>(As, Bs, x, w, s_row, s_col, tap, kc * BK, n0,
                                  W, Cin, Cout);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              fa[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              fb[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(
                fa[i],
                reinterpret_cast<const __nv_bfloat16*>(As) +
                    (wm * 32 + i * 16) * LDA_H + kk,
                LDA_H);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(
                fb[j],
                reinterpret_cast<const __nv_bfloat16*>(Bs) + kk * LDB_H +
                    wn * 32 + j * 16,
                LDB_H);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
  } else {
    float* As = reinterpret_cast<float*>(smem);  // [BK][LDA_F]
    float* Bs = As + BK * LDA_F;                 // [BK][LDB_F]
    const int tx = tid % 16, ty = tid / 16;      // cols tx+16j, rows ty+16i
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      for (int kc = 0; kc < kchunks; ++kc) {
        const int c0 = kc * BK;
#pragma unroll 4
        for (int i = 0; i < BM * BK / NT; ++i) {
          const int idx = tid + i * NT;
          const int m = idx / BK, k = idx % BK, c = c0 + k;
          const int r = s_row[dy][m], cc = s_col[dx][m];
          float v = 0.f;
          if (r >= 0 && cc >= 0 && c < Cin)
            v = to_f(x[((size_t)r * W + cc) * Cin + c]);
          As[k * LDA_F + m] = v;
        }
#pragma unroll 4
        for (int i = 0; i < BK * BN / NT; ++i) {
          const int idx = tid + i * NT;
          const int k = idx / BN, n = idx % BN, c = c0 + k, co = n0 + n;
          float v = 0.f;
          if (c < Cin && co < Cout)
            v = to_f(w[((size_t)tap * Cin + c) * Cout + co]);
          Bs[k * LDB_F + n] = v;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < BK; ++k) {
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
      for (int j = 0; j < 4; ++j)
        Cs[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();

  // epilogue: bias + LeakyReLU in f32, one rounding on the store
#pragma unroll 4
  for (int i = 0; i < BM * BN / NT; ++i) {
    const int idx = tid + i * NT;
    const int m = idx / BN, n = idx % BN;
    const int p = m0 + m, co = n0 + n;
    float v = Cs[m * LDC + n] + (co < Cout ? bias[co] : 0.f);
    if (has_leaky) v = v >= 0.f ? v : slope * v;
    Cs[m * LDC + n] = v;
    if (p < HW && co < Cout) out[(size_t)p * Cout + co] = from_f<T>(v);
  }
  if (stats == nullptr) return;
  __syncthreads();
  {
    const int n = tid % BN, g = tid / BN;  // NT / BN row groups
    constexpr int ROWS = BM / (NT / BN);
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
  if (tid < BN && n0 + tid < Cout) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int g = 0; g < NT / BN; ++g) {
      s += s_red[0][g][tid];
      ss += s_red[1][g][tid];
    }
    // stats: (B, pixel tiles, 2, Cout)
    float* st = stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * Cout;
    st[n0 + tid] = s;
    st[Cout + n0 + tid] = ss;
  }
}

}  // namespace

extern "C" int cocosnet_conv3x3_tile_pixels() { return BM; }

// x: (B, H, W, Cin), w: (3, 3, Cin, Cout), bias: (Cout,) f32, out: (B, H, W,
// Cout) in x's type, stats: null or (B, ceil(H*W/BM), 2, Cout) f32. All
// contiguous. Returns the cudaError_t of the launch.
extern "C" int cocosnet_conv3x3(const void* x, const void* w, const void* bias,
                                void* out, void* stats, int B, int H, int W,
                                int Cin, int Cout, int reflect, int has_leaky,
                                float slope, int is_bf16, void* stream) {
  dim3 grid((H * W + BM - 1) / BM, (Cout + BN - 1) / BN, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    conv3x3_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(stats), H, W, Cin,
        Cout, reflect, has_leaky, slope);
  } else {
    conv3x3_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out),
        static_cast<float*>(stats), H, W, Cin, Cout, reflect, has_leaky, slope);
  }
  return static_cast<int>(cudaGetLastError());
}
