// 3x3 stride-1 zero-padded convolution of a one-hot label map, computed as a
// gather from the weight table: the one-hot tensor never exists.
//
// Replaces: cocosnet_tpu/ops/pallas_conv.py `conv3x3_onehot` (`_onehot_kernel`),
// which expands the one-hot rows on chip and multiplies them on the TPU's
// matrix unit.
//
// Bound on the H100: bytes. out[b,h,w,:] = bias + sum over the 9 taps of
// W[dy, dx, label(h+dy-1, w+dx-1), :] is 9 adds per output element: the
// label map in (4 bytes a pixel) and the (B, H, W, Cout) output out are the
// traffic (6 x 256 x 256 x 64 in bf16: 50.3 MB out and 1.6 MB in, 0.016 ms
// at 3.35 TB/s), and the arithmetic is negligible. So on this card the
// one-hot product is not translated at all: it is a gather.
//
// Design: the gather reads 9 weight rows per output row, 9 x 128 bytes per
// pixel at 64 bf16 channels: 453 MB at the flagship, more than the L2
// serves in the output's time when the labels are random (left to L1, the
// rows come from the L2 at about its rate). So the table lives in shared
// memory: one block of 1024 threads per SM (persistent; about
// one block an SM over the card) copies its slice of the (3, 3, C, Cout)
// table - 64 channels in bf16 and 32 in f32 at C 151, 174 KB - into shared
// memory once, then walks tiles of 8 image rows x 128 columns of its
// sample. Per tile it stages the labels and a one-position ring around
// them, positions outside the image and ids outside [0, C) - the -1
// sentinel among them - as -1, which adds nothing, exactly as a zero
// one-hot row. A thread owns one pixel x 8 output channels at a time: it
// reads the 9 table rows as 16-byte vectors from shared memory (a warp's 4
// pixels x 128 bytes: conflict-free), sums them over the bias in f32 in
// tap order and stores its 8 channels at once: a warp stores 4 consecutive
// pixels, 512 contiguous bytes of a bf16 output of 64 channels. What bounds
// it then is issue and latency rather than bytes: 9 shared loads, 72
// conversions and 72 adds per 8 output values, at the 32 warps an SM that
// one block allows (16 were slower). The wrapper pads the table's rows to
// a multiple of 8 channels where Cout is not one; the output is then stored
// channel by channel. The optional statistics: each thread sums its values
// and their squares (the f32 value before rounding) in registers over all
// its tiles, the block sums them across its threads in a fixed order into
// per-block partials, and a second launch sums those in a fixed order and
// writes the instance-norm moments, single pass: mean = E[x], var =
// max(E[x^2] - mean^2, 0). No atomics: two launches give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace onehot {

constexpr int NT = 1024;
constexpr int CG = 8;            // output channels a thread stores at once
constexpr int TR = 8;            // tile rows
constexpr int TW = 128;          // tile columns
constexpr int LW = TW + 2;       // a staged label row
constexpr int TABLE_MAX = 200 * 1024;  // bytes of table a block may hold

// GB channel groups a block: CB = 8 GB channels; PL pixel lanes
template <int GB>
struct Geo {
  static constexpr int CB = CG * GB;
  static constexpr int PL = NT / GB;
  static constexpr int PIX = TR * TW / PL;  // pixels a thread per tile
  static constexpr int RED = NT / 32 * CB * 2;  // floats: per-warp sums
};

// the most channel groups (8, 4 or 2) whose slice of the table fits a
// block, or 0: 2 holds up to 355 classes in f32, 711 in bf16
inline int groups(int C, int elem) {
  for (int gb = 8; gb >= 2; gb /= 2)
    if ((size_t)9 * C * CG * gb * elem <= TABLE_MAX) return gb;
  return 0;
}

// 8 table values at p, widened to f32
__device__ __forceinline__ void load8(const float* p, float (&x)[CG]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[CG]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&x)[CG]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&x)[CG]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Grid (blocks a sample, ceil(coP / CB), B): block (x, y, b) takes the
// tiles x, x + gridDim.x, ... of sample b (tiles of TR rows x TW columns,
// row-major) and the output channels y CB ... w: (3, 3, C, coP) with coP =
// Cout rounded up to CG, 16-byte aligned; part: null or (B, gridDim.x, 2,
// Cout), the block's sums of the values and of their squares.
template <typename T, int GB>
__global__ void __launch_bounds__(NT, 1) onehot_kernel(
    const int* __restrict__ labels, const T* __restrict__ w,
    const float* __restrict__ bias, T* __restrict__ out,
    float* __restrict__ part, int H, int W, int C, int Cout, int has_leaky,
    float slope) {
  using G = Geo<GB>;
  constexpr int VEC = 16 / sizeof(T);   // values a 16-byte vector
  extern __shared__ __align__(16) unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);  // [9][C][CB]
  float* red = reinterpret_cast<float*>(smem + (size_t)9 * C * G::CB *
                                                   sizeof(T));
  int* lab = reinterpret_cast<int*>(red + G::RED);  // [TR + 2][LW]
  const int b = blockIdx.z, c0 = blockIdx.y * G::CB;
  const int coP = (Cout + CG - 1) / CG * CG;

  // the block's slice of the table, zero past coP
  for (int e = threadIdx.x; e < 9 * C * (G::CB / VEC); e += NT) {
    const int row = e / (G::CB / VEC), col = e % (G::CB / VEC) * VEC;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (c0 + col < coP)
      x = __ldg(reinterpret_cast<const uint4*>(w + (size_t)row * coP + c0 +
                                               col));
    reinterpret_cast<uint4*>(tab)[e] = x;
  }

  const int cg = threadIdx.x % GB, pl = threadIdx.x / GB;
  const int co0 = c0 + cg * CG;
  const bool cok = co0 < Cout, vec = Cout % CG == 0;
  float b0[CG], s[CG], ss[CG];
#pragma unroll
  for (int k = 0; k < CG; ++k) {
    b0[k] = cok && co0 + k < Cout ? bias[co0 + k] : 0.f;
    s[k] = 0.f;
    ss[k] = 0.f;
  }
  labels += (size_t)b * H * W;
  out += (size_t)b * H * W * Cout;
  const int across = (W + TW - 1) / TW;
  const int tiles = (H + TR - 1) / TR * across;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int h0 = tile / across * TR, w0 = tile % across * TW;
    __syncthreads();  // the table is in; the last tile's labels are read
    for (int e = threadIdx.x; e < (TR + 2) * LW; e += NT) {
      const int ih = h0 - 1 + e / LW, iw = w0 - 1 + e % LW;
      int id = -1;
      if (ih >= 0 && ih < H && iw >= 0 && iw < W) {
        id = labels[(size_t)ih * W + iw];
        if (id < 0 || id >= C) id = -1;
      }
      lab[e] = id;
    }
    __syncthreads();
    if (!cok) continue;
#pragma unroll 4
    for (int i = 0; i < G::PIX; ++i) {
      const int p = pl + G::PL * i;
      const int r = p / TW, c = p % TW;
      const int oh = h0 + r, ow = w0 + c;
      if (oh >= H || ow >= W) continue;
      float acc[CG];
#pragma unroll
      for (int k = 0; k < CG; ++k) acc[k] = b0[k];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int id = lab[(r + dy) * LW + c + dx];
          if (id < 0) continue;
          float x[CG];
          load8(tab + ((dy * 3 + dx) * C + id) * G::CB + cg * CG, x);
#pragma unroll
          for (int k = 0; k < CG; ++k) acc[k] += x[k];
        }
      if (has_leaky)
#pragma unroll
        for (int k = 0; k < CG; ++k)
          acc[k] = acc[k] >= 0.f ? acc[k] : slope * acc[k];
      T* dst = out + ((size_t)oh * W + ow) * Cout + co0;
      if (vec) {
        store8(dst, acc);
      } else {
#pragma unroll
        for (int k = 0; k < CG; ++k)
          if (co0 + k < Cout) store1(dst + k, acc[k]);
      }
#pragma unroll
      for (int k = 0; k < CG; ++k) {
        s[k] += acc[k];
        ss[k] += acc[k] * acc[k];
      }
    }
  }
  if (part == nullptr) return;

  // the block's sums: the warp's pixel lanes of each channel group (lanes
  // GB apart), then the warps in order
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int o = GB; o < 32; o *= 2)
#pragma unroll
    for (int k = 0; k < CG; ++k) {
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
      ss[k] += __shfl_xor_sync(0xffffffffu, ss[k], o);
    }
  if (lane < GB)
#pragma unroll
    for (int k = 0; k < CG; ++k) {
      red[(warp * G::CB + lane * CG + k) * 2] = s[k];
      red[(warp * G::CB + lane * CG + k) * 2 + 1] = ss[k];
    }
  __syncthreads();
  const int co = c0 + threadIdx.x;
  if (threadIdx.x < G::CB && co < Cout) {
    float a = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < NT / 32; ++i) {
      a += red[(i * G::CB + threadIdx.x) * 2];
      q += red[(i * G::CB + threadIdx.x) * 2 + 1];
    }
    float* st = part + ((size_t)b * gridDim.x + blockIdx.x) * 2 * Cout;
    st[co] = a;
    st[Cout + co] = q;
  }
}

constexpr int NTM = 256;   // the moments launch: threads,
constexpr int CM = 64;     // channels a block
constexpr int RANGES = NTM / CM;  // and ranges of partials a channel

// Launch 2. Grid (B, ceil(Cout / CM)): each channel's partials summed over
// the blocks in RANGES contiguous ranges, each in order, then the ranges in
// order; moments: (2, B, Cout), mean and var of the n = H W values.
__global__ void __launch_bounds__(NTM) moments_kernel(
    const float* __restrict__ part, float* __restrict__ moments, int B,
    int parts, int Cout, float n) {
  __shared__ float red[RANGES][CM][2];
  const int b = blockIdx.x, c = threadIdx.x % CM, q = threadIdx.x / CM;
  const int co = blockIdx.y * CM + c;
  const int per = (parts + RANGES - 1) / RANGES;
  const int t1 = min(parts, (q + 1) * per);
  float a = 0.f, sq = 0.f;
  if (co < Cout)
#pragma unroll 8
    for (int t = q * per; t < t1; ++t) {
      const float* st = part + ((size_t)b * parts + t) * 2 * Cout;
      a += st[co];
      sq += st[Cout + co];
    }
  red[q][c][0] = a;
  red[q][c][1] = sq;
  __syncthreads();
  if (q != 0 || co >= Cout) return;
#pragma unroll
  for (int i = 1; i < RANGES; ++i) {
    a += red[i][c][0];
    sq += red[i][c][1];
  }
  // ops/conv3x3._moments' operations, in its order
  const float mean = __fdiv_rn(a, n);
  const float var =
      fmaxf(__fsub_rn(__fdiv_rn(sq, n), __fmul_rn(mean, mean)), 0.f);
  moments[(size_t)b * Cout + co] = mean;
  moments[((size_t)B + b) * Cout + co] = var;
}

// blocks a sample: about one block an SM over the card, at most one a tile
inline int blocks_per_sample(int B, int H, int W, int Cout, int gb, int sms) {
  const int cblocks = (Cout + CG * gb - 1) / (CG * gb);
  const int tiles = (H + TR - 1) / TR * ((W + TW - 1) / TW);
  const int want = (sms + cblocks * B - 1) / (cblocks * B);
  return want < tiles ? want : tiles;
}

template <typename T, int GB>
int run(const int* labels, const void* w, const float* bias, void* out,
        float* part, float* moments, int B, int H, int W, int C, int Cout,
        int has_leaky, float slope, int sms, cudaStream_t s) {
  using G = Geo<GB>;
  const auto kernel = onehot_kernel<T, GB>;
  const int smem = 9 * C * G::CB * sizeof(T) + 4 * G::RED +
                   4 * (TR + 2) * LW;
  int e = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (e) return e;
  const int bps = blocks_per_sample(B, H, W, Cout, GB, sms);
  kernel<<<dim3(bps, (Cout + G::CB - 1) / G::CB, B), NT, smem, s>>>(
      labels, static_cast<const T*>(w), bias, static_cast<T*>(out), part, H,
      W, C, Cout, has_leaky, slope);
  e = static_cast<int>(cudaGetLastError());
  if (e || part == nullptr) return e;
  moments_kernel<<<dim3(B, (Cout + CM - 1) / CM), NTM, 0, s>>>(
      part, moments, B, bps, Cout, static_cast<float>(H * W));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_any(int gb, const int* labels, const void* w, const float* bias,
            void* out, float* part, float* moments, int B, int H, int W,
            int C, int Cout, int has_leaky, float slope, int sms,
            cudaStream_t s) {
  using Fn = decltype(&run<T, 8>);
  const Fn fn = gb == 8 ? &run<T, 8> : gb == 4 ? &run<T, 4> : &run<T, 2>;
  return fn(labels, w, bias, out, part, moments, B, H, W, C, Cout, has_leaky,
            slope, sms, s);
}

}  // namespace onehot

// The blocks a sample at (B, H, W, C, Cout) on a card of `sms` SMs (the
// per-block partials of the statistics hold that many), or 0 where the
// table of C classes does not fit a block's shared memory.
extern "C" int cocosnet_onehot_blocks(int B, int H, int W, int C, int Cout,
                                      int is_bf16, int sms) {
  const int gb = onehot::groups(C, is_bf16 ? 2 : 4);
  return gb ? onehot::blocks_per_sample(B, H, W, Cout, gb, sms) : 0;
}

// labels: (B, H, W) int32, w: (3, 3, C, Cout') in the output type with
// Cout' the multiple of 8 at or above Cout (zero filled), 16-byte aligned;
// bias: (Cout,) f32, out: (B, H, W, Cout); part and moments both null, or
// (B, blocks, 2, Cout) scratch (blocks = cocosnet_onehot_blocks(...)) and
// (2, B, Cout) f32 mean and var. All contiguous; B <= 65535. One launch, two
// with the moments, on `stream`; returns the first cudaError_t that is not
// success.
extern "C" int cocosnet_conv3x3_onehot(const void* labels, const void* w,
                                       const void* bias, void* out,
                                       void* part, void* moments, int B,
                                       int H, int W, int C, int Cout,
                                       int has_leaky, float slope,
                                       int is_bf16, int sms, void* stream) {
  const int gb = onehot::groups(C, is_bf16 ? 2 : 4);
  if (gb == 0 || (part == nullptr) != (moments == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto run = is_bf16 ? &onehot::run_any<__nv_bfloat16>
                           : &onehot::run_any<float>;
  return run(gb, static_cast<const int*>(labels), w,
             static_cast<const float*>(bias), out, static_cast<float*>(part),
             static_cast<float*>(moments), B, H, W, C, Cout, has_leaky, slope,
             sms, static_cast<cudaStream_t>(stream));
}
