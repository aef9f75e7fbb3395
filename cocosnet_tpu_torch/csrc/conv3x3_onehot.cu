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
// traffic, and the arithmetic is negligible. So on this card the one-hot
// product is not translated at all: it is a gather.
//
// Design: a block owns 128 pixels of one sample x 64 output channels; the 64
// channel lanes of a pixel read the same 9 labels (a broadcast) and 9
// consecutive weight rows (coalesced, served from L1/L2: the 9 x C x Cout
// table is a few hundred KB), sum in f32 and store one coalesced row of the
// output. Positions outside the image and ids outside [0, C) - the -1
// sentinel among them - contribute nothing, exactly as a zero one-hot row.
// The optional statistics epilogue writes per-(sample, pixel tile, channel)
// sum and sum of squares of the f32 value before rounding, reduced outside
// like the dense conv's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int PB = 128;     // pixels per block
constexpr int CL = 64;      // channel lanes per block
constexpr int NT = 256;
constexpr int RG = NT / CL;  // pixel groups

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    onehot_kernel(const int* __restrict__ labels, const T* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ out,
                  float* __restrict__ stats, int H, int W, int C, int Cout,
                  int has_leaky, float slope) {
  __shared__ float s_red[2][RG][CL];
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * PB;
  const int tx = threadIdx.x % CL, ty = threadIdx.x / CL;
  const int co = blockIdx.y * CL + tx;
  const bool cok = co < Cout;
  const int HW = H * W;
  labels += (size_t)b * HW;
  out += (size_t)b * HW * Cout;
  const float b0 = cok ? bias[co] : 0.f;
  float s = 0.f, ss = 0.f;
  for (int i = ty; i < PB; i += RG) {
    const int p = m0 + i;
    if (p >= HW) break;
    const int oh = p / W, ow = p % W;
    float acc = b0;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int ih = oh + dy - 1;
      if (ih < 0 || ih >= H) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int iw = ow + dx - 1;
        if (iw < 0 || iw >= W) continue;
        const int id = labels[ih * W + iw];
        if (id < 0 || id >= C || !cok) continue;
        acc += to_f(w[((size_t)(dy * 3 + dx) * C + id) * Cout + co]);
      }
    }
    if (has_leaky) acc = acc >= 0.f ? acc : slope * acc;
    if (cok) out[(size_t)p * Cout + co] = from_f<T>(acc);
    s += acc;
    ss += acc * acc;
  }
  if (stats == nullptr) return;
  s_red[0][ty][tx] = s;
  s_red[1][ty][tx] = ss;
  __syncthreads();
  if (ty == 0 && cok) {
    float a = 0.f, q = 0.f;
#pragma unroll
    for (int g = 0; g < RG; ++g) {
      a += s_red[0][g][tx];
      q += s_red[1][g][tx];
    }
    float* st = stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * Cout;
    st[co] = a;
    st[Cout + co] = q;
  }
}

}  // namespace

extern "C" int cocosnet_onehot_tile_pixels() { return PB; }

// labels: (B, H, W) int32, w: (3, 3, C, Cout) in the output type, bias:
// (Cout,) f32, out: (B, H, W, Cout), stats: null or (B, ceil(H*W/128), 2,
// Cout) f32. All contiguous. Returns the cudaError_t of the launch.
extern "C" int cocosnet_conv3x3_onehot(const void* labels, const void* w,
                                       const void* bias, void* out, void* stats,
                                       int B, int H, int W, int C, int Cout,
                                       int has_leaky, float slope, int is_bf16,
                                       void* stream) {
  dim3 grid((H * W + PB - 1) / PB, (Cout + CL - 1) / CL, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    onehot_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const int*>(labels), static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(stats), H, W, C, Cout, has_leaky, slope);
  } else {
    onehot_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const int*>(labels), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out),
        static_cast<float*>(stats), H, W, C, Cout, has_leaky, slope);
  }
  return static_cast<int>(cudaGetLastError());
}
