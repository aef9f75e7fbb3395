// The reflect ring of an NHWC tensor, forward and backward: ReflectionPad2d
// of width p on (B, H, W, C), with torch's reflect indexing (-1 -> 1,
// n -> n - 2), for the library convolutions of training and of the small
// maps (nn/layers.conv2d). It replaces no TPU kernel: the JAX package pads
// with XLA, whose layouts are its own. On the card, F.pad of the NHWC
// activation's NCHW view made the input NCHW-contiguous and padded it there,
// so cuDNN transformed it back to NHWC before its tensor-core engine, and the
// backward scattered the ring's gradient with atomics. Built here in NHWC,
// the ring hands cuDNN a channels-last operand and takes none of that.
//
// Both kernels are bound by device memory: the forward reads each input
// byte once (the ring's re-reads hit L2) and writes the padded tensor once;
// the backward reads each gradient byte once and writes dx once. A block
// owns one row of its output and walks it in vectors of up to 16 bytes
// along the contiguous channels (the wrapper picks the widest vector that
// divides a pixel's bytes and the pointers' alignment); each thread keeps
// kPer vectors in flight.
//
// Forward: a gather; it moves bytes, whatever the dtype. Backward: no
// atomics. Each dx pixel sums its own gradient and the mirrored ring cells
// that copied it (up to 3 rows x 3 columns where p reaches both edges) in
// f32, in a fixed order, and rounds once to the gradient's dtype, so two
// runs give the same bits.
//
// The kernels' names hold no substring of a kernel family of
// utils/profiling.KERNEL_FAMILIES: they count as "elementwise / other",
// where torch's reflection_pad2d kernels counted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                 // vectors in flight per thread
constexpr int kMaxRowBlocks = 65535;    // gridDim.y

// torch's reflect index of t in [-p, n + p) onto [0, n)
__device__ __forceinline__ int mirror(int t, int n) {
  t = t < 0 ? -t : t;
  return t >= n ? 2 * (n - 1) - t : t;
}

// One padded row (b, i) a block row: out[b, i, j, :] = x[b, mirror(i - p),
// mirror(j - p), :], in vectors of V (vpp vectors a pixel).
template <typename V>
__global__ void __launch_bounds__(kThreads)
reflect_ring_fwd(const V* __restrict__ x, V* __restrict__ out, int batch,
                 int h, int w, int vpp, int p) {
  const int hp = h + 2 * p, wp = w + 2 * p;
  const int row_vecs = wp * vpp;
  const int64_t rows = static_cast<int64_t>(batch) * hp;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const int b = static_cast<int>(row / hp);
    const int i = static_cast<int>(row - static_cast<int64_t>(b) * hp);
    const V* src = x + (static_cast<int64_t>(b) * h + mirror(i - p, h)) *
                           static_cast<int64_t>(w) * vpp;
    V* dst = out + row * row_vecs;
    const int t0 = blockIdx.x * (kThreads * kPer) + threadIdx.x;
    V buf[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int t = t0 + k * kThreads;
      if (t < row_vecs) {
        const int j = t / vpp;
        const int v = t - j * vpp;
        buf[k] = src[mirror(j - p, w) * vpp + v];
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int t = t0 + k * kThreads;
      if (t < row_vecs) dst[t] = buf[k];
    }
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int E>
struct alignas(sizeof(T) * E) Pack {
  T v[E];
};

// The padded indices of one dimension of size n that read index t, in the
// order they are summed: the interior first, then the low mirror, then the
// high one. Returns their count (1 to 3).
__device__ __forceinline__ int sources(int t, int n, int p, int* idx) {
  int c = 0;
  idx[c++] = t + p;
  if (t >= 1 && t <= p) idx[c++] = p - t;
  if (t >= n - 1 - p && t <= n - 2) idx[c++] = p + 2 * (n - 1) - t;
  return c;
}

// One dx row (b, r) a block row: dx[b, r, c, :] = the f32 sum of g over the
// padded cells that copied x[b, r, c, :], rounded once. E elements a vector,
// vpp vectors a pixel.
template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
reflect_ring_bwd(const Pack<T, E>* __restrict__ g, Pack<T, E>* __restrict__ dx,
                 int batch, int h, int w, int vpp, int p) {
  const int hp = h + 2 * p, wp = w + 2 * p;
  const int row_vecs = w * vpp;
  const int64_t rows = static_cast<int64_t>(batch) * h;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const int b = static_cast<int>(row / h);
    const int r = static_cast<int>(row - static_cast<int64_t>(b) * h);
    int ri[3];
    const int nr = sources(r, h, p, ri);
    const Pack<T, E>* gb = g + static_cast<int64_t>(b) * hp * wp * vpp;
    Pack<T, E>* dst = dx + row * row_vecs;
    const int t0 = blockIdx.x * (kThreads * kPer) + threadIdx.x;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int t = t0 + k * kThreads;
      if (t >= row_vecs) continue;
      const int c = t / vpp;
      const int v = t - c * vpp;
      int ci[3];
      const int nc = sources(c, w, p, ci);
      float acc[E];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = 0.f;
      for (int a = 0; a < nr; ++a) {
        const Pack<T, E>* grow = gb + static_cast<int64_t>(ri[a]) * wp * vpp;
        for (int q = 0; q < nc; ++q) {
          const Pack<T, E> val = grow[ci[q] * vpp + v];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] += to_f32(val.v[e]);
        }
      }
      Pack<T, E> res;
#pragma unroll
      for (int e = 0; e < E; ++e) res.v[e] = from_f32<T>(acc[e]);
      dst[t] = res;
    }
  }
}

dim3 grid_for(int row_vecs, int64_t rows) {
  const int per_block = kThreads * kPer;
  return dim3((row_vecs + per_block - 1) / per_block,
              static_cast<unsigned>(rows < kMaxRowBlocks ? rows
                                                         : kMaxRowBlocks));
}

template <typename V>
int launch_fwd(const void* x, void* out, int batch, int h, int w,
               int pixel_bytes, int p, cudaStream_t stream) {
  const int vpp = pixel_bytes / static_cast<int>(sizeof(V));
  const int64_t rows = static_cast<int64_t>(batch) * (h + 2 * p);
  reflect_ring_fwd<V><<<grid_for((w + 2 * p) * vpp, rows), kThreads, 0,
                        stream>>>(static_cast<const V*>(x),
                                  static_cast<V*>(out), batch, h, w, vpp, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E>
int launch_bwd(const void* g, void* dx, int batch, int h, int w, int c,
               int p, cudaStream_t stream) {
  using P = Pack<T, E>;
  const int vpp = c / E;
  const int64_t rows = static_cast<int64_t>(batch) * h;
  reflect_ring_bwd<T, E><<<grid_for(w * vpp, rows), kThreads, 0, stream>>>(
      static_cast<const P*>(g), static_cast<P*>(dx), batch, h, w, vpp, p);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int batch, int h, int w, int c, int p) {
  return batch > 0 && c > 0 && p >= 1 && p < h && p < w;
}

}  // namespace

// x (B, H, W, C) -> out (B, H + 2p, W + 2p, C), both contiguous, each
// element `elem_bytes` wide; `vec_bytes` (16, 8, 4 or 2) divides C *
// elem_bytes and both pointers' alignment. Returns the launch's
// cudaError_t.
extern "C" int cocosnet_reflect_ring_fwd(const void* x, void* out, int batch,
                                         int h, int w, int c, int elem_bytes,
                                         int p, int vec_bytes,
                                         void* stream) {
  const int pixel_bytes = c * elem_bytes;
  if (!shape_ok(batch, h, w, c, p) || vec_bytes <= 0 ||
      pixel_bytes % vec_bytes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return launch_fwd<uint4>(x, out, batch, h, w, pixel_bytes, p, s);
    case 8: return launch_fwd<uint2>(x, out, batch, h, w, pixel_bytes, p, s);
    case 4:
      return launch_fwd<uint32_t>(x, out, batch, h, w, pixel_bytes, p, s);
    case 2:
      return launch_fwd<uint16_t>(x, out, batch, h, w, pixel_bytes, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// g (B, H + 2p, W + 2p, C) -> dx (B, H, W, C), both contiguous, bf16
// (elem_bytes 2) or f32 (4); `vec_bytes` as the forward's. Returns the
// launch's cudaError_t.
extern "C" int cocosnet_reflect_ring_bwd(const void* g, void* dx, int batch,
                                         int h, int w, int c, int elem_bytes,
                                         int p, int vec_bytes,
                                         void* stream) {
  if (!shape_ok(batch, h, w, c, p) || (elem_bytes != 2 && elem_bytes != 4) ||
      vec_bytes < elem_bytes || (c * elem_bytes) % vec_bytes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    switch (vec_bytes) {
      case 16: return launch_bwd<__nv_bfloat16, 8>(g, dx, batch, h, w, c, p, s);
      case 8: return launch_bwd<__nv_bfloat16, 4>(g, dx, batch, h, w, c, p, s);
      case 4: return launch_bwd<__nv_bfloat16, 2>(g, dx, batch, h, w, c, p, s);
      case 2: return launch_bwd<__nv_bfloat16, 1>(g, dx, batch, h, w, c, p, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (vec_bytes) {
    case 16: return launch_bwd<float, 4>(g, dx, batch, h, w, c, p, s);
    case 8: return launch_bwd<float, 2>(g, dx, batch, h, w, c, p, s);
    case 4: return launch_bwd<float, 1>(g, dx, batch, h, w, c, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
