// Building blocks shared by the bf16 paths of conv3x3.cu and conv3x3_dw.cu:
// the zero / reflect ring index, 16-byte cp.async with zero fill, and the
// channel padding of an operand whose channel count is not a multiple of 8.
//
// Both kernels are implicit GEMMs whose operands are rows of NHWC (or HWIO)
// tensors, channels contiguous. They copy 8-channel chunks, 16 bytes each,
// by cp.async, zero-filled where the row is a ring cell or past the tile or
// the channels; that needs every row 16-byte aligned. An operand with
// another channel count (151 and 407 channels at the flagship) is first
// copied with its rows padded to a multiple of 8 channels (pad_channels);
// the kernel then reads the copy with the row stride of the padding. On the
// H100 that beat loading such rows in the kernel itself (2-byte or shifted
// 4-byte words staged through registers, or aligned chunks shifted in
// shared memory) at 407 -> 407 channels, forward and dW.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv3x3 {

// Source index along an axis of length n for padded position i, or -1 for
// a zero-ring position (ReflectionPad2d(1): -1 -> 1, n -> n-2).
__device__ __forceinline__ int ring(int i, int n, bool reflect) {
  if (i >= 0 && i < n) return i;
  if (!reflect) return -1;
  return i < 0 ? -i : 2 * n - 2 - i;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; with valid == false nothing is
// read and the 16 bytes are zeros (src-size 0).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst (rows, ld) = src (rows, n) with zeros in channels n .. ld-1: the
// channel-padded copy of an operand whose channel count is not a multiple of
// 8, so that every row of the copy is 16-byte aligned. Each thread writes 16
// bytes; a warp's reads of a row are contiguous.
__global__ void pad_channels_kernel(const __nv_bfloat16* __restrict__ src,
                                    __nv_bfloat16* __restrict__ dst,
                                    long long rows, int n, int ld) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  const int cpr = ld / 8;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < rows * cpr; q += (long long)gridDim.x * blockDim.x) {
    const long long r = q / cpr;
    const int c = (int)(q - r * cpr) * 8;
    uint32_t e[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      e[k] = c + k < n ? __ldg(s + r * n + c + k) : 0u;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                   e[4] | (e[5] << 16), e[6] | (e[7] << 16));
  }
}

// Launches pad_channels_kernel on `stream`; returns its launch error.
inline cudaError_t pad_channels(const __nv_bfloat16* src, __nv_bfloat16* dst,
                                long long rows, int n, int ld,
                                cudaStream_t stream) {
  const long long chunks = rows * (ld / 8);
  const long long want = (chunks + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
  pad_channels_kernel<<<blocks, 256, 0, stream>>>(src, dst, rows, n, ld);
  return cudaGetLastError();
}

}  // namespace conv3x3
