// Split-precision products on the tensor cores, shared by the correlation
// kernels (corr_bwd.cu, corr_fwd.cu, shift9_fwd.cu, shift9_bwd.cu): f32
// operands in, f32 sums out, each product issued as three TF32 passes on
// mma.sync.m16n8k8.
//
// 3xTF32: each operand x splits into hi = tf32(x) and lo = tf32(x - hi)
// (round to nearest, ties away), and every product a b is issued as
// a_lo b_hi + a_hi b_lo + a_hi b_hi into an f32 accumulator: about 22 bits
// of each operand, where a single TF32 pass keeps 11 and tau = 0.01 would
// amplify that 100x in the logits. The split happens on the fragments, in
// registers, as they leave shared memory (tests/test_torch_corr_split.py
// and tests/test_torch_shift9_split.py emulate it on the CPU).
//
// The tensor cores round each mma's sum toward zero (products exact, no
// round to nearest), so a long chain of mma into one accumulator drifts by
// up to an ulp per step: the kernels sum at most one 32-deep stage (12
// mma) into a zeroed partial and add it to the running sum in f32.
//
// What is here: 16-byte cp.async copies with zero fill, the split, the
// mma, the staging loaders, and the block-level pieces of the tiled GEMM
// out = A B: `Ring` (a stage's shared-memory layout), `mainloop` (the
// pipelined, stage-flushed product of one 128-row tile) and `gemm_kernel`
// (one launch of that GEMM over a grid of tiles).
//
// Tiles: 256 threads, 8 warps as 2 (rows) x 4 (columns); a warp owns 64
// rows x 8 NF columns (4 x NF m16n8 accumulators); a stage holds 32 of the
// contraction; STAGES stages of 16-byte cp.async in flight (zero fill past
// the ends). Fragments load as float2 where the operand allows: the mma's
// contraction slots t and t + 4 take the staged columns 2 t and 2 t + 1 of
// each 8 (any order of a sum's terms is the same sum, and both operands
// use the same order), and an M-major A's fragment rows g and g + 8 take
// the tile rows 2 g and 2 g + 1 (the epilogue stores them there). Staging
// strides keep every fragment read conflict-free: K-major rows of 40
// floats (banks 8 g + 2 t, + 1), contraction-major rows of width + 4
// floats (banks 8 t + g; 8 t + 2 g, + 1 for an M-major A). No atomics:
// every output element is summed by one thread in one order, so two
// launches give the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int TILE = 128;     // rows of every GEMM tile
constexpr int BK = 32;        // contraction per stage
constexpr int STAGES = 3;
constexpr int NT = 256;
constexpr int LDK = BK + 8;   // K-major staging stride (floats)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros if !ok
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo + (about 2^-22 |x|), hi and lo TF32 rounded to nearest,
// ties away (what cvt.rna.tf32.f32 gives), in integer and f32 arithmetic
// at full rate instead of two conversions: half a TF32 ulp is added to the
// f32 pattern and the 13 bits below it are masked off (hi) or left for the
// tensor cores, which ignore them (lo).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ROWS x BK of a row-major (rows, K) matrix g (leading dimension ld),
// rows row0.., contraction k0..; rows outside [0, nrows) and columns past
// K (a multiple of 4) load as zeros. Staged [ROWS][LDK]. NTH: the block's
// threads, all of which call it.
template <int ROWS, int NTH = NT>
__device__ __forceinline__ void load_kmajor(float* s, const float* g, int ld,
                                            int row0, int nrows, int k0,
                                            int K) {
  constexpr int CPR = BK / 4, CH = ROWS * CPR;
#pragma unroll
  for (int i = 0; i < (CH + NTH - 1) / NTH; ++i) {
    const int e = threadIdx.x + NTH * i;
    if (CH % NTH != 0 && e >= CH) break;
    const int r = e / CPR, c = (e % CPR) * 4;
    const bool ok = static_cast<unsigned>(row0 + r) <
                        static_cast<unsigned>(nrows) && k0 + c < K;
    cp16(s + r * LDK + c, ok ? g + (size_t)(row0 + r) * ld + k0 + c : g, ok);
  }
}

// BK x COLS of a row-major (K, cols) matrix g (leading dimension ld), rows
// (the contraction) k0.., columns col0..; rows outside [0, krows) and
// columns past ncols (a multiple of 4) load as zeros. Staged [BK][COLS + 4].
template <int COLS, int NTH = NT>
__device__ __forceinline__ void load_kmn(float* s, const float* g, int ld,
                                         int k0, int krows, int col0,
                                         int ncols) {
  constexpr int CPR = COLS / 4, CH = BK * CPR;
#pragma unroll
  for (int i = 0; i < (CH + NTH - 1) / NTH; ++i) {
    const int e = threadIdx.x + NTH * i;
    if (CH % NTH != 0 && e >= CH) break;
    const int r = e / CPR, c = (e % CPR) * 4;
    const bool ok = static_cast<unsigned>(k0 + r) <
                        static_cast<unsigned>(krows) && col0 + c < ncols;
    cp16(s + r * (COLS + 4) + c,
         ok ? g + (size_t)(k0 + r) * ld + col0 + c : g, ok);
  }
}

template <int NF>
__device__ __forceinline__ void zero(float (&acc)[4][NF][4]) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < NF; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

template <bool A_KMAJOR, bool B_KMAJOR, int NF>
struct Ring {
  static constexpr int BN = 32 * NF;
  static constexpr int LDA = A_KMAJOR ? LDK : TILE + 4;
  static constexpr int LDB = B_KMAJOR ? LDK : BN + 4;
  static constexpr int A_FLOATS = A_KMAJOR ? TILE * LDK : BK * LDA;
  static constexpr int B_FLOATS = B_KMAJOR ? BN * LDK : BK * LDB;
  static constexpr int STAGE = A_FLOATS + B_FLOATS;
  static constexpr int BYTES = 4 * STAGES * STAGE;
};

// acc[mi][ni] += the warp's 64 x 8 NF part of the TILE x BN product of the
// nk staged contraction chunks; load(sA, sB, k0) issues one stage's
// copies. Every thread of the block calls it. With FLUSH, each stage's 12
// mma per element go into a zeroed partial that is added to acc in f32
// (round to nearest), which keeps every chain 12 long.
template <bool A_KMAJOR, bool B_KMAJOR, int NF, bool FLUSH, class Load>
__device__ __forceinline__ void mainloop(float (&acc)[4][NF][4], float* smem,
                                         int nk, Load load) {
  using R = Ring<A_KMAJOR, B_KMAJOR, NF>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 64 * (warp >> 2), c0 = 8 * NF * (warp & 3);
  __syncthreads();  // the ring is free (a previous mainloop may read it)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(smem + s * R::STAGE, smem + s * R::STAGE + R::A_FLOATS,
                     s * BK);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage kt is in; stage kt - 1 is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) {
      float* st = smem + (nxt % STAGES) * R::STAGE;
      load(st, st + R::A_FLOATS, nxt * BK);
    }
    cp_commit();
    const float* sA = smem + (kt % STAGES) * R::STAGE;
    const float* sB = sA + R::A_FLOATS;
    float part[4][NF][4];
    if (FLUSH) zero(part);
    float(&sum)[4][NF][4] = FLUSH ? part : acc;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      // [0]: hi, [1]: lo
      uint32_t bf[2][NF][2], af[2][4][4];
#pragma unroll
      for (int ni = 0; ni < NF; ++ni) {
        const int n = c0 + 8 * ni + g;
        float2 x;
        if (B_KMAJOR) {
          x = *reinterpret_cast<const float2*>(sB + n * R::LDB + kk + 2 * t);
        } else {
          x.x = sB[(kk + 2 * t) * R::LDB + n];
          x.y = sB[(kk + 2 * t + 1) * R::LDB + n];
        }
        split(x.x, bf[0][ni][0], bf[1][ni][0]);
        split(x.y, bf[0][ni][1], bf[1][ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        float x[4];
        if (A_KMAJOR) {
          const float* a = sA + (r0 + 16 * mi + g) * R::LDA + kk + 2 * t;
          const float2 u = *reinterpret_cast<const float2*>(a);
          const float2 w = *reinterpret_cast<const float2*>(a + 8 * R::LDA);
          x[0] = u.x;
          x[1] = w.x;
          x[2] = u.y;
          x[3] = w.y;
        } else {
          const float* a = sA + (kk + 2 * t) * R::LDA + r0 + 16 * mi + 2 * g;
          const float2 u = *reinterpret_cast<const float2*>(a);
          const float2 w = *reinterpret_cast<const float2*>(a + R::LDA);
          x[0] = u.x;
          x[1] = u.y;
          x[2] = w.x;
          x[3] = w.y;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) split(x[j], af[0][mi][j], af[1][mi][j]);
      }
      // the three passes in turn, so that 4 NF independent mma separate
      // two into one accumulator: a_lo b_hi, a_hi b_lo, a_hi b_hi
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < NF; ++ni)
            mma(sum[mi][ni], af[pass == 0][mi], bf[pass == 1][ni]);
    }
    if (FLUSH)
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < NF; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
  }
  cp_wait<0>();
}

// out[b][i][j] = sum_kk A(b, i, kk) Bm[b][kk][j] over the padded
// contraction K (a multiple of BK) for i < rows, j < cols. SRC, a type of
// the calling source, names the instance after it (a profile tells the
// correlation backward's GEMMs from the shift9 backward's). Grid (ceil(cols
// / BN), rows padded to TILE / TILE, B). A is scratch (B, ., .) with every
// index in range: A(i, kk) = A[i lda + kk] (A_KMAJOR) or A[kk lda + i].
// Bm (B, krows, bcols), leading dimension ldb: rows past krows and columns
// past bcols (a multiple of 4) load as zeros.
template <class SRC, bool A_KMAJOR, int NF>
__global__ void __launch_bounds__(NT, 1) gemm_kernel(
    const float* __restrict__ A, int lda, size_t a_batch,
    const float* __restrict__ Bm, int ldb, size_t b_batch, int krows,
    int bcols, float* __restrict__ out, int ldo, size_t o_batch, int rows,
    int cols, int K) {
  using R = Ring<A_KMAJOR, false, NF>;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z, i0 = blockIdx.y * TILE, j0 = blockIdx.x * R::BN;
  A += b * a_batch;
  Bm += b * b_batch;
  out += b * o_batch;

  float acc[4][NF][4];
  zero(acc);
  mainloop<A_KMAJOR, false, NF, true>(
      acc, smem, K / BK, [&](float* sA, float* sB, int k0) {
        if (A_KMAJOR)
          load_kmajor<TILE>(sA, A, lda, i0, i0 + TILE, k0, K);
        else
          load_kmn<TILE>(sA, A, lda, k0, K, i0, i0 + TILE);
        load_kmn<R::BN>(sB, Bm, ldb, k0, krows, j0, bcols);
      });

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = i0 + 64 * (warp >> 2), c0 = j0 + 8 * NF * (warp & 3);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // an M-major A's fragment rows g and g + 8 are tile rows 2 g, 2 g + 1
      const int i = r0 + 16 * mi + (A_KMAJOR ? g + 8 * h : 2 * g + h);
      if (i >= rows) continue;
#pragma unroll
      for (int ni = 0; ni < NF; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = c0 + 8 * ni + 2 * t + e;
          if (j < cols) out[(size_t)i * ldo + j] = acc[mi][ni][2 * h + e];
        }
    }
}

// Launches the GEMM out = A B (see gemm_kernel) on `s` after
// opting into its shared memory; returns the first cudaError_t that is not
// success. A is K-major (A_KMAJOR) or M-major scratch (B, ., .); rows is
// the output's row count, padded to TILE for the grid.
template <class SRC, bool A_KMAJOR, int NF>
int gemm(const float* A, int lda, size_t a_batch, const float* Bm, int ldb,
         size_t b_batch, int krows, int bcols, float* out, int ldo,
         size_t o_batch, int rows, int cols, int K, int B, cudaStream_t s) {
  using R = Ring<A_KMAJOR, false, NF>;
  const auto kernel = gemm_kernel<SRC, A_KMAJOR, NF>;
  int e = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::BYTES));
  if (e) return e;
  kernel<<<dim3((cols + R::BN - 1) / R::BN, (rows + TILE - 1) / TILE, B), NT,
           R::BYTES, s>>>(A, lda, a_batch, Bm, ldb, b_batch, krows, bcols,
                          out, ldo, o_batch, rows, cols, K);
  return static_cast<int>(cudaGetLastError());
}

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <class Fn>
int set_smem(Fn kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace tc
