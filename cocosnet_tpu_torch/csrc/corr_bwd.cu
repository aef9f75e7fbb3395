// Backward of the fused correlation, softmax and warp (o = softmax(q k^T /
// tau) v), f32 in and out, on the tensor cores, at both widths the port
// runs it: dense match_kernel 1 descriptors (C = 256, D = 154,
// ops/corr.attend_corr) and the 3x3-unfold descriptors of match_kernel 3
// (C = 2304, D = 3, ops/corr_bigc.attend_corr_bigc).
//
// Replaces: cocosnet_tpu/ops/pallas_corr.py `_bwd_impl` and
// cocosnet_tpu/ops/pallas_corr_bigc.py `_bwd_impl`, each two kernels
// (`_dq_kernel` on the query side, `_dkv_kernel` on the key side) that
// multiply on the TPU's matrix unit in bf16x3 (`pallas_corr._dot`) or
// bf16x4 (`pallas_corr_bigc._dot_split`).
//
// With P = exp(q k^T / tau - lse) from the forward's saved lse, dP =
// gO v^T, dd = rowsum(gO * O) and dS = P (dP - dd), the outputs are
//   dq = dS k / tau,  dk = dS^T q / tau,  dv = P^T gO.
//
// Bound on the H100: operations. The function needs S and dP once each,
// then dq, dk and dv: 2 B N M (3 C + 2 D) flops, against O(B (N + M)
// (C + D)) bytes: 288.8 GFLOP at the match_kernel 1 training shape (B = 8,
// N = M = 4096, C = 256, D = 154) and 1.393 TFLOP at bench_corr's (B = 6,
// N = M = 4096, C = 2304, D = 3). The cheapest split that holds the
// tolerance at tau = 0.01 is bf16x3 (tests/test_torch_corr_split.py: one
// TF32 pass does not), three passes at 989 TFLOP/s of bf16: 0.876 and
// 4.225 ms. This kernel issues 3xTF32, three passes at 495 TFLOP/s: 1.750
// and 8.441 ms, twice that (f32 FMA at 67 TFLOP/s, the design before the
// tensor cores: 4.311 and 20.788 ms). The tiles pad D to 32-wide chunks
// in the scores and to dv's tile width: 300.6 GFLOP and 1.404 TFLOP
// issued per pass.
//
// What the design does about the bound: S and dS are formed once, not
// twice as in a flash backward's two passes (which recompute S on the key
// side, 398.9 GFLOP and 1.857 TFLOP). A scores kernel writes P and
// dS / tau to scratch that the wrapper allocates (2 x B Np Mp x 4 bytes:
// 1.07 GB and 805 MB at those shapes; 2.7 and 2 GB of scratch traffic,
// 0.8 and 0.6 ms at 3.35 TB/s), then three tiled GEMMs form dq, dk and dv
// from it. At C = 2304 this also avoids holding owner rows of 2304 floats,
// which do not fit a block's shared memory: dq and dk run over 128-column
// tiles of C, the 18 tiles sharing a dS panel side by side, so it is read
// from L2. dv takes tiles of 96 columns (NF_V = 3; one of 160 would need
// more registers than a thread has once the partial sums are kept) where
// D > 32, else of 32 (NF_V = 1). Padding: v and gO arrive with D rounded
// up to a multiple of 4 (16-byte rows) in a zero-filled copy that the
// wrapper makes (154 -> 156, 3 -> 4); C likewise (256 and 2304 need none);
// the kernels zero-fill the rest of each 32-wide chunk and every row past
// N and M, so P = dS = 0 there.
//
// The four launches:
//   1. scores: per 128 x 128 tile of (query n, key m), S = q k^T over C and
//      dP = gO v^T over D, then P = exp(S / tau - lse) and
//      dS = P (dP - dd) / tau, written to scratch (B, Np, Mp) f32 (N and M
//      rounded up to 128; rows and columns past N and M hold zeros);
//   2. dq = dS k       (dS read K-major: its rows);
//   3. dk = dS^T q     (dS read M-major: its columns, C contiguous);
//   4. dv = P^T gO     (the same, D wide).
// Launches 2-4 are one tiled GEMM, out = A B over a padded contraction, A
// K-major or M-major, B always with its output columns contiguous.
//
// 3xTF32: each operand x splits into hi = tf32(x) and lo = tf32(x - hi)
// (round to nearest, ties away), and every product a b is issued as
// a_lo b_hi + a_hi b_lo + a_hi b_hi into an f32 accumulator: about 22 bits
// of each operand, where a single TF32 pass keeps 11 and tau = 0.01 would
// amplify that 100x in the logits. The split happens on the fragments, in
// registers, as they leave shared memory (tests/test_torch_corr_split.py
// emulates it on the CPU).
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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace corr_bwd {

constexpr int TILE = 128;     // rows of every tile; N and M pad to it
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
// rows row0.., contraction k0..; rows past nrows and columns past K (a
// multiple of 4) load as zeros. Staged [ROWS][LDK].
template <int ROWS>
__device__ __forceinline__ void load_kmajor(float* s, const float* g, int ld,
                                            int row0, int nrows, int k0,
                                            int K) {
  constexpr int CPR = BK / 4, CH = ROWS * CPR;
  static_assert(CH % NT == 0, "whole rounds of 16-byte chunks");
#pragma unroll
  for (int i = 0; i < CH / NT; ++i) {
    const int e = threadIdx.x + NT * i;
    const int r = e / CPR, c = (e % CPR) * 4;
    const bool ok = row0 + r < nrows && k0 + c < K;
    cp16(s + r * LDK + c, ok ? g + (size_t)(row0 + r) * ld + k0 + c : g, ok);
  }
}

// BK x COLS of a row-major (K, cols) matrix g (leading dimension ld), rows
// (the contraction) k0.., columns col0..; rows past krows and columns past
// ncols (a multiple of 4) load as zeros. Staged [BK][COLS + 4].
template <int COLS>
__device__ __forceinline__ void load_kmn(float* s, const float* g, int ld,
                                         int k0, int krows, int col0,
                                         int ncols) {
  constexpr int CPR = COLS / 4, CH = BK * CPR;
  static_assert(CH % NT == 0, "whole rounds of 16-byte chunks");
#pragma unroll
  for (int i = 0; i < CH / NT; ++i) {
    const int e = threadIdx.x + NT * i;
    const int r = e / CPR, c = (e % CPR) * 4;
    const bool ok = k0 + r < krows && col0 + c < ncols;
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
// copies. Every thread of the block calls it. The tensor cores round each
// mma's sum toward zero (products exact, no round to nearest), so a long
// chain of mma into one accumulator drifts by up to an ulp per step: with
// FLUSH, each stage's 12 mma per element go into a zeroed partial that is
// added to acc in f32 (round to nearest), which keeps every chain 12 long.
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

// Launch 1. Grid (Mp / TILE, Np / TILE, B). q, k: (B, N | M, Cp), gO, v:
// (B, N | M, Dp), rows 16-byte aligned (Cp, Dp multiples of 4, zero
// filled past C and D); lse, dd: (B, N); p, ds: (B, Np, Mp).
__global__ void __launch_bounds__(NT, 1) corr_bwd_scores_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ go, const float* __restrict__ v,
    const float* __restrict__ lse, const float* __restrict__ dd,
    float* __restrict__ p, float* __restrict__ ds, int N, int M, int Cp,
    int Dp, int Np, int Mp, float tau_inv) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z, n0 = blockIdx.y * TILE, m0 = blockIdx.x * TILE;
  q += (size_t)b * N * Cp;
  k += (size_t)b * M * Cp;
  go += (size_t)b * N * Dp;
  v += (size_t)b * M * Dp;
  lse += (size_t)b * N;
  dd += (size_t)b * N;
  const size_t off = (size_t)b * Np * Mp;
  p += off;
  ds += off;

  float acc[4][4][4], dp[4][4][4];
  zero(acc);
  mainloop<true, true, 4, true>(acc, smem, (Cp + BK - 1) / BK,
                          [&](float* sA, float* sB, int k0) {
                            load_kmajor<TILE>(sA, q, Cp, n0, N, k0, Cp);
                            load_kmajor<TILE>(sB, k, Cp, m0, M, k0, Cp);
                          });
  zero(dp);
  // D is short (a chain of 12 ceil(D / 32) mma): no partials, which keeps
  // the registers of S and dP both live
  mainloop<true, true, 4, false>(dp, smem, (Dp + BK - 1) / BK,
                          [&](float* sA, float* sB, int k0) {
                            load_kmajor<TILE>(sA, go, Dp, n0, N, k0, Dp);
                            load_kmajor<TILE>(sB, v, Dp, m0, M, k0, Dp);
                          });

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = n0 + 64 * (warp >> 2), c0 = m0 + 32 * (warp & 3);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = r0 + 16 * mi + g + 8 * h;
      const bool rok = n < N;
      const float l = rok ? lse[n] : 0.f, d = rok ? dd[n] : 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int m = c0 + 8 * ni + 2 * t;
        float pv[2], sv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = rok && m + e < M;
          pv[e] = ok ? expf(fmaf(acc[mi][ni][2 * h + e], tau_inv, -l)) : 0.f;
          sv[e] = pv[e] * (dp[mi][ni][2 * h + e] - d) * tau_inv;
        }
        const size_t at = (size_t)n * Mp + m;
        *reinterpret_cast<float2*>(p + at) = make_float2(pv[0], pv[1]);
        *reinterpret_cast<float2*>(ds + at) = make_float2(sv[0], sv[1]);
      }
    }
}

// Launches 2-4: out[b][i][j] = sum_kk A(b, i, kk) Bm[b][kk][j] over the
// padded contraction K (a multiple of BK) for i < rows, j < cols. Grid
// (ceil(cols / BN), rows padded to TILE / TILE, B). A is scratch (B, ., .)
// with every index in range: A(i, kk) = A[i lda + kk] (A_KMAJOR) or
// A[kk lda + i]. Bm (B, krows, bcols), leading dimension ldb: rows past
// krows and columns past bcols (a multiple of 4) load as zeros.
template <bool A_KMAJOR, int NF>
__global__ void __launch_bounds__(NT, 1) corr_bwd_gemm_kernel(
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

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <class Fn>
int set_smem(Fn kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// The four launches on `stream`: scores, then dq (gemm<true, 4>), dk
// (gemm<false, 4>) and dv (gemm<false, NF_V>). q, k: (B, N | M,
// round_up(C, 4)) and v, gO: (B, M | N, round_up(D, 4)), zero filled past
// C and D; p, ds: scratch (B, Np, Mp); dq, dk, dv: (B, N | M, C | D).
// Returns the first cudaError_t that is not success.
template <int NF_V>
int backward(const float* q, const float* k, const float* v,
             const float* go, const float* lse, const float* dd, float* dq,
             float* dk, float* dv, float* p, float* ds, int B, int N, int M,
             int C, int D, float tau_inv, cudaStream_t s) {
  using RS = Ring<true, true, 4>;
  using RQ = Ring<true, false, 4>;
  using RT = Ring<false, false, 4>;
  using RV = Ring<false, false, NF_V>;
  const int Cp = round_up(C, 4), Dp = round_up(D, 4);
  const int Np = round_up(N, TILE), Mp = round_up(M, TILE);
  const size_t nm = (size_t)Np * Mp;
  int e;
  const auto dq_k = corr_bwd_gemm_kernel<true, 4>;
  const auto dk_k = corr_bwd_gemm_kernel<false, 4>;
  const auto dv_k = corr_bwd_gemm_kernel<false, NF_V>;
  if ((e = set_smem(corr_bwd_scores_kernel, RS::BYTES))
      || (e = set_smem(dq_k, RQ::BYTES)) || (e = set_smem(dk_k, RT::BYTES))
      || (e = set_smem(dv_k, RV::BYTES)))
    return e;
  corr_bwd_scores_kernel<<<dim3(Mp / TILE, Np / TILE, B), NT, RS::BYTES, s>>>(
      q, k, go, v, lse, dd, p, ds, N, M, Cp, Dp, Np, Mp, tau_inv);
  if ((e = static_cast<int>(cudaGetLastError()))) return e;
  dq_k<<<dim3((C + RQ::BN - 1) / RQ::BN, Np / TILE, B), NT, RQ::BYTES, s>>>(
      ds, Mp, nm, k, Cp, (size_t)M * Cp, M, Cp, dq, C, (size_t)N * C, N, C,
      Mp);
  if ((e = static_cast<int>(cudaGetLastError()))) return e;
  dk_k<<<dim3((C + RT::BN - 1) / RT::BN, Mp / TILE, B), NT, RT::BYTES, s>>>(
      ds, Mp, nm, q, Cp, (size_t)N * Cp, N, Cp, dk, C, (size_t)M * C, M, C,
      Np);
  if ((e = static_cast<int>(cudaGetLastError()))) return e;
  dv_k<<<dim3((D + RV::BN - 1) / RV::BN, Mp / TILE, B), NT, RV::BYTES, s>>>(
      p, Mp, nm, go, Dp, (size_t)N * Dp, N, Dp, dv, D, (size_t)M * D, M, D,
      Np);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace corr_bwd

// Rows of a tile: the wrapper pads the scratch's N and M to it.
extern "C" int cocosnet_corr_bwd_tile() { return corr_bwd::TILE; }

// q: (B, N, C4), k: (B, M, C4), v: (B, M, D4), go: (B, N, D4) with C4, D4
// the multiples of 4 at or above C and D (zero filled), lse, dd: (B, N);
// p, ds: scratch (B, Np, Mp) with Np, Mp the multiples of the tile at or
// above N and M. Outputs dq: (B, N, C), dk: (B, M, C), dv: (B, M, D). All
// f32, contiguous, 16-byte aligned; any N, M >= 1, B <= 65535. Four
// launches on `stream`, dv's tiles 32 columns wide where D <= 32, else 96;
// returns the first cudaError_t that is not success.
extern "C" int cocosnet_corr_bwd(const void* q, const void* k, const void* v,
                                 const void* go, const void* lse,
                                 const void* dd, void* dq, void* dk, void* dv,
                                 void* p, void* ds, int B, int N, int M, int C,
                                 int D, float tau_inv, void* stream) {
  using Fn = decltype(&corr_bwd::backward<1>);
  const Fn run = D <= 32 ? &corr_bwd::backward<1> : &corr_bwd::backward<3>;
  return run(static_cast<const float*>(q), static_cast<const float*>(k),
             static_cast<const float*>(v), static_cast<const float*>(go),
             static_cast<const float*>(lse), static_cast<const float*>(dd),
             static_cast<float*>(dq), static_cast<float*>(dk),
             static_cast<float*>(dv), static_cast<float*>(p),
             static_cast<float*>(ds), B, N, M, C, D, tau_inv,
             static_cast<cudaStream_t>(stream));
}
