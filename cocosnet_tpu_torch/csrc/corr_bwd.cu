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
// The tensor-core pieces (the 3xTF32 split, the m16n8k8 mma, the cp.async
// ring, the stage-flushed mainloop and the tiled GEMM of launches 2-4)
// are in tc_split.cuh, shared with corr_fwd.cu and shift9_bwd.cu. No
// atomics: every output element is summed by one thread in one order,
// so two launches give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_split.cuh"

namespace corr_bwd {

using namespace tc;

struct Src {};  // names this source's GEMM instances

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
  const int Cp = round_up(C, 4), Dp = round_up(D, 4);
  const int Np = round_up(N, TILE), Mp = round_up(M, TILE);
  const size_t nm = (size_t)Np * Mp;
  int e;
  if ((e = set_smem(corr_bwd_scores_kernel, RS::BYTES))) return e;
  corr_bwd_scores_kernel<<<dim3(Mp / TILE, Np / TILE, B), NT, RS::BYTES, s>>>(
      q, k, go, v, lse, dd, p, ds, N, M, Cp, Dp, Np, Mp, tau_inv);
  if ((e = static_cast<int>(cudaGetLastError()))) return e;
  if ((e = gemm<Src, true, 4>(ds, Mp, nm, k, Cp, (size_t)M * Cp, M, Cp, dq,
                              C, (size_t)N * C, N, C, Mp, B, s)))
    return e;
  if ((e = gemm<Src, false, 4>(ds, Mp, nm, q, Cp, (size_t)N * Cp, N, Cp, dk,
                               C, (size_t)M * C, M, C, Np, B, s)))
    return e;
  return gemm<Src, false, NF_V>(p, Mp, nm, go, Dp, (size_t)N * Dp, N, Dp, dv,
                                D, (size_t)M * D, M, D, Np, B, s);
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
