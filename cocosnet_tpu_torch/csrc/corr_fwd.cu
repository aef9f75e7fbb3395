// Fused correlation, softmax and warp of dense descriptors (forward), f32
// in and out, on the tensor cores, at both widths the port runs it: C =
// 256, D = 154 (match_kernel 1, ops/corr.attend_corr) and C = 2304, D = 3
// (the 3x3-unfold descriptors, ops/corr_bigc.attend_corr_bigc).
//
// Replaces: cocosnet_tpu/ops/pallas_corr.py `_fwd` / `_fwd_kernel` and
// cocosnet_tpu/ops/pallas_corr_bigc.py `_fwd` / `_fwd_kernel`, which
// multiply on the TPU's matrix unit in bf16x3 and bf16x4.
//
// Computes o = softmax(q k^T / tau) v and lse = logsumexp(q k^T / tau) per
// query row, for q (N, C), k (M, C), v (M, D) per sample, without the N x M
// logits in device memory.
//
// Bound on the H100: operations. 2 B N M (C + D) flops (82.5 GFLOP at the
// match_kernel 1 flagship B = 6, N = M = 4096, C = 256, D = 154; 464.5
// GFLOP at C = 2304, D = 3) against O(B (N + M) (C + D)) bytes. tau = 0.01
// amplifies logit error 100x, so no product runs in one TF32 or bf16 pass;
// the cheapest split that holds the tolerance is bf16x3 (three passes at
// 989 TFLOP/s: 0.250 and 1.409 ms). This kernel issues 3xTF32 (three
// passes at 495 TFLOP/s: 0.500 and 2.815 ms; see tc_split.cuh).
//
// Design: a flash forward. One block per (sample, query tile, chunk of D);
// its warps (8, or 6 where D <= 8: see warps()), each owning 16 query rows
// across a whole 64-key tile, walk the key tiles with an online softmax:
//   S = q k^T  on mma.sync in 3xTF32, each 32-channel stage summed into a
//              zeroed partial and added in f32 (the tensor cores round
//              each mma's sum toward zero);
//   the row max and sum in registers: a row's 64 logits lie in the four
//              lanes of one quad, so a max is two shuffles, and each lane
//              keeps its own part of the sum (rescaled by the same alpha)
//              until the end;
//   o += P v   on the tensor cores too, in 3xTF32, P straight from the
//              registers of S: the accumulator's element (g, 2 t + e) is
//              the A operand's contraction slot t + 4 e (both operands
//              take the keys of each 8 in that order), so P never touches
//              shared memory; each group of 32 value columns sums the
//              tile's 64 keys into a zeroed partial added in f32.
// The stages of all key tiles (C / 32 of k and q, then one of v) run as
// one cp.async pipeline, STAGES deep, with no bubble between tiles. Every
// warp reads all of a k or v chunk, so the block splits each chunk once
// into hi and lo planes in shared memory (v transposed to key-contiguous
// rows, so its fragments load as pairs) instead of each warp splitting
// its fragments: the split's integer work would otherwise take about as
// many issue slots as the mma. q's rows belong to one warp each and split
// in registers. q streams through the ring with k at both widths: a
// 128-query tile (135 KB at C = 256, 1.2 MB at 2304) does not fit beside
// the ring and the planes. D runs in chunks of 160 columns (of 8 and 32
// where D is that small), one per block, so the accumulators stay in
// registers (D = 154: one chunk; a D of 256 takes two blocks that each
// form S). Any N and M: keys past M take a logit of -inf, query rows past
// N load as zeros and are not written. Inputs arrive with C and D rounded
// up to a multiple of 4 (16-byte rows, zero filled); the wrapper makes the
// copy where needed.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_split.cuh"

namespace corr_fwd {

using namespace tc;

constexpr int KT = 64;         // keys per tile
constexpr int NK = KT / 8;     // their 8-key blocks
constexpr int LDP = KT + 8;    // v's split planes, K-major by key

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Warps a block, 16 queries each. Where D <= 8 two blocks fit an SM, and 6
// warps (96 queries) fill the card better than 8 (at B 6, N 4096: 258
// blocks for 264 places against 192); with wider D one block fits, and 6
// warps an SM are too few to hide the mma's latency.
constexpr int warps(int nfd) { return nfd == 1 ? 6 : 8; }

template <int NFD>
struct Layout {
  static constexpr int NTF = 32 * warps(NFD);    // threads a block
  static constexpr int QT = 16 * warps(NFD);     // queries a block
  static constexpr int DCH = 8 * NFD;             // value columns a block
  static constexpr int LDV = DCH + 4;             // a v chunk as staged
  static constexpr int K_FLOATS = KT * LDK;       // k chunk [KT][LDK]
  static constexpr int Q_FLOATS = QT * LDK;       // q chunk [QT][LDK]
  static constexpr int STAGE = cmax(K_FLOATS + Q_FLOATS, KT * LDV);
  // the split planes (hi, lo) of a k chunk or of a v chunk transposed
  static constexpr int PLANE = cmax(KT * LDK, DCH * LDP);
  static constexpr int BYTES = 4 * (STAGES * STAGE + 2 * PLANE);
};

// Grid (ceil(N / QT), B, ceil(D / DCH)). q: (B, N, Cp), k: (B, M, Cp), v:
// (B, M, Dp) with Cp, Dp multiples of 4, zero filled past C and D; o: (B,
// N, D); lse: (B, N), written by the blocks of the first D chunk. Two
// blocks an SM where D <= 8 (the value accumulators are small).
template <int NFD>
__global__ void __launch_bounds__(Layout<NFD>::NTF, NFD == 1 ? 2 : 1)
    corr_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int N, int M, int Cp, int Dp,
                    int D, float tau_inv) {
  using L = Layout<NFD>;
  constexpr int NTF = L::NTF, QT = L::QT;
  constexpr int G = NFD < 4 ? NFD : 4;  // value column blocks at once
  static_assert(NFD % G == 0, "whole groups of value columns");
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  uint32_t* hi = reinterpret_cast<uint32_t*>(smem + STAGES * L::STAGE);
  uint32_t* lo = hi + L::PLANE;

  const int n0 = blockIdx.x * QT, b = blockIdx.y, dc0 = blockIdx.z * L::DCH;
  q += (size_t)b * N * Cp;
  k += (size_t)b * M * Cp;
  v += (size_t)b * M * Dp;
  o += (size_t)b * N * D;
  lse += (size_t)b * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  const int nst = (Cp + BK - 1) / BK, per = nst + 1;
  const int total = (M + KT - 1) / KT * per;

  // the copies of pipeline step `it`: a k and a q chunk, or a v chunk
  auto issue = [&](int it) {
    const int kt = it / per, s = it - kt * per;
    float* st = ring + (it % STAGES) * L::STAGE;
    if (s < nst) {
      load_kmajor<KT, NTF>(st, k, Cp, kt * KT, M, s * BK, Cp);
      load_kmajor<QT, NTF>(st + L::K_FLOATS, q, Cp, n0, N, s * BK, Cp);
    } else {
#pragma unroll
      for (int kb = 0; kb < KT; kb += BK)
        load_kmn<L::DCH, NTF>(st + kb * L::LDV, v, Dp, kt * KT + kb, M,
                              dc0, Dp);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) issue(s);
    cp_commit();
  }

  float sacc[NK][4];   // S, then P, of rows g, g + 8 of the warp's 16
  float oacc[NFD][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nd = 0; nd < NFD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[nd][e] = 0.f;

  for (int it = 0; it < total; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // step it is in; step it - 1 is done with its slot
                      // and with the planes
    if (it + STAGES - 1 < total) issue(it + STAGES - 1);
    cp_commit();
    const int kt = it / per, s = it - kt * per;
    const float* st = ring + (it % STAGES) * L::STAGE;
    // split the chunk that every warp reads once, for all of them: k as
    // staged, v transposed to key-contiguous rows (lanes on keys: the
    // float4 reads and the stores are conflict-free)
    if (s < nst) {
      for (int e = tid; e < KT * BK / 4; e += NTF) {
        const int at = (e / (BK / 4)) * LDK + (e % (BK / 4)) * 4;
        const float4 x = *reinterpret_cast<const float4*>(st + at);
        uint4 h, w;
        split(x.x, h.x, w.x);
        split(x.y, h.y, w.y);
        split(x.z, h.z, w.z);
        split(x.w, h.w, w.w);
        *reinterpret_cast<uint4*>(hi + at) = h;
        *reinterpret_cast<uint4*>(lo + at) = w;
      }
    } else {
      for (int e = tid; e < KT * L::DCH / 4; e += NTF) {
        const int key = e % KT, c = (e / KT) * 4;
        const float4 x =
            *reinterpret_cast<const float4*>(st + key * L::LDV + c);
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split(xs[i], hi[(c + i) * LDP + key], lo[(c + i) * LDP + key]);
      }
    }
    __syncthreads();  // the planes are in

    if (s < nst) {  // S += q k^T over 32 channels
      if (s == 0)
#pragma unroll
        for (int ni = 0; ni < NK; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[ni][e] = 0.f;
      const float* sQ = st + L::K_FLOATS;
      float part[NK][4];
#pragma unroll
      for (int ni = 0; ni < NK; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[ni][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t af[2][4];
        const float* a = sQ + (r0 + g) * LDK + kk + 2 * t;
        const float2 u = *reinterpret_cast<const float2*>(a);
        const float2 w = *reinterpret_cast<const float2*>(a + 8 * LDK);
        split(u.x, af[0][0], af[1][0]);
        split(w.x, af[0][1], af[1][1]);
        split(u.y, af[0][2], af[1][2]);
        split(w.y, af[0][3], af[1][3]);
#pragma unroll
        for (int n4 = 0; n4 < NK; n4 += 4) {
          uint32_t bf[2][4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int at = (8 * (n4 + j) + g) * LDK + kk + 2 * t;
            const uint2 h = *reinterpret_cast<const uint2*>(hi + at);
            const uint2 w2 = *reinterpret_cast<const uint2*>(lo + at);
            bf[0][j][0] = h.x;
            bf[0][j][1] = h.y;
            bf[1][j][0] = w2.x;
            bf[1][j][1] = w2.y;
          }
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma(part[n4 + j], af[pass == 0], bf[pass == 1][j]);
        }
      }
#pragma unroll
      for (int ni = 0; ni < NK; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[ni][e] += part[ni][e];
      if (s == nst - 1)  // the tile's logits: online softmax, P in place
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float tmax = -INFINITY;
#pragma unroll
          for (int ni = 0; ni < NK; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool ok = kt * KT + 8 * ni + 2 * t + e < M;
              const float x = ok ? sacc[ni][2 * h + e] * tau_inv : -INFINITY;
              sacc[ni][2 * h + e] = x;
              tmax = fmaxf(tmax, x);
            }
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
          const float mnew = fmaxf(m[h], tmax);  // finite: key kt KT < M
          const float alpha = expf(m[h] - mnew);
          float sum = 0.f;
#pragma unroll
          for (int ni = 0; ni < NK; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = expf(sacc[ni][2 * h + e] - mnew);
              sacc[ni][2 * h + e] = p;
              sum += p;
            }
          l[h] = l[h] * alpha + sum;
          m[h] = mnew;
#pragma unroll
          for (int nd = 0; nd < NFD; ++nd) {
            oacc[nd][2 * h] *= alpha;
            oacc[nd][2 * h + 1] *= alpha;
          }
        }
    } else {  // o += P v over the tile's 64 keys
      // P's keys 8 ni .. 8 ni + 7 as A operands: slot t is key 2 t, slot
      // t + 4 key 2 t + 1, as in v's planes
      uint32_t pf[2][NK][4];
#pragma unroll
      for (int ni = 0; ni < NK; ++ni) {
        split(sacc[ni][0], pf[0][ni][0], pf[1][ni][0]);
        split(sacc[ni][2], pf[0][ni][1], pf[1][ni][1]);
        split(sacc[ni][1], pf[0][ni][2], pf[1][ni][2]);
        split(sacc[ni][3], pf[0][ni][3], pf[1][ni][3]);
      }
#pragma unroll
      for (int n4 = 0; n4 < NFD; n4 += G) {
        float part[G][4];
#pragma unroll
        for (int j = 0; j < G; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
        for (int kb = 0; kb < NK; ++kb) {
          uint32_t bf[2][G][2];
#pragma unroll
          for (int j = 0; j < G; ++j) {
            const int at = (8 * (n4 + j) + g) * LDP + 8 * kb + 2 * t;
            const uint2 h = *reinterpret_cast<const uint2*>(hi + at);
            const uint2 w2 = *reinterpret_cast<const uint2*>(lo + at);
            bf[0][j][0] = h.x;
            bf[0][j][1] = h.y;
            bf[1][j][0] = w2.x;
            bf[1][j][1] = w2.y;
          }
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)
#pragma unroll
            for (int j = 0; j < G; ++j)
              mma(part[j], pf[pass == 0][kb], bf[pass == 1][j]);
        }
#pragma unroll
        for (int j = 0; j < G; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) oacc[n4 + j][e] += part[j][e];
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int n = n0 + r0 + g + 8 * h;
    if (n >= N) continue;
    const float inv = 1.f / sum;
#pragma unroll
    for (int nd = 0; nd < NFD; ++nd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = dc0 + 8 * nd + 2 * t + e;
        if (c < D) o[(size_t)n * D + c] = oacc[nd][2 * h + e] * inv;
      }
    if (blockIdx.z == 0 && t == 0) lse[n] = m[h] + logf(sum);
  }
}

template <int NFD>
int run(const float* q, const float* k, const float* v, float* o, float* lse,
        int B, int N, int M, int C, int D, float tau_inv, cudaStream_t s) {
  using L = Layout<NFD>;
  const auto kernel = corr_fwd_kernel<NFD>;
  int e = set_smem(kernel, L::BYTES);
  if (e) return e;
  kernel<<<dim3((N + L::QT - 1) / L::QT, B, (D + L::DCH - 1) / L::DCH),
           L::NTF, L::BYTES, s>>>(q, k, v, o, lse, N, M, round_up(C, 4),
                                  round_up(D, 4), D, tau_inv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace corr_fwd

extern "C" int cocosnet_corr_max_d() { return 256; }

// q: (B, N, C4), k: (B, M, C4), v: (B, M, D4) with C4, D4 the multiples of
// 4 at or above C and D (zero filled), all f32, contiguous and 16-byte
// aligned; o: (B, N, D), lse: (B, N). Any N, M >= 1 and C; D <= 256 (the
// wrapper checks); B <= 65535. Launches on `stream` and returns the
// cudaError_t of the launch.
extern "C" int cocosnet_corr_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int N, int M,
                                 int C, int D, float tau_inv, void* stream) {
  const float* Q = static_cast<const float*>(q);
  const float* K = static_cast<const float*>(k);
  const float* V = static_cast<const float*>(v);
  float* O = static_cast<float*>(o);
  float* L = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 8) return corr_fwd::run<1>(Q, K, V, O, L, B, N, M, C, D, tau_inv, s);
  if (D <= 32)
    return corr_fwd::run<4>(Q, K, V, O, L, B, N, M, C, D, tau_inv, s);
  return corr_fwd::run<20>(Q, K, V, O, L, B, N, M, C, D, tau_inv, s);
}
