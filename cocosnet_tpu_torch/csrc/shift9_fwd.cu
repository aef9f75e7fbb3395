// Fused 3x3-unfold correlation, softmax and warp (forward), f32 in and out,
// on the tensor cores.
//
// Replaces: cocosnet_tpu/ops/pallas_shift9.py `_fwd` / `_fwd_kernel`, the
// forward of `attend_shift9`, which multiplies on the TPU's matrix unit in
// bf16x3 (`_dot_split`, `_dot3`).
//
// Computes o = softmax(logits) @ V and lse = logsumexp(logits) per query,
// with logits the centered, L2-normalized 3x3-unfold descriptor correlation
// over temperature, built without the 2304-dim descriptors or the N x N
// matrix in device memory:
//   S3   = F3 G3^T over 3C (the dy taps already folded into channels),
//   raw  = S3 + m+ S3(i+1, j+1) + m- S3(i-1, j-1) (the dx taps; m+/m- zero
//          the shift at the last/first image column, the unfold's padding),
//   logit = (raw - qmul kmul + qadd + kadd + cadd) qs ks (centering and norm
//          as rank-1 terms, 1/tau folded into qs).
//
// Bound on the H100: operations. 2 B Nq Nk (3C + D) flops (185.6 GFLOP at
// the flagship B = 6, Nq = Nk = 4096, 3C = 768, D = 154) against
// O(B (Nq + Nk) (3C + D)) bytes. tau = 0.01 amplifies logit error 100x, so no product runs in one
// TF32 or bf16 pass; the cheapest split that holds the tolerance is bf16x3
// (three passes at 989 TFLOP/s: 0.563 ms). This kernel issues 3xTF32 (three
// passes at 495 TFLOP/s: 1.125 ms; see tc_split.cuh).
//
// Design: corr_fwd.cu's flash forward on regions with a one-position halo.
// A block owns 126 queries; each of its 8 warps holds 16 rows of the
// 128-row query region (the owned queries and one position each side), and
// together they walk key regions of 64 columns, each owning 62 keys, with
// an online softmax:
//   S3 on mma.sync in 3xTF32, each 32-channel stage summed into a zeroed
//      partial and added in f32, every element's mma in the order of
//      tc_split.cuh's mainloop, so that S3 has the bits that shift9_bwd.cu's
//      scores kernel gives it;
//   the region's S3 goes to shared memory, where the diagonal neighbours
//      of every owned position lie at any image width W: positions are
//      flattened row-major, a neighbour past the end of an image row is
//      exactly the one the column mask zeroes, and positions outside [0,
//      Nq) (queries) or [0, Nk) (keys) load as zeros and are never owned.
//      The logits are formed in registers with the f32 operations of
//      `_logits` in its order, unfused, as the backward's scores epilogue
//      forms them: the backward recomputes P from this kernel's lse and the
//      same logits;
//   the row max and sum in registers, and o += P V on the tensor cores in
//      3xTF32, P straight from the registers of S3 and v split once per
//      block into hi/lo planes (both as in corr_fwd.cu).
// G3 streams through the cp.async ring with F3's rows; the block splits
// each G3 chunk once into hi/lo planes, which then hold the S3 region
// until v's split. Waves: one block fits an SM, and 126-query tiles make
// 33 x 6 = 198 blocks at B 6, N 4096, 1.5 waves of 132 SMs. So the key
// regions are cut into parts, each part a block of its own (the wrapper
// picks the count that fills whole waves: two at B 6, 396 blocks, three
// waves; one at B 8, 264 blocks, two). Each part writes its unnormalized o
// and its row max and sum; a second launch combines the parts in order and
// writes o and lse. No atomics: two launches give the same bits. F3, G3
// and v arrive with 3C and D rounded up to a multiple of 4 (16-byte rows,
// zero filled); the wrapper makes the copy where needed. The query and the
// key counts may differ (Nq rows of F3, Nk of G3 and v, both whole image
// rows): the spatial-parallel correlation (ops/corr_sp.py) runs one query
// shard against every key, as pallas_shift9._fwd takes nq != nk. Each side's
// flags, halo and bounds read its own count; a shard's edge rows need
// nothing beyond F3, whose row stack already holds their dy neighbours, and
// their dx neighbours past the shard are the ones the column mask zeroes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_split.cuh"

namespace shift9_fwd {

using namespace tc;

constexpr int NTF = 256;           // 8 warps
constexpr int QR = 16 * NTF / 32;  // query region rows, 16 a warp
constexpr int QOWN = QR - 2;       // queries a block owns
constexpr int KR = 64;             // key region columns
constexpr int KOWN = KR - 2;       // keys a region owns
constexpr int NK = KR / 8;         // its 8-key blocks
constexpr int LDP = KR + 8;        // v's split planes, K-major by key
constexpr int LDR = KR + 8;        // the S3 region's rows
constexpr int VALID = 1, PLUS = 2, MINUS = 4;  // per-position flags

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// value columns a block: 8, 32 or 160 (D = 154: one chunk)
constexpr int nfd_of(int d) { return d <= 8 ? 1 : d <= 32 ? 4 : 20; }

template <int NFD>
struct Layout {
  static constexpr int DCH = 8 * NFD;             // value columns a block
  static constexpr int LDV = DCH + 4;             // a v chunk as staged
  static constexpr int K_FLOATS = KR * LDK;       // G3 chunk [KR][LDK]
  static constexpr int Q_FLOATS = QR * LDK;       // F3 chunk [QR][LDK]
  static constexpr int STAGE = cmax(K_FLOATS + Q_FLOATS, KR * LDV);
  // the split planes (hi, lo) of a G3 chunk or of a v chunk transposed;
  // between the two the hi plane holds the S3 region [QR][LDR]
  static constexpr int PLANE = cmax(cmax(KR * LDK, DCH * LDP), QR * LDR);
  // then the rows' terms (qs, qmul, qadd, cadd), the columns' (ks, kmul,
  // kadd), and the flags of both
  static constexpr int TERMS = STAGES * STAGE + 2 * PLANE;
  static constexpr int BYTES = 4 * (TERMS + 4 * QR + 3 * KR + QR + KR);
};

__device__ __forceinline__ int flags(int pos, int N, int W) {
  const int col = ((pos % W) + W) % W;
  return (pos >= 0 && pos < N ? VALID : 0) | (col != W - 1 ? PLUS : 0) |
         (col != 0 ? MINUS : 0);
}

// Grid (ceil(Nq / QOWN), B, parts x nd). Block (x, b, z) owns queries
// [QOWN x, QOWN x + QOWN), the key regions [per p, per p + per) of the
// ceil(Nk / KOWN) that cover Nk (p = z / nd) and the value columns (z % nd)
// DCH .. f3: (B, Nq, C3p), g3: (B, Nk, C3p), v: (B, Nk, Dp) with C3p, Dp
// multiples of 4, zero filled past 3C and D; qv: (B, Nq, 4); kv: (B, 4,
// Nk). opart: (parts, B, Nq, D), each part's o before the division by its
// row sum; ml: (parts, B, Nq, 2), its row max and sum, written by the
// blocks of the first D chunk.
template <int NFD>
__global__ void __launch_bounds__(NTF, 1) shift9_fwd_kernel(
    const float* __restrict__ f3, const float* __restrict__ g3,
    const float* __restrict__ v, const float* __restrict__ qv,
    const float* __restrict__ kv, float* __restrict__ opart,
    float* __restrict__ ml, int B, int Nq, int Nk, int C3p, int Dp, int D,
    int W, int nd, int per) {
  using L = Layout<NFD>;
  constexpr int G = NFD < 4 ? NFD : 4;  // value column blocks at once
  static_assert(NFD % G == 0, "whole groups of value columns");
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  uint32_t* hi = reinterpret_cast<uint32_t*>(smem + STAGES * L::STAGE);
  uint32_t* lo = hi + L::PLANE;
  float* region = smem + STAGES * L::STAGE;  // [QR][LDR], in the hi plane
  float* rq = smem + L::TERMS;               // [4][QR]
  float* ck = rq + 4 * QR;                   // [3][KR]
  int* rf = reinterpret_cast<int*>(ck + 3 * KR);  // [QR]
  int* cf = rf + QR;                              // [KR]

  const int b = blockIdx.y, kpart = blockIdx.z / nd;
  const int dc0 = (blockIdx.z % nd) * L::DCH;
  const int ia = blockIdx.x * QOWN - 1;  // position of region row 0
  const int kt0 = kpart * per;
  const int kt1 = min((Nk + KOWN - 1) / KOWN, kt0 + per);
  f3 += (size_t)b * Nq * C3p;
  g3 += (size_t)b * Nk * C3p;
  v += (size_t)b * Nk * Dp;
  qv += (size_t)b * Nq * 4;
  kv += (size_t)b * 4 * Nk;
  const size_t orow = ((size_t)kpart * B + b) * Nq;  // this part's (b, 0)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  const int nst = (C3p + BK - 1) / BK, steps = nst + 1;
  const int total = kt1 > kt0 ? (kt1 - kt0) * steps : 0;

  // the region rows' terms; the halo rows and rows past Nq are not owned
  // (no VALID flag): their terms are zero and they are never written
  if (tid < QR) {
    const int pos = ia + tid;
    int f = flags(pos, Nq, W);
    if (tid == 0 || tid == QR - 1) f &= ~VALID;
    const bool ok = f & VALID;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      rq[i * QR + tid] = ok ? qv[(size_t)pos * 4 + i] : 0.f;
    rf[tid] = f;
  }

  // the copies of pipeline step `it`: a G3 and an F3 chunk, or a v chunk
  auto issue = [&](int it) {
    const int kt = kt0 + it / steps, s = it % steps;
    const int ja = kt * KOWN - 1;  // position of region column 0
    float* st = ring + (it % STAGES) * L::STAGE;
    if (s < nst) {
      load_kmajor<KR, NTF>(st, g3, C3p, ja, Nk, s * BK, C3p);
      load_kmajor<QR, NTF>(st + L::K_FLOATS, f3, C3p, ia, Nq, s * BK, C3p);
    } else {
#pragma unroll
      for (int kb = 0; kb < KR; kb += BK)
        load_kmn<L::DCH, NTF>(st + kb * L::LDV, v, Dp, ja + kb, Nk, dc0,
                              Dp);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) issue(s);
    cp_commit();
  }

  float sacc[NK][4];   // S3, then the logits, then P, of rows g, g + 8
  float oacc[NFD][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nd2 = 0; nd2 < NFD; ++nd2)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[nd2][e] = 0.f;

  for (int it = 0; it < total; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // step it is in; step it - 1 is done with its slot,
                      // the planes and the region's terms
    if (it + STAGES - 1 < total) issue(it + STAGES - 1);
    cp_commit();
    const int kt = kt0 + it / steps, s = it % steps;
    const float* st = ring + (it % STAGES) * L::STAGE;
    // split the chunk that every warp reads once, for all of them: G3 as
    // staged, v transposed to key-contiguous rows
    if (s < nst) {
      for (int e = tid; e < KR * BK / 4; e += NTF) {
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
      for (int e = tid; e < KR * L::DCH / 4; e += NTF) {
        const int key = e % KR, c = (e / KR) * 4;
        const float4 x =
            *reinterpret_cast<const float4*>(st + key * L::LDV + c);
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split(xs[i], hi[(c + i) * LDP + key], lo[(c + i) * LDP + key]);
      }
    }
    if (s == 0 && tid < KR) {  // the key region's terms and flags
      const int pos = kt * KOWN - 1 + tid;
      int f = flags(pos, Nk, W);
      if (tid == 0 || tid == KR - 1) f &= ~VALID;
      const bool ok = f & VALID;
      ck[tid] = ok ? kv[pos] : 0.f;
      ck[KR + tid] = ok ? kv[Nk + pos] : 0.f;
      ck[2 * KR + tid] = ok ? kv[2 * Nk + pos] : 0.f;
      cf[tid] = f;
    }
    __syncthreads();  // the planes are in

    if (s < nst) {  // S3 += F3 G3^T over 32 channels
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
          // a_lo b_hi, a_hi b_lo, a_hi b_hi, as mainloop issues them
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
      if (s == nst - 1) {  // the region's logits: online softmax, P in place
        __syncthreads();   // every warp is done with the G3 chunk's planes
#pragma unroll
        for (int ni = 0; ni < NK; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(region + (r0 + g + 8 * h) * LDR +
                                       8 * ni + 2 * t) =
                make_float2(sacc[ni][2 * h], sacc[ni][2 * h + 1]);
        __syncthreads();  // the region is in
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + g + 8 * h;
          const int rfl = rf[row];
          const float qs = rq[row], qmul = rq[QR + row];
          const float qadd = rq[2 * QR + row], cadd = rq[3 * QR + row];
          float tmax = -INFINITY;
#pragma unroll
          for (int ni = 0; ni < NK; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * ni + 2 * t + e;
              const int cfl = cf[col];
              // keys not owned or past Nk take no probability; rows not
              // owned take a finite logit and are never written
              float lg = cfl & VALID ? 0.f : -INFINITY;
              if ((rfl & cfl) & VALID) {
                // the operations and roundings of `_logits`, in its
                // order, none fused (shift9_bwd.cu's scores epilogue)
                const int both = rfl & cfl;
                const float plus =
                    both & PLUS ? region[(row + 1) * LDR + col + 1] : 0.f;
                const float minus =
                    both & MINUS ? region[(row - 1) * LDR + col - 1] : 0.f;
                const float raw =
                    __fadd_rn(__fadd_rn(sacc[ni][2 * h + e], plus), minus);
                lg = __fsub_rn(raw, __fmul_rn(qmul, ck[KR + col]));
                lg = __fadd_rn(__fadd_rn(__fadd_rn(lg, qadd),
                                         ck[2 * KR + col]),
                               cadd);
                lg = __fmul_rn(__fmul_rn(lg, qs), ck[col]);
              }
              sacc[ni][2 * h + e] = lg;
              tmax = fmaxf(tmax, lg);
            }
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
          // finite: every key region owns a key below Nk
          const float mnew = fmaxf(m[h], tmax);
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
          for (int nd2 = 0; nd2 < NFD; ++nd2) {
            oacc[nd2][2 * h] *= alpha;
            oacc[nd2][2 * h + 1] *= alpha;
          }
        }
      }
    } else {  // o += P v over the region's 64 keys
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
    const int row = r0 + g + 8 * h;
    if (!(rf[row] & VALID)) continue;
    const size_t n = orow + (ia + row);
#pragma unroll
    for (int nd2 = 0; nd2 < NFD; ++nd2)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = dc0 + 8 * nd2 + 2 * t + e;
        if (c < D) opart[n * D + c] = oacc[nd2][2 * h + e];
      }
    if (dc0 == 0 && t == 0) {
      ml[2 * n] = m[h];
      ml[2 * n + 1] = sum;
    }
  }
}

// Launch 2. One thread per (b, n, d) of the rows = B Nq rows: the parts'
// row maxima and sums, and o, combined in the parts' order; lse from the
// threads of d = 0.
__global__ void shift9_fwd_combine_kernel(const float* __restrict__ opart,
                                          const float* __restrict__ ml,
                                          float* __restrict__ o,
                                          float* __restrict__ lse,
                                          size_t rows, int D, int parts) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * D) return;
  const size_t r = idx / D;
  const int c = static_cast<int>(idx % D);
  float mx = -INFINITY;
  for (int p = 0; p < parts; ++p) mx = fmaxf(mx, ml[2 * (p * rows + r)]);
  float sum = 0.f, acc = 0.f;
  for (int p = 0; p < parts; ++p) {
    const size_t at = p * rows + r;
    const float w = expf(ml[2 * at] - mx);
    sum += ml[2 * at + 1] * w;
    acc += opart[at * D + c] * w;
  }
  o[idx] = acc / sum;
  if (c == 0) lse[r] = mx + logf(sum);
}

template <int NFD>
int run(const float* f3, const float* g3, const float* v, const float* qv,
        const float* kv, float* o, float* lse, float* opart, float* ml,
        int B, int Nq, int Nk, int C3, int D, int W, int parts,
        cudaStream_t s) {
  using L = Layout<NFD>;
  const auto kernel = shift9_fwd_kernel<NFD>;
  int e = set_smem(kernel, L::BYTES);
  if (e) return e;
  const int nd = (D + L::DCH - 1) / L::DCH;
  const int per = ((Nk + KOWN - 1) / KOWN + parts - 1) / parts;
  kernel<<<dim3((Nq + QOWN - 1) / QOWN, B, parts * nd), NTF, L::BYTES, s>>>(
      f3, g3, v, qv, kv, opart, ml, B, Nq, Nk, round_up(C3, 4),
      round_up(D, 4), D, W, nd, per);
  if ((e = static_cast<int>(cudaGetLastError()))) return e;
  const size_t n = (size_t)B * Nq * D;
  shift9_fwd_combine_kernel<<<(unsigned)((n + NTF - 1) / NTF), NTF, 0, s>>>(
      opart, ml, o, lse, (size_t)B * Nq, D, parts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace shift9_fwd

extern "C" int cocosnet_shift9_max_d() { return 256; }

// The blocks one part of the key range launches at (B, Nq, D), and the key
// regions that cover Nk: the wrapper cuts the regions into the parts that
// fill whole waves.
extern "C" int cocosnet_shift9_fwd_blocks(int B, int Nq, int D) {
  const int dch = 8 * shift9_fwd::nfd_of(D);
  return (Nq + shift9_fwd::QOWN - 1) / shift9_fwd::QOWN * B *
         ((D + dch - 1) / dch);
}
extern "C" int cocosnet_shift9_fwd_key_regions(int Nk) {
  return (Nk + shift9_fwd::KOWN - 1) / shift9_fwd::KOWN;
}

// f3: (B, Nq, C3'), g3: (B, Nk, C3') and v: (B, Nk, D') with C3', D' the
// multiples of 4 at or above C3 and D (zero filled); qv: (B, Nq, 4), kv:
// (B, 4, Nk); o: (B, Nq, D), lse: (B, Nq); scratch opart: (parts, B, Nq,
// D) and ml: (parts, B, Nq, 2). All f32, contiguous and 16-byte aligned;
// Nq and Nk whole image rows of width W, D <= 256, B <= 65535, 1 <= parts
// <= the key regions of Nk. Two launches on `stream`; returns the first
// cudaError_t that is not success.
extern "C" int cocosnet_shift9_fwd(const void* f3, const void* g3,
                                   const void* v, const void* qv,
                                   const void* kv, void* o, void* lse,
                                   void* opart, void* ml, int B, int Nq,
                                   int Nk, int C3, int D, int W, int parts,
                                   void* stream) {
  using Fn = decltype(&shift9_fwd::run<1>);
  const int nfd = shift9_fwd::nfd_of(D);
  const Fn run = nfd == 1   ? &shift9_fwd::run<1>
                 : nfd == 4 ? &shift9_fwd::run<4>
                            : &shift9_fwd::run<20>;
  if (D > cocosnet_shift9_max_d() || parts < 1 ||
      parts > cocosnet_shift9_fwd_key_regions(Nk))
    return static_cast<int>(cudaErrorInvalidValue);
  return run(static_cast<const float*>(f3), static_cast<const float*>(g3),
             static_cast<const float*>(v), static_cast<const float*>(qv),
             static_cast<const float*>(kv), static_cast<float*>(o),
             static_cast<float*>(lse), static_cast<float*>(opart),
             static_cast<float*>(ml), B, Nq, Nk, C3, D, W, parts,
             static_cast<cudaStream_t>(stream));
}
