// Backward of the fused 3x3-unfold correlation, softmax and warp, f32 in
// and out, on the tensor cores.
//
// Replaces: cocosnet_tpu/ops/pallas_shift9.py `_bwd`, its two passes
// `_dq_kernel` (query side) and `_dk_kernel` (key side), which multiply on
// the TPU's matrix unit in bf16x3 (`_dot3`).
//
// With P = exp(logits - lse) recomputed from the forward's saved lse,
// dP = gO V^T, dd = rowsum(gO * O) and gl = P (dP - dd), da = gl qs ks is
// the gradient of the shift-summed correlation `raw`. Its adjoint through
// the diagonal shifts is
//   dS3(i, j) = da(i, j) + m+(i-1, j-1) da(i-1, j-1) + m-(i+1, j+1) da(i+1, j+1)
// (pallas_shift9.py `_unshift_sum`), and the outputs are
//   dF3 = dS3 G3, dG3 = dS3^T F3, dV = P^T gO,
//   per query  dqs = sum_j gl logits / qs, dqmul = -sum_j da kmul,
//              dqadd = dcadd = sum_j da,
//   per key    dks = sum_i gl logits / ks, dkmul = -sum_i da qmul,
//              dkadd = sum_i da.
//
// Bound on the H100: operations. The function needs S3 = F3 G3^T and dP
// once each, then dF3, dG3 and dV: 2 B N^2 (3 3C + 2 D) flops (701.2 GFLOP
// at B = 8, N = 4096, 3C = 768, D = 154) against O(B N (3C + D)) bytes. tau
// = 0.01 amplifies logit error 100x, so no product runs in one TF32 or
// bf16 pass; the cheapest split that holds the tolerance is bf16x3 (three
// passes at 989 TFLOP/s: 2.127 ms). This kernel issues 3xTF32 (three
// passes at 495 TFLOP/s: 4.250 ms; see tc_split.cuh).
//
// Design: S3 and dS3 are formed once, materialized as in corr_bwd.cu, in
// five launches:
//   1. scores: per tile of 124 queries x 124 keys, S3 on the tile plus a
//      two-position halo each side (a 128 x 128 region: da is needed one
//      position beyond the tile for the shifts of dS3, and the logits one
//      position further for the shifts of raw; 6.6% of S3 on the halo) and
//      dP = gO V^T on the same region, both on the shared stage-flushed
//      3xTF32 mainloop (dP too: D = 154 would chain 60 mma otherwise, and
//      dqs below feels the drift); S3 goes to shared memory for the
//      diagonal neighbours; the logits, P, gl and da are formed in
//      registers with the operations and roundings of shift9_bwd_plain, in
//      its order; da goes to shared memory, and dS3 and P of the owned
//      positions are
//      written to scratch (B, Np, Np) f32 (N rounded up to 128; positions
//      past N hold zeros). The per-position side gradients are summed over
//      the tile's keys (per query) and queries (per key) in a fixed order
//      and written as per-tile partials (B, tiles, N, 3);
//   2. reduce: each position's partials summed over the tiles in order,
//      then divided by qs (ks) and negated as the formulas above want;
//   3. dF3 = dS3 G3   (dS3 read K-major),
//   4. dG3 = dS3^T F3 (dS3 read M-major),
//   5. dV  = P^T gO   (P read M-major): the tiled GEMM of tc_split.cuh,
//      launches 2-4 of corr_bwd.cu at 3C and D.
// Positions are flattened row-major, so a halo position past the end of an
// image row is exactly the one the column mask zeroes, and positions
// outside [0, N) load as zeros and carry no gradient: every image width W
// works. F3, G3, gO and V arrive with 3C and D rounded up to a multiple of
// 4 (16-byte rows, zero filled); the wrapper makes the copy where needed.
// No atomics: every output element is summed by one thread in one order,
// so two launches give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_split.cuh"

namespace shift9_bwd {

using namespace tc;

struct Src {};  // names this source's GEMM instances

constexpr int OWN = TILE - 4;  // positions a tile owns on each side
constexpr int LDR = TILE + 8;  // region rows in shared memory (float2 rows
                               // conflict-free per half warp)
constexpr int VALID = 1, PLUS = 2, MINUS = 4;  // per-position flags
using RS = Ring<true, true, 4>;
// the ring, the region (S3, then da), then the terms of the region's rows
// (qs, qmul, qadd, cadd, lse, dd) and columns (ks, kmul, kadd) and their
// flags
constexpr int REGION = STAGES * RS::STAGE;
constexpr int TERMS = REGION + TILE * LDR;
constexpr int SMEM_BYTES = 4 * (TERMS + 9 * TILE) + 8 * TILE;
static_assert(6 * TILE * 3 <= STAGES * RS::STAGE,
              "the partial sums fit in the ring");

__device__ __forceinline__ int flags(int pos, int N, int W) {
  const int col = ((pos % W) + W) % W;
  return (pos >= 0 && pos < N ? VALID : 0) | (col != W - 1 ? PLUS : 0) |
         (col != 0 ? MINUS : 0);
}

// Launch 1. Grid (tiles, tiles, B), tile t owning positions [OWN t, OWN t
// + OWN) of the keys (x) and the queries (y). f3, g3: (B, N, C3p), go, v:
// (B, N, Dp); qv, kvt: (B, N, 4) rank-1 terms per position (s, mul, add,
// add2); lse, dd: (B, N); p, ds: (B, Np, Np); qpart, kpart: (B, tiles, N,
// 3) (sum gl logits, sum da mul, sum da).
__global__ void __launch_bounds__(NT, 1) shift9_bwd_scores_kernel(
    const float* __restrict__ f3, const float* __restrict__ g3,
    const float* __restrict__ go, const float* __restrict__ v,
    const float* __restrict__ qv, const float* __restrict__ kvt,
    const float* __restrict__ lse, const float* __restrict__ dd,
    float* __restrict__ p, float* __restrict__ ds,
    float* __restrict__ qpart, float* __restrict__ kpart, int N, int C3p,
    int Dp, int Np, int W, int nt) {
  extern __shared__ __align__(16) float smem[];
  float* rowp = smem;                  // [4][TILE][3]: per column warp
  float* colp = rowp + 4 * TILE * 3;   // [2][TILE][3]: per row warp
  float* sbuf = smem + REGION;         // [TILE][LDR]: S3, then da
  float* rq = smem + TERMS;            // [6][TILE]
  float* ck = rq + 6 * TILE;           // [3][TILE]
  int* rf = reinterpret_cast<int*>(ck + 3 * TILE);  // [TILE]
  int* cf = rf + TILE;                               // [TILE]

  const int b = blockIdx.z;
  const int ia = blockIdx.y * OWN - 2, ja = blockIdx.x * OWN - 2;
  const size_t off3 = (size_t)b * N * C3p, offd = (size_t)b * N * Dp;
  f3 += off3;
  g3 += off3;
  go += offd;
  v += offd;
  qv += (size_t)b * N * 4;
  kvt += (size_t)b * N * 4;
  lse += (size_t)b * N;
  dd += (size_t)b * N;
  p += (size_t)b * Np * Np;
  ds += (size_t)b * Np * Np;
  qpart += (size_t)b * nt * N * 3;
  kpart += (size_t)b * nt * N * 3;

  {
    const int r = threadIdx.x & (TILE - 1);
    const bool row = threadIdx.x < TILE;
    const int pos = (row ? ia : ja) + r;
    const int f = flags(pos, N, W);
    const bool ok = f & VALID;
    const float* t4 = (row ? qv : kvt) + 4 * (size_t)(ok ? pos : 0);
    if (row) {
#pragma unroll
      for (int i = 0; i < 4; ++i) rq[i * TILE + r] = ok ? t4[i] : 0.f;
      rq[4 * TILE + r] = ok ? lse[pos] : 0.f;
      rq[5 * TILE + r] = ok ? dd[pos] : 0.f;
      rf[r] = f;
    } else {
      ck[r] = ok ? t4[0] : 0.f;
      ck[TILE + r] = ok ? t4[1] : 0.f;
      ck[2 * TILE + r] = ok ? t4[2] : 0.f;
      cf[r] = f;
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rr0 = 64 * (warp >> 2), cc0 = 32 * (warp & 3);
  // S3 into the region in shared memory, then dP, each product's partial
  // sums flushed per stage; S3 leaves the registers before dP comes in
  float acc[4][4][4], dp[4][4][4];
  zero(acc);
  mainloop<true, true, 4, true>(acc, smem, (C3p + BK - 1) / BK,
                                [&](float* sA, float* sB, int k0) {
                                  load_kmajor<TILE>(sA, f3, C3p, ia, N, k0,
                                                    C3p);
                                  load_kmajor<TILE>(sB, g3, C3p, ja, N, k0,
                                                    C3p);
                                });
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<float2*>(
            sbuf + (rr0 + 16 * mi + g + 8 * h) * LDR + cc0 + 8 * ni + 2 * t) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
  zero(dp);
  mainloop<true, true, 4, true>(dp, smem, (Dp + BK - 1) / BK,
                                [&](float* sA, float* sB, int k0) {
                                  load_kmajor<TILE>(sA, go, Dp, ia, N, k0,
                                                    Dp);
                                  load_kmajor<TILE>(sB, v, Dp, ja, N, k0, Dp);
                                });
  __syncthreads();  // every warp is done with the ring; S3 is in

  // logits, P, gl and da on region rows and columns 1 .. TILE - 2 (P into
  // acc, da into dp); the side gradients' sums over the owned positions
  float csum[4][2][3];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int c = 0; c < 3; ++c) csum[ni][e][c] = 0.f;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rr0 + 16 * mi + g + 8 * h;
      const int rfl = rf[row];
      const float qs = rq[row], qmul = rq[TILE + row];
      const float qadd = rq[2 * TILE + row], cadd = rq[3 * TILE + row];
      const float l = rq[4 * TILE + row], d = rq[5 * TILE + row];
      const bool rin = row >= 1 && row <= TILE - 2;
      const bool rown = row >= 2 && row <= TILE - 3;
      float rsum[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = cc0 + 8 * ni + 2 * t + e;
          const int both = rfl & cf[col];
          const float ks = ck[col], kmul = ck[TILE + col];
          float pv = 0.f, gl = 0.f, da = 0.f, gll = 0.f;
          if (rin && col >= 1 && col <= TILE - 2 && (both & VALID)) {
            // the operations and roundings of shift9_bwd_plain, in its
            // order, none fused: dqs cancels across a row, and the logits'
            // f32 rounding (1/tau = 100 in them) returns 100x in it
            const float plus =
                both & PLUS ? sbuf[(row + 1) * LDR + col + 1] : 0.f;
            const float minus =
                both & MINUS ? sbuf[(row - 1) * LDR + col - 1] : 0.f;
            const float raw =
                __fadd_rn(__fadd_rn(sbuf[row * LDR + col], plus), minus);
            float lg = __fsub_rn(raw, __fmul_rn(qmul, kmul));
            lg = __fadd_rn(__fadd_rn(__fadd_rn(lg, qadd), ck[2 * TILE + col]),
                           cadd);
            lg = __fmul_rn(__fmul_rn(lg, qs), ks);
            pv = expf(__fsub_rn(lg, l));
            gl = __fmul_rn(pv, __fsub_rn(dp[mi][ni][2 * h + e], d));
            da = __fmul_rn(__fmul_rn(gl, qs), ks);
            gll = __fmul_rn(gl, lg);
          }
          if (rown && col >= 2 && col <= TILE - 3) {
            rsum[0] += gll;
            rsum[1] += __fmul_rn(da, kmul);
            rsum[2] += da;
            csum[ni][e][0] += gll;
            csum[ni][e][1] += __fmul_rn(da, qmul);
            csum[ni][e][2] += da;
          }
          acc[mi][ni][2 * h + e] = pv;
          dp[mi][ni][2 * h + e] = da;
        }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        rsum[c] += __shfl_xor_sync(0xffffffffu, rsum[c], 1);
        rsum[c] += __shfl_xor_sync(0xffffffffu, rsum[c], 2);
      }
      if (t == 0)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          rowp[((warp & 3) * TILE + row) * 3 + c] = rsum[c];
    }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float x = csum[ni][e][c];
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        csum[ni][e][c] = x;
      }
      if (g == 0)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          colp[((warp >> 2) * TILE + cc0 + 8 * ni + 2 * t + e) * 3 + c] =
              csum[ni][e][c];
    }
  __syncthreads();  // every read of S3 is done
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<float2*>(
            sbuf + (rr0 + 16 * mi + g + 8 * h) * LDR + cc0 + 8 * ni + 2 * t) =
            make_float2(dp[mi][ni][2 * h], dp[mi][ni][2 * h + 1]);
  __syncthreads();

  // dS3 and P of the owned positions (region rows and columns 2 .. TILE -
  // 3) below Np, zero at positions past N; a column pair never straddles
  // the owned range (both ends are even)
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rr0 + 16 * mi + g + 8 * h;
      const int i = ia + row;
      if (row < 2 || row > TILE - 3 || i >= Np) continue;
      const int up = rf[row - 1], down = rf[row + 1];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = cc0 + 8 * ni + 2 * t;
        const int j = ja + col;
        if (col < 2 || col > TILE - 3 || j >= Np) continue;
        float sv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col + e;
          float x = 0.f;
          if (i < N && j + e < N) {
            x = dp[mi][ni][2 * h + e];
            if (up & cf[c - 1] & PLUS) x += sbuf[(row - 1) * LDR + c - 1];
            if (down & cf[c + 1] & MINUS) x += sbuf[(row + 1) * LDR + c + 1];
          }
          sv[e] = x;
        }
        const size_t at = (size_t)i * Np + j;
        *reinterpret_cast<float2*>(ds + at) = make_float2(sv[0], sv[1]);
        *reinterpret_cast<float2*>(p + at) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }

  // the tile's partial sums: per owned query over the four column warps,
  // per owned key over the two row warps, in that order
  for (int e = threadIdx.x; e < OWN * 3; e += NT) {
    const int r = 2 + e / 3, c = e % 3;
    const int i = ia + r, j = ja + r;
    if (i < N)
      qpart[((size_t)blockIdx.x * N + i) * 3 + c] =
          rowp[r * 3 + c] + rowp[(TILE + r) * 3 + c] +
          rowp[(2 * TILE + r) * 3 + c] + rowp[(3 * TILE + r) * 3 + c];
    if (j < N)
      kpart[((size_t)blockIdx.y * N + j) * 3 + c] =
          colp[r * 3 + c] + colp[(TILE + r) * 3 + c];
  }
}

// Launch 2. One thread per (side, sample, position): the per-tile partials
// summed over the tiles in order; dq3, dk3: (B, N, 3) = (sum gl logits /
// s, -sum da mul, sum da).
__global__ void shift9_bwd_reduce_kernel(
    const float* __restrict__ qpart, const float* __restrict__ kpart,
    const float* __restrict__ qv, const float* __restrict__ kvt,
    float* __restrict__ dq3, float* __restrict__ dk3, int B, int N, int nt) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t bn = (size_t)B * N;
  if (idx >= 2 * bn) return;
  const bool key = idx >= bn;
  const size_t r = key ? idx - bn : idx;
  const size_t b = r / N, i = r % N;
  const float* part = (key ? kpart : qpart) + (b * nt * N + i) * 3;
  float s[3] = {0.f, 0.f, 0.f};
  for (int tile = 0; tile < nt; ++tile)
#pragma unroll
    for (int c = 0; c < 3; ++c) s[c] += part[(size_t)tile * N * 3 + c];
  float* out = (key ? dk3 : dq3) + r * 3;
  out[0] = s[0] / (key ? kvt : qv)[r * 4];
  out[1] = -s[1];
  out[2] = s[2];
}

template <int NF_V>
int backward(const float* f3, const float* g3, const float* v,
             const float* go, const float* qv, const float* kvt,
             const float* lse, const float* dd, float* df3, float* dq3,
             float* dg3, float* dk3, float* dv, float* p, float* ds,
             float* qpart, float* kpart, int B, int N, int C3, int D, int W,
             cudaStream_t s) {
  const int C3p = round_up(C3, 4), Dp = round_up(D, 4);
  const int Np = round_up(N, TILE), nt = (Np + OWN - 1) / OWN;
  const size_t nn = (size_t)Np * Np;
  int e = set_smem(shift9_bwd_scores_kernel, SMEM_BYTES);
  if (e) return e;
  shift9_bwd_scores_kernel<<<dim3(nt, nt, B), NT, SMEM_BYTES, s>>>(
      f3, g3, go, v, qv, kvt, lse, dd, p, ds, qpart, kpart, N, C3p, Dp, Np,
      W, nt);
  if ((e = static_cast<int>(cudaGetLastError()))) return e;
  const size_t threads = 2 * (size_t)B * N;
  shift9_bwd_reduce_kernel<<<(unsigned)((threads + NT - 1) / NT), NT, 0, s>>>(
      qpart, kpart, qv, kvt, dq3, dk3, B, N, nt);
  if ((e = static_cast<int>(cudaGetLastError()))) return e;
  const size_t f_batch = (size_t)N * C3p, o_batch = (size_t)N * C3;
  if ((e = gemm<Src, true, 4>(ds, Np, nn, g3, C3p, f_batch, N, C3p, df3, C3,
                              o_batch, N, C3, Np, B, s)))
    return e;
  if ((e = gemm<Src, false, 4>(ds, Np, nn, f3, C3p, f_batch, N, C3p, dg3, C3,
                               o_batch, N, C3, Np, B, s)))
    return e;
  return gemm<Src, false, NF_V>(p, Np, nn, go, Dp, (size_t)N * Dp, N, Dp, dv,
                                D, (size_t)N * D, N, D, Np, B, s);
}

}  // namespace shift9_bwd

// Rows of the scratch's tile (the wrapper pads N to it) and the positions
// a scores tile owns on each side (the partials hold ceil(Np / owned)
// tiles).
extern "C" int cocosnet_shift9_bwd_tile() { return shift9_bwd::TILE; }
extern "C" int cocosnet_shift9_bwd_owned() { return shift9_bwd::OWN; }

// f3, g3: (B, N, C3') and v, go: (B, N, D') with C3', D' the multiples of
// 4 at or above C3 and D (zero filled); qv, kvt: (B, N, 4) rank-1 terms
// per position (s, mul, add, add2; kvt is kv transposed with its zero
// row); lse, dd: (B, N); scratch p, ds: (B, Np, Np) with Np the multiple
// of the tile at or above N, and qpart, kpart: (B, tiles, N, 3) with tiles
// = ceil(Np / owned). Outputs df3, dg3: (B, N, C3); dq3, dk3: (B, N, 3)
// (ds, dmul, dadd); dv: (B, N, D). All f32, contiguous, 16-byte aligned;
// N = H W for the image width W, B <= 65535. Five launches on `stream`,
// dV's tiles 32 columns wide where D <= 32, else 96; returns the first
// cudaError_t that is not success.
extern "C" int cocosnet_shift9_bwd(
    const void* f3, const void* g3, const void* v, const void* go,
    const void* qv, const void* kvt, const void* lse, const void* dd,
    void* df3, void* dq3, void* dg3, void* dk3, void* dv, void* p, void* ds,
    void* qpart, void* kpart, int B, int N, int C3, int D, int W,
    void* stream) {
  using Fn = decltype(&shift9_bwd::backward<1>);
  const Fn run = D <= 32 ? &shift9_bwd::backward<1>
                         : &shift9_bwd::backward<3>;
  return run(static_cast<const float*>(f3), static_cast<const float*>(g3),
             static_cast<const float*>(v), static_cast<const float*>(go),
             static_cast<const float*>(qv), static_cast<const float*>(kvt),
             static_cast<const float*>(lse), static_cast<const float*>(dd),
             static_cast<float*>(df3), static_cast<float*>(dq3),
             static_cast<float*>(dg3), static_cast<float*>(dk3),
             static_cast<float*>(dv), static_cast<float*>(p),
             static_cast<float*>(ds), static_cast<float*>(qpart),
             static_cast<float*>(kpart), B, N, C3, D, W,
             static_cast<cudaStream_t>(stream));
}
