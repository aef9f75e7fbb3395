// Backward of the flash correlation at large descriptor widths (C = 2304,
// the 3x3-unfold descriptors of match_kernel 3), f32.
//
// Replaces: cocosnet_tpu/ops/pallas_corr_bigc.py `_bwd_impl`, its two kernels
// `_dq_kernel` (query side) and `_dkv_kernel` (key side).
//
// With P = exp(q k^T / tau - lse) recomputed from the forward's saved lse,
// dP = gO v^T, dd = rowsum(gO * O) and dS = P (dP - dd), the outputs are
//   dq = dS k / tau,  dk = dS^T q / tau,  dv = P^T gO.
//
// Bound on the H100: operations. The function needs S and dP once each,
// then dq, dk and dv: 2 B N M (3 C + 2 D) flops (1.393 TFLOP at B = 6, N =
// M = 4096, C = 2304, D = 3), against O(B (N + M) (C + D)) bytes. This
// two-pass design recomputes S and dP in its second pass, 2 B N M (4 C + 3
// D) in all (1.857 TFLOP there). tau = 0.01 amplifies logit error 100x, so
// every product is f32 FMA and the bound is the card's f32 rate.
//
// Design: corr_bwd.cu's two passes (a block owns 32 positions of one side,
// queries in the query pass and keys in the key pass, and walks the other
// side in tiles of 64; per tile it forms S and dP from 32-column chunks
// staged k-major, turns them into dS, and adds dS times the streamed rows
// into the owner's gradient rows), with one change for the width: 32 owner
// rows of C = 2304 floats are 295 KB, over the 227 KB of shared memory a
// block may hold, so the owner's gradient rows accumulate in place in the
// output tensor in device memory (mostly in the 50 MB L2). Only this block
// writes those rows, and each element is read and written by one thread
// only, in the same order every run: no atomics, deterministic results.
// dS carries the 1/tau factor, so the rows need no final pass. The key
// pass's dv rows (D wide) stay in shared memory. Any N and M: positions
// past either end load as zeros and take P = dS = 0, and rows past the end
// are neither accumulated nor written. A simple kernel: no tensor cores, no
// TMA, operands re-read from L2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int OWN = 32;         // owner positions per block
constexpr int STR = 64;         // streamed positions per step
constexpr int KC = 32;          // contraction chunk of the tile products
constexpr int CW = 128;         // output column chunk of the row updates
constexpr int RG = 8;           // owner rows per thread in the row updates
constexpr int NT = 256;
constexpr int LDA = OWN + 2;    // k-major staging, float2 rows
constexpr int LDB = STR + 4;    // k-major staging, float4 columns
constexpr int LDS = STR + 4;    // tile matrices, float4 rows
// scratch shared by the tile products' staging and the row updates'
constexpr int SCR = (KC * LDA + KC * LDB > STR * CW) ? KC * LDA + KC * LDB
                                                     : STR * CW;
static_assert(OWN == 4 * RG, "four row groups of RG rows cover the tile");
static_assert(OWN == 2 * (NT / 16) && STR == 4 * 16,
              "a 2 x 4 register tile per thread covers the tile");

// out[a][b] = sum_k Xa[A0 + a][k] Xb[B0 + b][k] over the OWN x STR tile,
// rows of width K; rows past Na (Nb) read as zeros. Chunks of KC columns
// are staged k-major; each thread owns rows 2 ty, 2 ty + 1 and columns
// 4 tx .. 4 tx + 3 and reads them as one float2 and one float4.
__device__ __forceinline__ void tile_product(
    const float* __restrict__ xa, const float* __restrict__ xb, int A0,
    int Na, int B0, int Nb, int K, float* scratch, float* out) {
  float* At = scratch;             // [KC][LDA]
  float* Bt = scratch + KC * LDA;  // [KC][LDB]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float s[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  constexpr int PA = OWN * KC / NT, PB = STR * KC / NT;
  const int kk = tid % KC, row0 = tid / KC;  // element tid + NT i
  float ra[PA], rb[PB];
  auto fetch = [&](int c0) {
    const int c = c0 + kk;
#pragma unroll
    for (int i = 0; i < PA; ++i) {
      const int p = A0 + row0 + (NT / KC) * i;
      ra[i] = (c < K && p < Na) ? xa[(size_t)p * K + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < PB; ++i) {
      const int p = B0 + row0 + (NT / KC) * i;
      rb[i] = (c < K && p < Nb) ? xb[(size_t)p * K + c] : 0.f;
    }
  };
  fetch(0);
  for (int c0 = 0; c0 < K; c0 += KC) {
#pragma unroll
    for (int i = 0; i < PA; ++i) At[kk * LDA + row0 + (NT / KC) * i] = ra[i];
#pragma unroll
    for (int i = 0; i < PB; ++i) Bt[kk * LDB + row0 + (NT / KC) * i] = rb[i];
    __syncthreads();
    if (c0 + KC < K) fetch(c0 + KC);  // in flight during the products
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      const float2 a = *reinterpret_cast<const float2*>(&At[k * LDA + 2 * ty]);
      const float4 g = *reinterpret_cast<const float4*>(&Bt[k * LDB + 4 * tx]);
      const float av[2] = {a.x, a.y}, gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], gv[j], s[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    *reinterpret_cast<float4*>(&out[(2 * ty + i) * LDS + 4 * tx]) =
        make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
}

// acc[a][c] += sum_bb Mt[a][bb] Y[B0 + bb][c] for the first `rows` rows of
// the OWN x STR matrix Mt (leading dimension LDS) and the STR streamed rows
// of Y (width K, rows past Nb read as zeros); acc is in shared or device
// memory. Chunks of CW columns of Y are staged; warp w owns rows RG (w / 2)
// .. RG (w / 2) + RG - 1 (Mt read as warp-wide float4 broadcasts) and each
// lane the columns (w % 2) 64 + lane and + 32 of the chunk, so an element
// of acc is always updated by the same thread.
__device__ __forceinline__ void accumulate_rows(
    const float* __restrict__ y, const float* Mt, int B0, int Nb, int K,
    float* Ys, float* acc, int rows) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = RG * (warp / 2), cb = (warp % 2) * 64 + lane;
  constexpr int PY = STR * CW / NT;
  static_assert(STR * CW % NT == 0, "whole staging rounds");
  float ry[PY];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int i = 0; i < PY; ++i) {
      const int e = tid + NT * i;
      const int row = e / CW, c = c0 + e % CW, p = B0 + row;
      ry[i] = (c < K && p < Nb) ? y[(size_t)p * K + c] : 0.f;
    }
  };
  fetch(0);
  for (int c0 = 0; c0 < K; c0 += CW) {
#pragma unroll
    for (int i = 0; i < PY; ++i) Ys[tid + NT * i] = ry[i];
    __syncthreads();
    if (c0 + CW < K) fetch(c0 + CW);  // in flight during the products
    float s[RG][2];
#pragma unroll
    for (int i = 0; i < RG; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 2
    for (int bb = 0; bb < STR; bb += 4) {
      float4 m[RG];
#pragma unroll
      for (int i = 0; i < RG; ++i)
        m[i] = *reinterpret_cast<const float4*>(&Mt[(r0 + i) * LDS + bb]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float y0 = Ys[(bb + u) * CW + cb];
        const float y1 = Ys[(bb + u) * CW + cb + 32];
#pragma unroll
        for (int i = 0; i < RG; ++i) {
          const float mv = u == 0 ? m[i].x : u == 1 ? m[i].y
                           : u == 2 ? m[i].z : m[i].w;
          s[i][0] = fmaf(mv, y0, s[i][0]);
          s[i][1] = fmaf(mv, y1, s[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + cb + 32 * h;
        if (c < K && r0 + i < rows) acc[(size_t)(r0 + i) * K + c] += s[i][h];
      }
    __syncthreads();
  }
}

// One pass. QROW: the owner side is the queries (the dq pass), else the
// keys (the dk pass, which also forms dv). xa/wa are the owner side's
// descriptors (q or k, width C) and value-side rows (gO or v, width D);
// xb/wb the streamed side's. lse and dd belong to the queries.
template <bool QROW>
__global__ void __launch_bounds__(NT)
    corr_bigc_bwd_kernel(const float* __restrict__ xa,
                         const float* __restrict__ xb,
                         const float* __restrict__ wa,
                         const float* __restrict__ wb,
                         const float* __restrict__ lse,
                         const float* __restrict__ dd, float* dx,
                         float* __restrict__ dv, int Na, int Nb, int C, int D,
                         float tau_inv) {
  extern __shared__ __align__(16) float sm[];
  float* scratch = sm;               // [SCR]: staging
  float* Sm = scratch + SCR;         // [OWN][LDS]: S, then dS / tau
  float* Dm = Sm + OWN * LDS;        // [OWN][LDS]: dP
  float* Pm = Dm + OWN * LDS;        // [OWN][LDS]: P, key pass
  float* dvs = Pm + OWN * LDS;       // [OWN][D], key pass

  const int b = blockIdx.y;
  const int A0 = blockIdx.x * OWN;   // global position of tile row 0
  const int rows = min(OWN, Na - A0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  xa += (size_t)b * Na * C;
  xb += (size_t)b * Nb * C;
  wa += (size_t)b * Na * D;
  wb += (size_t)b * Nb * D;
  lse += (size_t)b * (QROW ? Na : Nb);
  dd += (size_t)b * (QROW ? Na : Nb);
  // the owner's gradient rows, accumulated in place in the output
  float* dxr = dx + ((size_t)b * Na + A0) * C;
  if (!QROW) dv += (size_t)b * Na * D;

  for (int e = tid; e < rows * C; e += NT) dxr[e] = 0.f;
  if (!QROW)
    for (int e = tid; e < OWN * D; e += NT) dvs[e] = 0.f;

  // the rows this warp turns into dS: tile rows warp + 8 r
  float rlse[4], rdd[4];
  bool rvalid[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int ga = A0 + warp + 8 * r;
    rvalid[r] = ga < Na;
    rlse[r] = (QROW && rvalid[r]) ? lse[ga] : 0.f;
    rdd[r] = (QROW && rvalid[r]) ? dd[ga] : 0.f;
  }
  __syncthreads();

  for (int B0 = 0; B0 < Nb; B0 += STR) {
    tile_product(xa, xb, A0, Na, B0, Nb, C, scratch, Sm);
    tile_product(wa, wb, A0, Na, B0, Nb, D, scratch, Dm);
    __syncthreads();

    // P and dS = P (dP - dd); lanes own tile columns lane and lane + 32
    float clse[2], cdd[2];
    bool cvalid[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int gb = B0 + lane + 32 * u;
      cvalid[u] = gb < Nb;
      clse[u] = (!QROW && cvalid[u]) ? lse[gb] : 0.f;
      cdd[u] = (!QROW && cvalid[u]) ? dd[gb] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int a = warp + 8 * r;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = lane + 32 * u;
        float p = 0.f, ds = 0.f;
        if (rvalid[r] && cvalid[u]) {
          const float l = QROW ? rlse[r] : clse[u];
          const float d = QROW ? rdd[r] : cdd[u];
          p = expf(Sm[a * LDS + col] * tau_inv - l);
          ds = p * (Dm[a * LDS + col] - d);
        }
        Sm[a * LDS + col] = ds * tau_inv;
        if (!QROW) Pm[a * LDS + col] = p;
      }
    }
    __syncthreads();

    accumulate_rows(xb, Sm, B0, Nb, C, scratch, dxr, rows);
    if (!QROW) accumulate_rows(wb, Pm, B0, Nb, D, scratch, dvs, OWN);
  }

  if (!QROW)
    for (int e = tid; e < rows * D; e += NT)
      dv[(size_t)A0 * D + e] = dvs[e];
}

int smem_bytes(int D, bool qrow) {
  return 4 * (SCR + 2 * OWN * LDS + (qrow ? 0 : OWN * LDS + OWN * D));
}

template <bool QROW>
int launch(const float* xa, const float* xb, const float* wa, const float* wb,
           const float* lse, const float* dd, float* dx, float* dv, int B,
           int Na, int Nb, int C, int D, float tau_inv, cudaStream_t s) {
  const int smem = smem_bytes(D, QROW);
  cudaError_t e = cudaFuncSetAttribute(
      corr_bigc_bwd_kernel<QROW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Na + OWN - 1) / OWN, B);
  corr_bigc_bwd_kernel<QROW><<<grid, NT, smem, s>>>(
      xa, xb, wa, wb, lse, dd, dx, dv, Na, Nb, C, D, tau_inv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory (bytes) the key pass, the larger, needs for D (C lives in
// device memory); the wrapper checks it against the card's per-block limit.
extern "C" int cocosnet_corr_bigc_bwd_smem(int D) {
  return smem_bytes(D, false);
}

// q: (B, N, C), k: (B, M, C), v: (B, M, D), go: (B, N, D), lse, dd: (B, N).
// Outputs dq: (B, N, C), dk: (B, M, C), dv: (B, M, D). All f32 and
// contiguous; any N, M >= 1 and C. Launches the query pass, then the key
// pass, on `stream`; returns the first cudaError_t that is not success.
extern "C" int cocosnet_corr_bigc_bwd(const void* q, const void* k,
                                      const void* v, const void* go,
                                      const void* lse, const void* dd,
                                      void* dq, void* dk, void* dv, int B,
                                      int N, int M, int C, int D,
                                      float tau_inv, void* stream) {
  const float* Q = static_cast<const float*>(q);
  const float* K = static_cast<const float*>(k);
  const float* V = static_cast<const float*>(v);
  const float* GO = static_cast<const float*>(go);
  const float* L = static_cast<const float*>(lse);
  const float* DD = static_cast<const float*>(dd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = launch<true>(Q, K, GO, V, L, DD, static_cast<float*>(dq), nullptr,
                         B, N, M, C, D, tau_inv, s);
  if (err != 0) return err;
  return launch<false>(K, Q, V, GO, L, DD, static_cast<float*>(dk),
                       static_cast<float*>(dv), B, M, N, C, D, tau_inv, s);
}
