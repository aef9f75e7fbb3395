// Fused correlation, softmax and warp of dense descriptors (forward), f32.
//
// Replaces: cocosnet_tpu/ops/pallas_corr.py `_fwd` / `_fwd_kernel`, the
// forward of `attend_pallas` (match_kernel = 1).
//
// Computes o = softmax(q k^T / tau) v and lse = logsumexp(q k^T / tau) per
// query row, for q (N, C), k (M, C), v (M, D) per sample, without the N x M
// logits in device memory.
//
// Bound on the H100: operations. 2 B N M (C + D) flops (82.5 GFLOP at the
// match_kernel = 1 flagship B = 6, N = M = 4096, C = 256, D = 154) against
// O(B (N + M) (C + D)) bytes. tau = 0.01 amplifies logit error 100x, so the
// products run in f32 FMA - never single-pass bf16 or TF32 - and the bound
// is the card's f32 rate.
//
// Design: one block per (sample, 64-query tile); the block walks 64-key
// tiles with an online softmax, flash style. Per key tile: S = Q K^T (64 x
// 64) accumulates from 32-channel chunks of q and k staged k-major in shared
// memory (a 4 x 4 register tile per thread, read as two float4; the next
// chunk is fetched into registers while this one is multiplied) and lands in
// shared memory; each warp turns its 8 query rows into logits, updates its
// running max and sum in registers, writes P over S in place and accumulates
// P V for those rows with V's tile in shared memory (P read as float4
// broadcasts, four keys at a time). Any N and M: keys past M take a logit of
// -inf (no mass), query rows past N compute nothing and are not written;
// their q and k rows load as zeros. A simple kernel: no tensor cores, no
// TMA, q chunks re-read from L2 for every key tile.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int T = 64;                 // queries per block, keys per tile
constexpr int KC = 32;                // channels per staged chunk
constexpr int NT = 256;
constexpr int ROWS = T / (NT / 32);   // query rows per warp
constexpr int LDT = T + 4;            // k-major staging, float4 rows
constexpr int LDS = T + 4;            // S and P, float4 rows

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int NC>  // value columns per lane; D padded to 32 * NC
__global__ void __launch_bounds__(NT, 2)
    corr_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int N, int M, int C, int D,
                    float tau_inv) {
  extern __shared__ __align__(16) float sm[];
  constexpr int DP = 32 * NC;
  float* Qt = sm;               // [KC][LDT]
  float* Kt = Qt + KC * LDT;    // [KC][LDT]
  float* S = Kt + KC * LDT;     // [T][LDS]: S, then P in place
  float* Vs = S + T * LDS;      // [T][DP]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * T;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16, ty = tid / 16;
  q += (size_t)b * N * C;
  k += (size_t)b * M * C;
  v += (size_t)b * M * D;
  o += (size_t)b * N * D;
  lse += (size_t)b * N;

  float m[ROWS], l[ROWS], acc[ROWS][NC];
  bool live[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    live[r] = q0 + warp * ROWS + r < N;
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < M; k0 += T) {
    for (int e = tid; e < T * DP; e += NT) {
      const int j = e / DP, d = e % DP, kg = k0 + j;
      Vs[e] = (d < D && kg < M) ? v[(size_t)kg * D + d] : 0.f;
    }
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    // S over the tile: each thread owns rows 4 ty .. 4 ty + 3 and columns
    // 4 tx .. 4 tx + 3
    constexpr int PF = T * KC / NT;
    const int kk = tid % KC, row0 = tid / KC;  // element tid + NT i
    float rq[PF], rk[PF];
    auto fetch = [&](int c0) {
      const int c = c0 + kk;
#pragma unroll
      for (int i = 0; i < PF; ++i) {
        const int row = row0 + (NT / KC) * i, qg = q0 + row, kg = k0 + row;
        rq[i] = (c < C && qg < N) ? q[(size_t)qg * C + c] : 0.f;
        rk[i] = (c < C && kg < M) ? k[(size_t)kg * C + c] : 0.f;
      }
    };
    fetch(0);
    for (int c0 = 0; c0 < C; c0 += KC) {
#pragma unroll
      for (int i = 0; i < PF; ++i) {
        Qt[kk * LDT + row0 + (NT / KC) * i] = rq[i];
        Kt[kk * LDT + row0 + (NT / KC) * i] = rk[i];
      }
      __syncthreads();
      if (c0 + KC < C) fetch(c0 + KC);
#pragma unroll 8
      for (int c = 0; c < KC; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(&Qt[c * LDT + 4 * ty]);
        const float4 g = *reinterpret_cast<const float4*>(&Kt[c * LDT + 4 * tx]);
        const float av[4] = {a.x, a.y, a.z, a.w}, gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], gv[j], s[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&S[(4 * ty + i) * LDS + 4 * tx]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    __syncthreads();

    // logits and the online softmax: warp w owns tile rows w * ROWS .., and
    // lanes own tile columns lane and lane + 32; columns past M take no
    // probability
    bool klive[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) klive[t] = k0 + lane + 32 * t < M;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = warp * ROWS + r;
      if (!live[r]) {  // warp-uniform
        S[i * LDS + lane] = 0.f;
        S[i * LDS + lane + 32] = 0.f;
        continue;
      }
      float lg[2];
#pragma unroll
      for (int t = 0; t < 2; ++t)
        lg[t] = klive[t] ? S[i * LDS + lane + 32 * t] * tau_inv : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(lg[0], lg[1])));
      const float p0 = expf(lg[0] - m_new), p1 = expf(lg[1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
      S[i * LDS + lane] = p0;
      S[i * LDS + lane + 32] = p1;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();
    // acc += P V for the warp's rows, four keys at a time
#pragma unroll 2
    for (int j = 0; j < T; j += 4) {
      float vv[4][NC];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[u][c] = Vs[(j + u) * DP + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(
            &S[(warp * ROWS + r) * LDS + j]);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[r][c] = fmaf(p.x, vv[0][c], acc[r][c]);
          acc[r][c] = fmaf(p.y, vv[1][c], acc[r][c]);
          acc[r][c] = fmaf(p.z, vv[2][c], acc[r][c]);
          acc[r][c] = fmaf(p.w, vv[3][c], acc[r][c]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (!live[r]) continue;
    const int qg = q0 + warp * ROWS + r;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[(size_t)qg * D + d] = acc[r][c] * inv;
    }
    if (lane == 0) lse[qg] = m[r] + logf(l[r]);
  }
}

template <int NC>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int B, int N, int M, int C, int D, float tau_inv,
           cudaStream_t s) {
  const int smem = (2 * KC * LDT + T * LDS + T * 32 * NC) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      corr_fwd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + T - 1) / T, B);
  corr_fwd_kernel<NC><<<grid, NT, smem, s>>>(q, k, v, o, lse, N, M, C, D,
                                             tau_inv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cocosnet_corr_max_d() { return 32 * 8; }

// q: (B, N, C), k: (B, M, C), v: (B, M, D), all f32 and contiguous; o:
// (B, N, D), lse: (B, N). Any N, M >= 1 and C; D <= 256 (the wrapper
// checks). Launches on `stream` and returns the cudaError_t of the launch.
extern "C" int cocosnet_corr_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int N, int M,
                                 int C, int D, float tau_inv, void* stream) {
  const float* Q = static_cast<const float*>(q);
  const float* K = static_cast<const float*>(k);
  const float* V = static_cast<const float*>(v);
  float* O = static_cast<float*>(o);
  float* L = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32) {
    case 1: return launch<1>(Q, K, V, O, L, B, N, M, C, D, tau_inv, s);
    case 2: return launch<2>(Q, K, V, O, L, B, N, M, C, D, tau_inv, s);
    case 3: return launch<3>(Q, K, V, O, L, B, N, M, C, D, tau_inv, s);
    case 4: return launch<4>(Q, K, V, O, L, B, N, M, C, D, tau_inv, s);
    case 5: return launch<5>(Q, K, V, O, L, B, N, M, C, D, tau_inv, s);
    case 6: return launch<6>(Q, K, V, O, L, B, N, M, C, D, tau_inv, s);
    case 7: return launch<7>(Q, K, V, O, L, B, N, M, C, D, tau_inv, s);
    case 8: return launch<8>(Q, K, V, O, L, B, N, M, C, D, tau_inv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
