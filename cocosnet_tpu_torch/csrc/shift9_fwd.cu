// Fused 3x3-unfold correlation, softmax and warp (forward), f32.
//
// Replaces: cocosnet_tpu/ops/pallas_shift9.py `_fwd` / `_fwd_kernel`, the
// forward of `attend_shift9`.
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
// Bound on the H100: operations. 2 B N^2 (3C + D) flops (185.6 GFLOP at the
// flagship B=6, N=4096, 3C=768, D=154) against O(B N (3C + D)) bytes. The
// logits are divided by tau = 0.01, which amplifies their error 100x, so
// the products run in f32 FMA - never single-pass bf16 or TF32 - and the
// bound is the card's f32 rate.
//
// Design: one block per (sample, 64-query tile); the block walks 64-key
// tiles with an online softmax, flash style. Tiles are 64 positions, so at
// any image width W dividing 64 they are whole image rows, and a +-1
// diagonal shift leaves the tile only at masked columns: S3 of the tile
// alone is enough. Per key tile: S3 (64 x 64) accumulates from 32-wide
// shared-memory chunks of F3 and G3 (4 x 4 per thread), lands in shared
// memory, each warp turns 8 query rows into logits, updates its running max
// and sum in registers and accumulates P V for those rows with V's tile in
// shared memory. A first, simple kernel: no tensor cores, no TMA, F3 chunks
// re-read from L2 for every key tile.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TQ = 64;
constexpr int TK = 64;
constexpr int KC = 32;
constexpr int NT = 256;
constexpr int ROWS = TQ / (NT / 32);  // query rows per warp
constexpr int LDF = KC + 1;
constexpr int LDS = TK + 1;

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
__global__ void __launch_bounds__(NT)
    shift9_fwd_kernel(const float* __restrict__ f3, const float* __restrict__ g3,
                      const float* __restrict__ v, const float* __restrict__ qv,
                      const float* __restrict__ kv, float* __restrict__ o,
                      float* __restrict__ lse, int N, int C3, int D, int W) {
  extern __shared__ __align__(16) float sm[];
  constexpr int DP = 32 * NC;
  float* Fs = sm;               // [TQ][LDF]
  float* Gs = Fs + TQ * LDF;    // [TK][LDF]
  float* S = Gs + TK * LDF;     // [TQ][LDS]
  float* P = S + TQ * LDS;      // [TQ][LDS]
  float* Vs = P + TQ * LDS;     // [TK][DP]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16, ty = tid / 16;
  f3 += (size_t)b * N * C3;
  g3 += (size_t)b * N * C3;
  v += (size_t)b * N * D;
  qv += (size_t)b * N * 4;
  kv += (size_t)b * 4 * N;
  o += (size_t)b * N * D;
  lse += (size_t)b * N;

  float qs[ROWS], qmul[ROWS], qadd[ROWS], m[ROWS], l[ROWS], acc[ROWS][NC];
  bool qp[ROWS], qm[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int q = q0 + warp * ROWS + r;
    qs[r] = qv[q * 4 + 0];
    qmul[r] = qv[q * 4 + 1];
    qadd[r] = qv[q * 4 + 2] + qv[q * 4 + 3];
    m[r] = -INFINITY;
    l[r] = 0.f;
    const int col = q % W;
    qp[r] = col != W - 1;
    qm[r] = col != 0;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += TK) {
    for (int e = tid; e < TK * DP; e += NT) {
      const int j = e / DP, d = e % DP;
      Vs[e] = d < D ? v[(size_t)(k0 + j) * D + d] : 0.f;
    }
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c0 = 0; c0 < C3; c0 += KC) {
      for (int e = tid; e < TQ * KC; e += NT) {
        const int row = e / KC, k = e % KC, c = c0 + k;
        Fs[row * LDF + k] = c < C3 ? f3[(size_t)(q0 + row) * C3 + c] : 0.f;
        Gs[row * LDF + k] = c < C3 ? g3[(size_t)(k0 + row) * C3 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KC; ++k) {
        float a[4], g[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Fs[(ty + 16 * i) * LDF + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) g[j] = Gs[(tx + 16 * j) * LDF + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], g[j], s[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) S[(ty + 16 * i) * LDS + tx + 16 * j] = s[i][j];
    __syncthreads();

    // logits and the online softmax: warp w owns query rows w*ROWS.. and
    // lanes own key columns lane and lane + 32
    float ks[2], kmul[2], kadd[2];
    bool kp[2], km[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int kg = k0 + lane + 32 * t;
      ks[t] = kv[kg];
      kmul[t] = kv[N + kg];
      kadd[t] = kv[2 * N + kg];
      const int col = kg % W;
      kp[t] = col != W - 1;
      km[t] = col != 0;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = warp * ROWS + r;
      float lg[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        float raw = S[i * LDS + j];
        if (qp[r] && kp[t]) raw += S[(i + 1) * LDS + j + 1];
        if (qm[r] && km[t]) raw += S[(i - 1) * LDS + j - 1];
        lg[t] = (raw - qmul[r] * kmul[t] + qadd[r] + kadd[t]) * qs[r] * ks[t];
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(lg[0], lg[1])));
      const float p0 = expf(lg[0] - m_new), p1 = expf(lg[1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
      P[i * LDS + lane] = p0;
      P[i * LDS + lane + 32] = p1;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();
    for (int j = 0; j < TK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[j * DP + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pr = P[(warp * ROWS + r) * LDS + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pr, vv[c], acc[r][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int q = q0 + warp * ROWS + r;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[(size_t)q * D + d] = acc[r][c] * inv;
    }
    if (lane == 0) lse[q] = m[r] + logf(l[r]);
  }
}

template <int NC>
int launch(const float* f3, const float* g3, const float* v, const float* qv,
           const float* kv, float* o, float* lse, int B, int N, int C3, int D,
           int W, cudaStream_t s) {
  const int smem = (2 * TQ * LDF + 2 * TQ * LDS + TK * 32 * NC) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      shift9_fwd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(N / TQ, B);
  shift9_fwd_kernel<NC><<<grid, NT, smem, s>>>(f3, g3, v, qv, kv, o, lse, N,
                                               C3, D, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cocosnet_shift9_tile() { return TQ; }
extern "C" int cocosnet_shift9_max_d() { return 32 * 8; }

// f3, g3: (B, N, C3), v: (B, N, D), qv: (B, N, 4), kv: (B, 4, N), all f32
// and contiguous; o: (B, N, D), lse: (B, N). N % 64 == 0, 64 % W == 0,
// D <= 256 (the wrapper checks). Returns the cudaError_t of the launch.
extern "C" int cocosnet_shift9_fwd(const void* f3, const void* g3,
                                   const void* v, const void* qv,
                                   const void* kv, void* o, void* lse, int B,
                                   int N, int C3, int D, int W, void* stream) {
  const float* F = static_cast<const float*>(f3);
  const float* G = static_cast<const float*>(g3);
  const float* V = static_cast<const float*>(v);
  const float* QV = static_cast<const float*>(qv);
  const float* KV = static_cast<const float*>(kv);
  float* O = static_cast<float*>(o);
  float* L = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32) {
    case 1: return launch<1>(F, G, V, QV, KV, O, L, B, N, C3, D, W, s);
    case 2: return launch<2>(F, G, V, QV, KV, O, L, B, N, C3, D, W, s);
    case 3: return launch<3>(F, G, V, QV, KV, O, L, B, N, C3, D, W, s);
    case 4: return launch<4>(F, G, V, QV, KV, O, L, B, N, C3, D, W, s);
    case 5: return launch<5>(F, G, V, QV, KV, O, L, B, N, C3, D, W, s);
    case 6: return launch<6>(F, G, V, QV, KV, O, L, B, N, C3, D, W, s);
    case 7: return launch<7>(F, G, V, QV, KV, O, L, B, N, C3, D, W, s);
    case 8: return launch<8>(F, G, V, QV, KV, O, L, B, N, C3, D, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
