// Backward of the fused 3x3-unfold correlation, softmax and warp, f32.
//
// Replaces: cocosnet_tpu/ops/pallas_shift9.py `_bwd`, its two passes
// `_dq_kernel` (query side) and `_dk_kernel` (key side).
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
// Bound on the H100: operations. Each pass recomputes S3 and dP and forms
// one product with dS3: 2 B N^2 (2 3C + D) flops per pass, plus P^T gO in
// the key pass, 2 B N^2 (4 3C + 3 D) in all (949 GFLOP at B=8, N=4096,
// 3C=768, D=154), against O(B N (3C + D)) bytes. As in the forward, tau =
// 0.01 amplifies logit error 100x, so every product is f32 FMA and the
// bound is the card's f32 rate.
//
// Design: the two passes are one kernel. The logits are symmetric in the
// two sides (raw - mul_q mul_k + add_q + add_k) s_q s_k, and so are the
// shifts, so a block owns a tile of 28 positions of one side (queries in
// the query pass, keys in the key pass) and walks tiles of 60 positions of
// the other side. The owner's gradient rows (dF3 or dG3, its three rank-1
// gradients, and dV in the key pass) accumulate in shared memory and are
// written once at the end: no atomics, deterministic results. da is needed
// one position beyond the tile (the shifts of dS3) and the logits there one
// position further (the shifts of raw), so S3 and dP are computed on the
// tile plus a two-position halo each side (32 x 64, 2 x 4 per thread); as
// in the forward, halo positions past a row end are exactly the masked
// ones, and positions outside [0, N) load as zeros and carry no gradient,
// so every image width W works. The products with dS3 (and P) update 7 x 2
// register tiles from 128-column chunks of the streamed rows; every staged
// chunk is fetched into registers while the one before it is multiplied.
// A simple kernel all the same: no tensor cores, no TMA, operands re-read
// from L2, one block per SM, 22% of S3 spent on the halo.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int HR = 32;          // owner tile rows with the halo
constexpr int HC = 64;          // streamed tile columns with the halo
constexpr int OWN = HR - 4;     // owner positions a block writes
constexpr int STR = HC - 4;     // streamed positions per step
constexpr int KC = 32;          // contraction chunk of the region products
constexpr int CW = 128;         // output column chunk of the row updates
constexpr int RG = 7;           // owner rows per thread in the row updates
constexpr int NT = 256;
constexpr int LDA = HR + 2;     // k-major staging, float2 rows
constexpr int LDB = HC + 4;     // k-major staging, float4 columns
constexpr int LDS = HC + 4;     // region matrices, float4 rows
// scratch shared by the region products' staging and the row updates'
constexpr int SCR = (KC * LDA + KC * LDB > STR * CW) ? KC * LDA + KC * LDB
                                                     : STR * CW;
static_assert(OWN == 4 * RG, "four row groups of RG rows cover the tile");
static_assert(STR % 4 == 0, "the row updates read M four columns at once");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ int col_of(int pos, int W) {
  return ((pos % W) + W) % W;
}
__device__ __forceinline__ bool plus_ok(int pos, int W) {  // dx = +1 valid
  return col_of(pos, W) != W - 1;
}
__device__ __forceinline__ bool minus_ok(int pos, int W) {  // dx = -1 valid
  return col_of(pos, W) != 0;
}

// out[a][b] = sum_k Xa[A0 + a][k] Xb[B0 + b][k] over the region (HR x HC),
// rows of width K; positions outside [0, N) read as zeros. Chunks of KC
// columns are staged k-major; each thread owns rows 2 ty, 2 ty + 1 and
// columns 4 tx .. 4 tx + 3 and reads them as one float2 and one float4.
__device__ __forceinline__ void region_product(
    const float* __restrict__ xa, const float* __restrict__ xb, int A0,
    int B0, int N, int K, float* scratch, float* out) {
  float* At = scratch;             // [KC][LDA]
  float* Bt = scratch + KC * LDA;  // [KC][LDB]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float s[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  constexpr int PA = HR * KC / NT, PB = HC * KC / NT;
  const int kk = tid % KC, row0 = tid / KC;  // element tid + NT i
  float ra[PA], rb[PB];
  auto fetch = [&](int c0) {
    const int c = c0 + kk;
#pragma unroll
    for (int i = 0; i < PA; ++i) {
      const int p = A0 + row0 + (NT / KC) * i;
      ra[i] = (c < K && p >= 0 && p < N) ? xa[(size_t)p * K + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < PB; ++i) {
      const int p = B0 + row0 + (NT / KC) * i;
      rb[i] = (c < K && p >= 0 && p < N) ? xb[(size_t)p * K + c] : 0.f;
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

// acc[ai][c] += sum_bb M[ai][bb] Y[Bc + bb][c] for the OWN x STR matrix M
// (leading dimension LDS) and the STR streamed core rows of Y (width K).
// Chunks of CW columns of Y are staged; warp w owns rows RG (w / 2) ..
// RG (w / 2) + RG - 1 (M read as warp-wide float4 broadcasts) and each lane
// the columns (w % 2) 64 + lane and + 32 of the chunk.
__device__ __forceinline__ void accumulate_rows(
    const float* __restrict__ y, const float* M, int Bc, int N, int K,
    float* Ys, float* acc) {
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
      const int row = e / CW, c = c0 + e % CW, p = Bc + row;
      ry[i] = (c < K && p < N) ? y[(size_t)p * K + c] : 0.f;
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
        m[i] = *reinterpret_cast<const float4*>(&M[(r0 + i) * LDS + bb]);
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
        if (c < K) acc[(r0 + i) * K + c] += s[i][h];
      }
    __syncthreads();
  }
}

// One pass. QROW: the owner side is the queries (the dq pass), else the
// keys (the dk pass, which also forms dV). xa/wa/va are the owner side's
// 3C features (F3 or G3), value-side vectors (gO or V, width D) and rank-1
// terms (s, mul, add, add2 per position); xb/wb/vb the streamed side's.
// lse and dd belong to the queries.
template <bool QROW>
__global__ void __launch_bounds__(NT)
    shift9_bwd_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                      const float* __restrict__ wa, const float* __restrict__ wb,
                      const float* __restrict__ va, const float* __restrict__ vb,
                      const float* __restrict__ lse, const float* __restrict__ dd,
                      float* __restrict__ dx, float* __restrict__ dvec,
                      float* __restrict__ dv, int N, int C3, int D, int W) {
  extern __shared__ __align__(16) float sm[];
  float* scratch = sm;               // [SCR]: staging
  float* Sm = scratch + SCR;         // [HR][LDS]: S3, then dS3 (core)
  float* Dm = Sm + HR * LDS;         // [HR][LDS]: dP, then da
  float* Pm = Dm + HR * LDS;         // [OWN][LDS]: P (core), key pass
  float* stats = Pm + HR * LDS;      // [OWN][3]
  float* dxs = stats + OWN * 3;      // [OWN][C3]
  float* dvs = dxs + OWN * C3;       // [OWN][D], key pass

  const int b = blockIdx.y;
  const int A0 = blockIdx.x * OWN - 2;  // global position of region row 0
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const size_t off3 = (size_t)b * N * C3, offd = (size_t)b * N * D;
  xa += off3;
  xb += off3;
  wa += offd;
  wb += offd;
  va += (size_t)b * N * 4;
  vb += (size_t)b * N * 4;
  lse += (size_t)b * N;
  dd += (size_t)b * N;
  dx += off3;
  dvec += (size_t)b * N * 3;
  if (!QROW) dv += offd;

  for (int e = tid; e < OWN * 3; e += NT) stats[e] = 0.f;
  for (int e = tid; e < OWN * C3; e += NT) dxs[e] = 0.f;
  if (!QROW)
    for (int e = tid; e < OWN * D; e += NT) dvs[e] = 0.f;

  // the rows this warp turns into logits: region rows 1 + warp + 8 r
  float rs_[4], rmul[4], radd[4], rlse[4], rdd[4];
  bool rvalid[4], rp[4], rm[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int a = 1 + warp + 8 * r;
    const int ga = A0 + a;
    rvalid[r] = a <= HR - 2 && ga >= 0 && ga < N;
    rs_[r] = rvalid[r] ? va[ga * 4 + 0] : 0.f;
    rmul[r] = rvalid[r] ? va[ga * 4 + 1] : 0.f;
    radd[r] = rvalid[r] ? va[ga * 4 + 2] + va[ga * 4 + 3] : 0.f;
    rlse[r] = (QROW && rvalid[r]) ? lse[ga] : 0.f;
    rdd[r] = (QROW && rvalid[r]) ? dd[ga] : 0.f;
    rp[r] = plus_ok(ga, W);
    rm[r] = minus_ok(ga, W);
  }
  __syncthreads();

  for (int t = 0; t * STR < N; ++t) {
    const int B0 = t * STR - 2;  // global position of region column 0
    region_product(xa, xb, A0, B0, N, C3, scratch, Sm);
    region_product(wa, wb, A0, B0, N, D, scratch, Dm);
    __syncthreads();

    // logits, P and da on the tile plus a one-position halo; row sums of
    // the owner's rank-1 gradients over the streamed core
    float cs[2], cmul[2], cadd[2], clse[2], cdd[2];
    bool cvalid[2], cp[2], cm[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int bcol = 1 + lane + 32 * u;
      const int gb = B0 + bcol;
      cvalid[u] = bcol <= HC - 2 && gb >= 0 && gb < N;
      cs[u] = cvalid[u] ? vb[gb * 4 + 0] : 0.f;
      cmul[u] = cvalid[u] ? vb[gb * 4 + 1] : 0.f;
      cadd[u] = cvalid[u] ? vb[gb * 4 + 2] + vb[gb * 4 + 3] : 0.f;
      clse[u] = (!QROW && cvalid[u]) ? lse[gb] : 0.f;
      cdd[u] = (!QROW && cvalid[u]) ? dd[gb] : 0.f;
      cp[u] = plus_ok(gb, W);
      cm[u] = minus_ok(gb, W);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int a = 1 + warp + 8 * r;
      if (a > HR - 2) continue;  // warp-uniform
      const bool core_row = a >= 2 && a <= HR - 3;
      float sg = 0.f, sm_ = 0.f, sa = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int bcol = 1 + lane + 32 * u;
        if (bcol > HC - 2) continue;
        const bool valid = rvalid[r] && cvalid[u];
        float p = 0.f, gl = 0.f, da = 0.f, logit = 0.f;
        if (valid) {
          float raw = Sm[a * LDS + bcol];
          if (rp[r] && cp[u]) raw += Sm[(a + 1) * LDS + bcol + 1];
          if (rm[r] && cm[u]) raw += Sm[(a - 1) * LDS + bcol - 1];
          logit = (raw - rmul[r] * cmul[u] + radd[r] + cadd[u]) * rs_[r] * cs[u];
          const float l = QROW ? rlse[r] : clse[u];
          const float d = QROW ? rdd[r] : cdd[u];
          p = expf(logit - l);
          gl = p * (Dm[a * LDS + bcol] - d);
          da = gl * rs_[r] * cs[u];
        }
        Dm[a * LDS + bcol] = da;
        const bool core = core_row && bcol >= 2 && bcol <= HC - 3;
        if (core) {
          if (!QROW) Pm[(a - 2) * LDS + bcol - 2] = p;
          sg += gl * logit;
          sm_ += da * cmul[u];
          sa += da;
        }
      }
      if (core_row) {  // warp-uniform
        sg = warp_sum(sg);
        sm_ = warp_sum(sm_);
        sa = warp_sum(sa);
        if (lane == 0 && rvalid[r]) {
          stats[(a - 2) * 3 + 0] += sg / rs_[r];
          stats[(a - 2) * 3 + 1] -= sm_;
          stats[(a - 2) * 3 + 2] += sa;
        }
      }
    }
    __syncthreads();

    // dS3 on the core: da plus its two masked diagonal neighbours
    for (int e = tid; e < OWN * STR; e += NT) {
      const int ai = e / STR, bi = e % STR;
      const int a = ai + 2, bcol = bi + 2;
      const int ga = A0 + a, gb = B0 + bcol;
      float ds = Dm[a * LDS + bcol];
      if (plus_ok(ga - 1, W) && plus_ok(gb - 1, W))
        ds += Dm[(a - 1) * LDS + bcol - 1];
      if (minus_ok(ga + 1, W) && minus_ok(gb + 1, W))
        ds += Dm[(a + 1) * LDS + bcol + 1];
      Sm[ai * LDS + bi] = ds;
    }
    __syncthreads();

    accumulate_rows(xb, Sm, B0 + 2, N, C3, scratch, dxs);
    if (!QROW) accumulate_rows(wb, Pm, B0 + 2, N, D, scratch, dvs);
  }

  for (int e = tid; e < OWN * C3; e += NT) {
    const int ga = A0 + 2 + e / C3;
    if (ga < N) dx[(size_t)ga * C3 + e % C3] = dxs[e];
  }
  for (int e = tid; e < OWN * 3; e += NT) {
    const int ga = A0 + 2 + e / 3;
    if (ga < N) dvec[(size_t)ga * 3 + e % 3] = stats[e];
  }
  if (!QROW)
    for (int e = tid; e < OWN * D; e += NT) {
      const int ga = A0 + 2 + e / D;
      if (ga < N) dv[(size_t)ga * D + e % D] = dvs[e];
    }
}

int smem_bytes(int C3, int D, bool qrow) {
  return 4 * (SCR + 3 * HR * LDS + OWN * 3 + OWN * C3 +
              (qrow ? 0 : OWN * D));
}

template <bool QROW>
int launch(const float* xa, const float* xb, const float* wa, const float* wb,
           const float* va, const float* vb, const float* lse, const float* dd,
           float* dx, float* dvec, float* dv, int B, int N, int C3, int D,
           int W, cudaStream_t s) {
  const int smem = smem_bytes(C3, D, QROW);
  cudaError_t e = cudaFuncSetAttribute(
      shift9_bwd_kernel<QROW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + OWN - 1) / OWN, B);
  shift9_bwd_kernel<QROW><<<grid, NT, smem, s>>>(xa, xb, wa, wb, va, vb, lse,
                                                 dd, dx, dvec, dv, N, C3, D, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory (bytes) a pass needs for 3C = C3 and D; the wrapper checks
// it against the card's per-block limit.
extern "C" int cocosnet_shift9_bwd_smem(int C3, int D) {
  return smem_bytes(C3, D, false);
}

// f3, g3: (B, N, C3); v, go: (B, N, D); qv, kvt: (B, N, 4) rank-1 terms per
// position (s, mul, add, add2; kvt is kv transposed with its zero row);
// lse, dd: (B, N). Outputs df3, dg3: (B, N, C3); dq3, dk3: (B, N, 3)
// (ds, dmul, dadd); dv: (B, N, D). All f32 and contiguous. Launches the
// query pass, then the key pass, on `stream`; returns the first
// cudaError_t that is not success.
extern "C" int cocosnet_shift9_bwd(const void* f3, const void* g3,
                                   const void* v, const void* go,
                                   const void* qv, const void* kvt,
                                   const void* lse, const void* dd, void* df3,
                                   void* dq3, void* dg3, void* dk3, void* dv,
                                   int B, int N, int C3, int D, int W,
                                   void* stream) {
  const float* F = static_cast<const float*>(f3);
  const float* G = static_cast<const float*>(g3);
  const float* V = static_cast<const float*>(v);
  const float* GO = static_cast<const float*>(go);
  const float* QV = static_cast<const float*>(qv);
  const float* KV = static_cast<const float*>(kvt);
  const float* L = static_cast<const float*>(lse);
  const float* DD = static_cast<const float*>(dd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = launch<true>(F, G, GO, V, QV, KV, L, DD, static_cast<float*>(df3),
                         static_cast<float*>(dq3), nullptr, B, N, C3, D, W, s);
  if (err != 0) return err;
  return launch<false>(G, F, V, GO, KV, QV, L, DD, static_cast<float*>(dg3),
                       static_cast<float*>(dk3), static_cast<float*>(dv), B, N,
                       C3, D, W, s);
}
