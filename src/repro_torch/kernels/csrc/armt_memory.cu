// ARMT associative memory (paper eqs. 3-6): read and delta-rule update,
// for sm_90a. A [N,P,Dv] and z [N,P] are fp32, N = G*batch, phi = DPFP-nu
// of a d_mem-wide row (P = 2*nu*d_mem, d_mem <= 64).
//
// Replaces: repro/kernels/armt_memory.py `armt_read` (Pallas `_read_kernel`)
// and `armt_update` (Pallas `_update_kernel`).
//
// Both start from fp32 projections of the bf16 activations (q = x Wq;
// k = m Wk, the beta logit m Wb, v = m Wv), which the wrappers run on the
// tensor-core grouped-matmul kernel with an fp32 epilogue
// (csrc/grouped_matmul.cu): bf16 x bf16 products are exact in fp32, so the
// projections are the reference's fp32 math up to summation order and the
// largest product (v: 2*M*D*Dv flops per n) leaves the CUDA cores. The
// products with the fp32 state that must stay fp32 (armt_update's phi A and
// phi^T u, armt_read on fp32 activations) run on the CUDA cores in
// register-blocked 128 x 128 tiles, each of the 256 threads holding an 8 x 8
// accumulator fed by float4 reads from shared memory (4 shared loads per 64
// FMAs).
//
// armt_read: out[n,t,:] = phi(q_t) A / (phi(q_t) . z + 1e-6).
//   Bound: 2*T*P*Dv fp32 flops per n against the fp32 CUDA-core rate, above
//   the bytes bound (A, x, out move once).
//   bf16 activations: the output is rounded to bf16 (2^-9), so phi A runs on
//   the tensor cores as a three-term bf16 split, phi_hi A_hi + phi_hi A_lo +
//   phi_lo A_hi (product error ~2^-16): armt_read_split writes [phi_hi |
//   phi_hi | phi_lo] per token (with the fp32 denominator) and [A_hi; A_lo;
//   A_hi] per n, the grouped-matmul kernel multiplies them as one K = 3P
//   product with an fp32 epilogue, and armt_read_finish divides and rounds.
//   fp32 activations: armt_read_kernel, exact fp32, one block per (n, 128
//   tokens, 128 values) with phi computed on chip from q and never stored.
//
// armt_update: A' = A + sum_i beta_i (v_i - vbar_i) phi(k_i)^T,
//   z' = z + sum_i gamma_i phi(k_i), over the M <= 128 memory rows of n.
//   phi(k) for M = 128 x P = 384 is 196,608 bytes in fp32, too close to the
//   227 KB shared-memory limit to keep beside the tiles, so a prep launch
//   (one block per n) writes phi(k), zk = phi . z, beta and gamma to scratch
//   and z'. The main launch runs one block per (n, 128 values): vbar tile =
//   phi A[:, tile] (one 128 x 128 tile, K = P), u = beta (v - vbar / (zk +
//   eps)) kept in shared memory, then A'[:, tile] = A[:, tile] + phi^T u
//   (P / 128 tiles, K = M). Bound: 4*M*P*Dv fp32 flops per n. A'/z' are
//   separate output buffers: blocks read A while others write A'.
#include "common.cuh"

using namespace rk;
typedef __nv_bfloat16 bf16;
typedef long long ll;

namespace {

constexpr float EPS = 1e-6f;
constexpr int TILE = 128, KC = 8, THREADS = 256, LDT = TILE + 4;
constexpr int MAXDM = 64, MAXM = 128;

// acc (rows ty*4+i and 64+ty*4+i, cols tx*4+j and 64+tx*4+j) += sum over k < KC
// of As[k][row] * Bs[k][col]; As/Bs rows are 16-byte aligned.
__device__ __forceinline__ void tile_fma(float (&acc)[8][8], const float* As, int lda,
                                         const float* Bs, int ldb, int ty, int tx) {
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + k * lda + ty * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(As + k * lda + 64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * ldb + tx * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * ldb + 64 + tx * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ int tile_row(int ty, int i) { return (i < 4 ? 0 : 64) + ty * 4 + (i & 3); }
__device__ __forceinline__ int tile_col(int tx, int j) { return (j < 4 ? 0 : 64) + tx * 4 + (j & 3); }

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// ---------------------------------------------------------------- read
__global__ void __launch_bounds__(THREADS)
armt_read_kernel(const float* __restrict__ q, const float* __restrict__ A,
                 const float* __restrict__ z, float* __restrict__ out, int T_, int dm, int P,
                 int Dv) {
  __shared__ float qs[TILE][MAXDM + 1];
  __shared__ __align__(16) float As[KC][LDT];   // phi chunk, [p][token]
  __shared__ __align__(16) float Bs[KC][LDT];   // A chunk, [p][value]
  __shared__ float den[TILE];
  const int v0 = blockIdx.x * TILE, t0 = blockIdx.y * TILE, n = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const float* qn = q + (ll)n * T_ * dm;
  const float* An = A + (ll)n * P * Dv;
  const float* zn = z + (ll)n * P;

  for (int e = tid; e < TILE * dm; e += THREADS) {
    const int t = e / dm, i = e % dm;
    qs[t][i] = t0 + t < T_ ? qn[(ll)(t0 + t) * dm + i] : 0.f;
  }
  __syncthreads();
  for (int t = warp; t < TILE; t += THREADS / 32) {
    float s = 0.f;
    for (int p = lane; p < P; p += 32) s = fmaf(dpfp_at(qs[t], dm, p), zn[p], s);
    s = warp_sum(s);
    if (lane == 0) den[t] = s + EPS;
  }

  float acc[8][8];
  zero(acc);
  for (int p0 = 0; p0 < P; p0 += KC) {
    __syncthreads();
    for (int e = tid; e < KC * TILE; e += THREADS) {
      const int k = e / TILE, c = e % TILE;
      const bool kp = p0 + k < P;
      As[k][c] = kp ? dpfp_at(qs[c], dm, p0 + k) : 0.f;
      Bs[k][c] = kp && v0 + c < Dv ? An[(ll)(p0 + k) * Dv + v0 + c] : 0.f;
    }
    __syncthreads();
    tile_fma(acc, &As[0][0], LDT, &Bs[0][0], LDT, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = tile_row(ty, i);
    if (t0 + t >= T_) continue;
    float* orow = out + ((ll)n * T_ + t0 + t) * Dv;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = v0 + tile_col(tx, j);
      if (c < Dv) orow[c] = acc[i][j] / den[t];
    }
  }
}

// One warp per token: phi(q_t) split into bf16 hi/lo as [hi | hi | lo]
// (3P wide) and den = phi . z + eps in fp32.
__global__ void __launch_bounds__(THREADS)
armt_read_split_phi(const float* __restrict__ q, const float* __restrict__ z,
                    bf16* __restrict__ X, float* __restrict__ den, int T_, int dm, int P) {
  __shared__ float qs[THREADS / 32][MAXDM];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = blockIdx.x * (THREADS / 32) + warp, n = blockIdx.y;
  if (t >= T_) return;
  const float* qrow = q + ((ll)n * T_ + t) * dm;
  for (int i = lane; i < dm; i += 32) qs[warp][i] = qrow[i];
  __syncwarp();
  const float* zn = z + (ll)n * P;
  bf16* xrow = X + ((ll)n * T_ + t) * 3 * P;
  float s = 0.f;
  for (int p = lane; p < P; p += 32) {
    const float f = dpfp_at(qs[warp], dm, p);
    const bf16 hi = __float2bfloat16(f);
    const bf16 lo = __float2bfloat16(f - __bfloat162float(hi));
    xrow[p] = hi;
    xrow[P + p] = hi;
    xrow[2 * P + p] = lo;
    s = fmaf(f, zn[p], s);
  }
  s = warp_sum(s);
  if (lane == 0) den[(ll)n * T_ + t] = s + EPS;
}

// A [N,P,Dv] fp32 -> W [N,3P,Dv] bf16 = [A_hi; A_lo; A_hi]
__global__ void armt_read_split_state(const float* __restrict__ A, bf16* __restrict__ W,
                                      ll pdv, ll total) {
  for (ll e = (ll)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (ll)gridDim.x * blockDim.x) {
    const ll n = e / pdv, r = e - n * pdv;
    const float a = A[e];
    const bf16 hi = __float2bfloat16(a);
    const bf16 lo = __float2bfloat16(a - __bfloat162float(hi));
    bf16* wn = W + n * 3 * pdv;
    wn[r] = hi;
    wn[pdv + r] = lo;
    wn[2 * pdv + r] = hi;
  }
}

// out[n,t,v] = bf16(num[n,t,v] / den[n,t])
__global__ void armt_read_finish(const float* __restrict__ num, const float* __restrict__ den,
                                 bf16* __restrict__ out, int Dv, ll total) {
  for (ll e = (ll)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (ll)gridDim.x * blockDim.x)
    out[e] = __float2bfloat16(num[e] / den[e / Dv]);
}

// ---------------------------------------------------------------- update
// One block per n: phi(k) -> scratch, zk = phi . z, beta = sigmoid(b),
// gamma = 1 - zk / (|phi|^2 + eps) -> aux [3][M], and z' = z + gamma^T phi.
__global__ void __launch_bounds__(THREADS)
armt_update_prep(const float* __restrict__ k, const float* __restrict__ b,
                 const float* __restrict__ z, float* __restrict__ z_out,
                 float* __restrict__ phi, float* __restrict__ aux, int M, int dm, int P) {
  __shared__ float ks[MAXM][MAXDM + 1];
  __shared__ float gam[MAXM];
  const int n = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* zn = z + (ll)n * P;
  for (int e = tid; e < M * dm; e += THREADS) ks[e / dm][e % dm] = k[(ll)n * M * dm + e];
  __syncthreads();
  float* zk_out = aux + (ll)n * 3 * M;
  for (int r = warp; r < M; r += THREADS / 32) {
    float zk = 0.f, nrm = 0.f;
    float* prow = phi + ((ll)n * M + r) * P;
    for (int p = lane; p < P; p += 32) {
      const float f = dpfp_at(ks[r], dm, p);
      prow[p] = f;
      zk = fmaf(f, zn[p], zk);
      nrm = fmaf(f, f, nrm);
    }
    zk = warp_sum(zk);
    nrm = warp_sum(nrm);
    if (lane == 0) {
      const float gamma = 1.f - zk / (nrm + EPS);
      zk_out[r] = zk;
      zk_out[M + r] = 1.f / (1.f + expf(-b[(ll)n * M + r]));
      zk_out[2 * M + r] = gamma;
      gam[r] = gamma;
    }
  }
  __syncthreads();
  for (int p = tid; p < P; p += THREADS) {
    float s = 0.f;
    for (int r = 0; r < M; ++r) s = fmaf(gam[r], dpfp_at(ks[r], dm, p), s);
    z_out[(ll)n * P + p] = zn[p] + s;
  }
}

constexpr int UP_SMEM = (TILE * LDT + 2 * KC * LDT) * (int)sizeof(float);

__global__ void __launch_bounds__(THREADS)
armt_update_main(const float* __restrict__ v, const float* __restrict__ A,
                 float* __restrict__ A_out, const float* __restrict__ phi,
                 const float* __restrict__ aux, int M, int P, int Dv) {
  extern __shared__ __align__(16) float sm[];
  float* us = sm;                      // u [m][value], TILE x LDT
  float* As = us + TILE * LDT;         // KC x LDT
  float* Bs = As + KC * LDT;           // KC x LDT
  const int v0 = blockIdx.x * TILE, n = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* An = A + (ll)n * P * Dv;
  const float* phin = phi + (ll)n * M * P;
  const float* zk = aux + (ll)n * 3 * M;
  const float* beta = zk + M;

  // vbar tile (unnormalised) = phi[m, :] A[:, tile], rows m < 128
  float acc[8][8];
  zero(acc);
  for (int p0 = 0; p0 < P; p0 += KC) {
    __syncthreads();
    for (int e = tid; e < KC * TILE; e += THREADS) {
      const int kk = e % KC, r = e / KC;              // 8 consecutive p per row
      As[kk * LDT + r] = r < M && p0 + kk < P ? phin[(ll)r * P + p0 + kk] : 0.f;
      const int k2 = e / TILE, c = e % TILE;
      Bs[k2 * LDT + c] = p0 + k2 < P && v0 + c < Dv ? An[(ll)(p0 + k2) * Dv + v0 + c] : 0.f;
    }
    __syncthreads();
    tile_fma(acc, As, LDT, Bs, LDT, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tile_row(ty, i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col(tx, j);
      float u = 0.f;
      if (r < M && v0 + c < Dv)
        u = beta[r] * (v[((ll)n * M + r) * Dv + v0 + c] - acc[i][j] / (zk[r] + EPS));
      us[r * LDT + c] = u;
    }
  }

  // A'[p, tile] = A[p, tile] + sum_m phi[m, p] u[m, tile], 128 rows of P at a time
  for (int pc = 0; pc < P; pc += TILE) {
    zero(acc);
    for (int m0 = 0; m0 < M; m0 += KC) {
      __syncthreads();
      for (int e = tid; e < KC * TILE; e += THREADS) {
        const int kk = e / TILE, p = e % TILE;
        As[kk * LDT + p] = m0 + kk < M && pc + p < P ? phin[(ll)(m0 + kk) * P + pc + p] : 0.f;
      }
      __syncthreads();
      tile_fma(acc, As, LDT, us + m0 * LDT, LDT, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = pc + tile_row(ty, i);
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = v0 + tile_col(tx, j);
        if (c < Dv) A_out[((ll)n * P + p) * Dv + c] = An[(ll)p * Dv + c] + acc[i][j];
      }
    }
  }
}

}  // namespace

// fp32 path: q [N,T,dm] fp32 (x Wq); out [N,T,Dv] fp32.
extern "C" int armt_read_launch(const void* q, const void* A, const void* z, void* out,
                                int N, int T, int dm, int P, int Dv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((Dv + TILE - 1) / TILE, (T + TILE - 1) / TILE, N);
  armt_read_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(A),
      static_cast<const float*>(z), static_cast<float*>(out), T, dm, P, Dv);
  return static_cast<int>(cudaGetLastError());
}

// bf16 path, before the product: X [N,T,3P] and W [N,3P,Dv] bf16 split
// operands, den [N,T] fp32.
extern "C" int armt_read_split_launch(const void* q, const void* A, const void* z, void* X,
                                      void* W, void* den, int N, int T, int dm, int P,
                                      int Dv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((T + THREADS / 32 - 1) / (THREADS / 32), N);
  armt_read_split_phi<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(z), static_cast<bf16*>(X),
      static_cast<float*>(den), T, dm, P);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const ll pdv = (ll)P * Dv, total = (ll)N * pdv;
  armt_read_split_state<<<(int)((total + 1023) / 1024), 256, 0, s>>>(
      static_cast<const float*>(A), static_cast<bf16*>(W), pdv, total);
  return static_cast<int>(cudaGetLastError());
}

// bf16 path, after the product: out [N,T,Dv] bf16 = num / den.
extern "C" int armt_read_finish_launch(const void* num, const void* den, void* out, int N,
                                       int T, int Dv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ll total = (ll)N * T * Dv;
  armt_read_finish<<<(int)((total + 1023) / 1024), 256, 0, s>>>(
      static_cast<const float*>(num), static_cast<const float*>(den), static_cast<bf16*>(out),
      Dv, total);
  return static_cast<int>(cudaGetLastError());
}

// k [N,M,dm], b [N,M] (beta logits) and v [N,M,Dv] are the fp32 projections;
// phi [N,M,P] and aux [N,3,M] are fp32 scratch. M <= 128, dm <= 64.
extern "C" int armt_update_launch(const void* k, const void* b, const void* v,
                                  const void* A, const void* z, void* A_out, void* z_out,
                                  void* phi, void* aux, int N, int M, int dm, int P, int Dv,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(armt_update_main, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         UP_SMEM);
    configured = true;
  }
  armt_update_prep<<<N, THREADS, 0, s>>>(
      static_cast<const float*>(k), static_cast<const float*>(b),
      static_cast<const float*>(z), static_cast<float*>(z_out), static_cast<float*>(phi),
      static_cast<float*>(aux), M, dm, P);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Dv + TILE - 1) / TILE, N);
  armt_update_main<<<grid, THREADS, UP_SMEM, s>>>(
      static_cast<const float*>(v), static_cast<const float*>(A), static_cast<float*>(A_out),
      static_cast<const float*>(phi), static_cast<const float*>(aux), M, P, Dv);
  return static_cast<int>(cudaGetLastError());
}
