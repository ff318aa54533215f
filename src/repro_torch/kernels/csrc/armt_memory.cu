// ARMT associative memory (paper eqs. 3-6): read and delta-rule update,
// for sm_90a. A [N,P,Dv] and z [N,P] are fp32, N = G*batch, phi = DPFP-nu
// of a d_mem-wide row (P = 2*nu*d_mem, d_mem <= 64).
//
// Replaces: repro/kernels/armt_memory.py `armt_read` (Pallas `_read_kernel`)
// and `armt_update` (Pallas `_update_kernel`).
//
// Both start from fp32 projections of the bf16 activations (q = x Wq;
// k = m Wk, v = m Wv), which the wrappers run on the grouped-matmul kernel's
// TMA + wgmma mainloop with an fp32 epilogue (csrc/grouped_matmul.cu): bf16
// x bf16 products are exact in fp32, so the projections are the reference's
// fp32 math up to summation order.
//
// armt_read: out[n,t,:] = phi(q_t) A / (phi(q_t) . z + 1e-6).
//   Bound: 2*T*P*Dv flops per n, above the bytes bound (A, x, out move once).
//   bf16 activations: the output is rounded to bf16 (2^-9), so phi A runs on
//   the tensor cores as a three-term bf16 split, phi_hi A_hi + phi_hi A_lo +
//   phi_lo A_hi (product error ~2^-16), in two launches after the q
//   projection: armt_read_split (below) writes phi's split, Phi [N,2,T,P]
//   = [phi_hi; phi_lo], with the fp32 denominator, and A's, W [N,2,P,Dv] =
//   [A_hi; A_lo], each once; the grouped-matmul kernel's TMA + wgmma
//   mainloop then walks K over the three terms, loading each term's tiles
//   from the two halves, and divides and rounds in its epilogue
//   (armt_read_gemm_launch in csrc/grouped_matmul.cu). Its k16 steps run in
//   the order of a [phi_hi | phi_hi | phi_lo] x [A_hi; A_lo; A_hi] product of
//   K = 3P, with the division on the fp32 sums, so the output is that
//   product's bit for bit: the untrained model's teacher-forced check pins
//   the last bit. A fused kernel that split A in its mainloop (re-reading
//   A's fp32 rows for every 64 tokens) ran 1.8x longer than this.
//   fp32 activations: armt_read_kernel, exact fp32 on the CUDA cores in
//   register-blocked 128 x 128 tiles (each of 256 threads an 8 x 8
//   accumulator), one block per (n, 128 tokens, 128 values), phi computed
//   on chip from q and never stored.
//
// armt_update: A' = A + sum_i beta_i (v_i - vbar_i) phi(k_i)^T,
//   z' = z + sum_i gamma_i phi(k_i), over the M <= 128 memory rows of n,
//   beta_i = sigmoid(m_i . wb). Bound: 4*M*P*Dv flops per n in the state
//   products (6.4 GFLOP at the llama band step), which must keep the fp32
//   state's accuracy (A'/z' are held at 1e-4). The memory rows m are y's
//   last M rows, which the fused op's GEMM has just written, so they and
//   the 3 MB of phi scratch are read from L2: the cost is launches and
//   arithmetic, not HBM traffic. Two launches after the k and v projections:
//   - armt_update_prep, one warp per memory row over (n, 8-row chunks): the
//     beta logit m_i . wb as a warp dot product (a GEMM of N = 1 would waste
//     a tile), phi(k_i) to scratch (rows padded with zeros to a multiple of
//     the K chunk), zk = phi . z, beta and gamma to aux.
//   - armt_update_main, one block of 16 warps per (n, 128 values): vbar
//     tile = phi A[:, tile] (K = P), u = beta (v - vbar / (zk + eps)) kept
//     in shared memory, then A'[:, tile] = A[:, tile] + phi^T u (P / 128
//     tiles of K = M); the blocks of n share z'. Both products run
//     on the tensor cores as 3xTF32 (each fp32 operand split into tf32 big +
//     small, big*big + big*small + small*big on mma.sync m16n8k8, ~2^-21
//     relative per product, near fp32): wgmma has no transpose mode for
//     tf32, and A (Dv-contiguous) and phi^T are MN-major operands, which
//     mma.sync fragments read from shared memory by index at no cost.
//     K chunks of 32 stream through a 3-stage cp.async ring, one barrier
//     per chunk (177 KB of shared memory with u, one block per SM). A'/z'
//     are separate output buffers: blocks read A while others write A'.
#include "common.cuh"

using namespace rk;
typedef __nv_bfloat16 bf16;
typedef long long ll;

namespace {

constexpr float EPS = 1e-6f;
constexpr int TILE = 128, KC = 8, THREADS = 256, LDT = TILE + 4;
constexpr int MAXDM = 64;

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

// bf16 path, before the product. Blocks [0, phi_blocks) take one token per
// warp: phi(q_t) split into bf16 hi and lo, rows t of Phi[n][0] and
// Phi[n][1] (row stride sp), and den = phi . z + eps in fp32, summed over
// the lanes' p in order, then across the warp. The other blocks split A
// into W[n][0] = A_hi and W[n][1] = A_lo (row stride sw), 4 values a
// thread. Row padding past P and Dv is never read (the product's tensor
// maps stop at P and Dv).
__global__ void __launch_bounds__(THREADS)
armt_read_split(const float* __restrict__ q, const float* __restrict__ A,
                const float* __restrict__ z, bf16* __restrict__ Phi, bf16* __restrict__ W,
                float* __restrict__ den, int N, int T_, int dm, int P, int Dv, ll sp, ll sw,
                int phi_blocks, bool vec) {
  __shared__ float qs[THREADS / 32][MAXDM];
  if ((int)blockIdx.x < phi_blocks) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const ll row = (ll)blockIdx.x * (THREADS / 32) + warp;
    if (row >= (ll)N * T_) return;
    const ll n = row / T_, t = row - n * T_;
    const float* qrow = q + row * dm;
    for (int i = lane; i < dm; i += 32) qs[warp][i] = qrow[i];
    __syncwarp();
    const float* zn = z + n * P;
    bf16* hrow = Phi + (n * 2 * T_ + t) * sp;
    bf16* lrow = hrow + (ll)T_ * sp;
    float s = 0.f;
    for (int p = lane; p < P; p += 32) {
      const float f = dpfp_at(qs[warp], dm, p);
      const bf16 hi = __float2bfloat16(f);
      hrow[p] = hi;
      lrow[p] = __float2bfloat16(f - __bfloat162float(hi));
      s = fmaf(f, zn[p], s);
    }
    s = warp_sum(s);
    if (lane == 0) den[row] = s + EPS;
    return;
  }
  const int nv4 = (Dv + 3) / 4;   // vec: float4 loads (Dv % 4 == 0, A 16-byte aligned)
  const ll total = (ll)N * P * nv4;
  for (ll e = (ll)(blockIdx.x - phi_blocks) * THREADS + threadIdx.x; e < total;
       e += (ll)(gridDim.x - phi_blocks) * THREADS) {
    const ll r = e / nv4, n = r / P, p = r - n * P;
    const int v = (int)(e - r * nv4) * 4;
    const float* src = A + r * Dv + v;
    bf16* hi = W + (n * 2 * P + p) * sw + v;
    bf16* lo = hi + (ll)P * sw;
    if (vec) {
      const float4 a = *reinterpret_cast<const float4*>(src);
      const __nv_bfloat162 h0 = __floats2bfloat162_rn(a.x, a.y);
      const __nv_bfloat162 h1 = __floats2bfloat162_rn(a.z, a.w);
      const __nv_bfloat162 l0 =
          __floats2bfloat162_rn(a.x - __low2float(h0), a.y - __high2float(h0));
      const __nv_bfloat162 l1 =
          __floats2bfloat162_rn(a.z - __low2float(h1), a.w - __high2float(h1));
      *reinterpret_cast<uint2*>(hi) = make_uint2(*reinterpret_cast<const uint32_t*>(&h0),
                                                 *reinterpret_cast<const uint32_t*>(&h1));
      *reinterpret_cast<uint2*>(lo) = make_uint2(*reinterpret_cast<const uint32_t*>(&l0),
                                                 *reinterpret_cast<const uint32_t*>(&l1));
    } else {
      for (int u = 0; u < 4 && v + u < Dv; ++u) {
        const bf16 h = __float2bfloat16(src[u]);
        hi[u] = h;
        lo[u] = __float2bfloat16(src[u] - __bfloat162float(h));
      }
    }
  }
}

// ---------------------------------------------------------------- update
constexpr int UKC = 32;              // K chunk of the state products; phi rows pad to it
constexpr int UT = 128;              // values per block, and rows of A' per pass
constexpr int ULD = UT + 8;          // [k][128] rows: conflict-free fragment reads
constexpr int PLD = UKC + 4;         // [128][k] rows: conflict-free fragment reads
constexpr int USTAGE = UT * PLD + UKC * ULD;
constexpr int USTAGES = 3;           // cp.async ring of K chunks
constexpr int UTHREADS = 512;        // 16 warps as 4 x 4, each a 32 x 32 tile
constexpr int UP_SMEM = (UT * ULD + USTAGES * USTAGE) * (int)sizeof(float);   // 177,152

// grid (N, ceil(M / 8)), one warp per memory row r of n: phi(k_r) -> phi
// [N][M][Pp] (zeros past P), and aux [N][3][M] = (zk = phi . z, beta =
// sigmoid(m_r . wb), gamma = 1 - zk / (|phi|^2 + eps)).
template <typename T>
__global__ void __launch_bounds__(THREADS)
armt_update_prep(const float* __restrict__ k, const T* __restrict__ m,
                 const T* __restrict__ wb, const float* __restrict__ z,
                 float* __restrict__ phi, float* __restrict__ aux, int M, int dm, int P, int Pp,
                 int D, ll smn, ll smr, int wbatch) {
  __shared__ float ks[THREADS / 32][MAXDM];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x, r = blockIdx.y * (THREADS / 32) + warp;
  if (r >= M) return;                       // whole warps: no block barrier below
  const float* krow = k + ((ll)n * M + r) * dm;
  for (int i = lane; i < dm; i += 32) ks[warp][i] = krow[i];
  __syncwarp();
  const T* mrow = m + (ll)n * smn + (ll)r * smr;
  const T* wbn = wb + (ll)(n / wbatch) * D;
  float logit = 0.f;
  for (int d = lane; d < D; d += 32) logit = fmaf(to_f(mrow[d]), to_f(wbn[d]), logit);
  logit = warp_sum(logit);
  const float* zn = z + (ll)n * P;
  float* prow = phi + ((ll)n * M + r) * Pp;
  float zk = 0.f, nrm = 0.f;
  for (int p = lane; p < Pp; p += 32) {
    const float f = p < P ? dpfp_at(ks[warp], dm, p) : 0.f;
    prow[p] = f;
    if (p < P) {
      zk = fmaf(f, zn[p], zk);
      nrm = fmaf(f, f, nrm);
    }
  }
  zk = warp_sum(zk);
  nrm = warp_sum(nrm);
  if (lane == 0) {
    float* a = aux + (ll)n * 3 * M;
    a[r] = zk;
    a[M + r] = 1.f / (1.f + expf(-logit));
    a[2 * M + r] = 1.f - zk / (nrm + EPS);
  }
}

// 3xTF32 on one 8-deep k step of a warp's 32 x 32 tile: acc[mi][ni] += a b,
// a(row, k) = Aop[row * a_rs + k * a_ks], b(k, col) = Bop[k * ULD + col].
__device__ __forceinline__ void mma3_step(float (&acc)[2][4][4], const float* Aop, int a_rs,
                                          int a_ks, const float* Bop, int g, int t) {
  uint32_t bb[4][2], bs[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    split_tf32(Bop[t * ULD + ni * 8 + g], bb[ni][0], bs[ni][0]);
    split_tf32(Bop[(t + 4) * ULD + ni * 8 + g], bb[ni][1], bs[ni][1]);
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const float* a = Aop + (mi * 16 + g) * a_rs + t * a_ks;
    uint32_t ab[4], as[4];
    split_tf32(a[0], ab[0], as[0]);
    split_tf32(a[8 * a_rs], ab[1], as[1]);
    split_tf32(a[4 * a_ks], ab[2], as[2]);
    split_tf32(a[8 * a_rs + 4 * a_ks], ab[3], as[3]);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      mma_tf32(acc[mi][ni], as, bb[ni]);
      mma_tf32(acc[mi][ni], ab, bs[ni]);
      mma_tf32(acc[mi][ni], ab, bb[ni]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// Runs `chunks` K chunks through the USTAGES-deep cp.async ring: load(buf, c)
// issues chunk c's copies into stage buf, compute(buf, c) consumes it. One
// barrier per chunk; the caller's threads must all call it.
template <typename Load, typename Compute>
__device__ __forceinline__ void ring(int chunks, float* stages, Load load, Compute compute) {
#pragma unroll
  for (int c = 0; c < USTAGES - 1; ++c) {
    if (c < chunks) load(stages + c * USTAGE, c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<USTAGES - 2>();
    __syncthreads();             // chunk c is in; every thread is done with chunk c - 1
    const int next = c + USTAGES - 1;
    if (next < chunks) load(stages + (next % USTAGES) * USTAGE, next);
    cp_async_commit();
    compute(stages + (c % USTAGES) * USTAGE, c);
  }
  cp_async_wait<0>();
  __syncthreads();               // the stages are free again
}

// grid (ceil(Dv / 128), N), 16 warps as 4 x 4, each a 32 x 32 tile. VEC 4:
// A's rows are 16-byte aligned (Dv % 4 == 0) and load by 16-byte copies.
template <int VEC>
__global__ void __launch_bounds__(UTHREADS, 1)
armt_update_main(const float* __restrict__ v, const float* __restrict__ A,
                 const float* __restrict__ z, float* __restrict__ A_out,
                 float* __restrict__ z_out, const float* __restrict__ phi,
                 const float* __restrict__ aux, int M, int P, int Pp, int Dv) {
  extern __shared__ __align__(16) float sm[];
  float* us = sm;                      // u [m][value], UT x ULD
  float* stages = us + UT * ULD;       // the ring of K chunks
  const int v0 = blockIdx.x * UT, n = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4, g = lane / 4, t = lane % 4;
  const float* An = A + (ll)n * P * Dv;
  const float* phin = phi + (ll)n * M * Pp;
  const float* zk = aux + (ll)n * 3 * M;
  const float* beta = zk + M;
  const float* gam = zk + 2 * M;

  // z' = z + gamma^T phi, summed over the rows in order (the order of the
  // plain version); the blocks of n take every gridDim.x-th p
  for (int p = blockIdx.x + tid * gridDim.x; p < P; p += UTHREADS * gridDim.x) {
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < M; ++r) s = fmaf(gam[r], phin[(ll)r * Pp + p], s);
    z_out[(ll)n * P + p] = z[(ll)n * P + p] + s;
  }

  // vbar tile (unnormalised) = phi[m, :] A[:, tile], rows m < 128, K = Pp:
  // a stage holds the phi chunk [m][UKC] and the A chunk [UKC][value]
  float acc[2][4][4];
  zero(acc);
  ring(
      Pp / UKC, stages,
      [&](float* Ps, int c) {
        const int p0 = c * UKC;
        float* Bs = Ps + UT * PLD;
        for (int e = tid; e < UT * UKC / 4; e += UTHREADS) {
          const int r = e / (UKC / 4), kc = (e % (UKC / 4)) * 4;
          const bool ok = r < M;
          cp_async16(Ps + r * PLD + kc, ok ? phin + (ll)r * Pp + p0 + kc : phin, ok);
        }
        if (VEC == 4) {
          for (int e = tid; e < UKC * UT / 4; e += UTHREADS) {
            const int r = e / (UT / 4), cc = (e % (UT / 4)) * 4;
            const bool ok = p0 + r < P && v0 + cc < Dv;
            cp_async16(Bs + r * ULD + cc, ok ? An + (ll)(p0 + r) * Dv + v0 + cc : An, ok);
          }
        } else {
          for (int e = tid; e < UKC * UT; e += UTHREADS) {
            const int r = e / UT, cc = e % UT;
            const bool ok = p0 + r < P && v0 + cc < Dv;
            cp_async4(Bs + r * ULD + cc, ok ? An + (ll)(p0 + r) * Dv + v0 + cc : An, ok);
          }
        }
      },
      [&](const float* Ps, int) {
#pragma unroll
        for (int kk = 0; kk < UKC; kk += 8)
          mma3_step(acc, Ps + (wm * 32) * PLD + kk, PLD, 1, Ps + UT * PLD + kk * ULD + wn * 32,
                    g, t);
      });

  // u = beta (v - vbar / (zk + eps)), zero past M and Dv
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm * 32 + mi * 16 + g + (e >= 2 ? 8 : 0);
        const int c = wn * 32 + ni * 8 + 2 * t + (e & 1);
        float u = 0.f;
        if (r < M && v0 + c < Dv)
          u = beta[r] * (v[((ll)n * M + r) * Dv + v0 + c] - acc[mi][ni][e] / (zk[r] + EPS));
        us[r * ULD + c] = u;
      }
  __syncthreads();

  // A'[p, tile] = A[p, tile] + sum_m phi[m, p] u[m, tile], 128 rows of P a
  // pass: a stage holds the phi chunk [UKC m][128 p]
  for (int pc = 0; pc < P; pc += UT) {
    zero(acc);
    ring(
        (M + UKC - 1) / UKC, stages,
        [&](float* Qs, int c) {
          const int m0 = c * UKC;
          for (int e = tid; e < UKC * UT / 4; e += UTHREADS) {
            const int r = e / (UT / 4), cc = (e % (UT / 4)) * 4;
            const bool ok = m0 + r < M && pc + cc < Pp;
            cp_async16(Qs + r * ULD + cc, ok ? phin + (ll)(m0 + r) * Pp + pc + cc : phin, ok);
          }
        },
        [&](const float* Qs, int c) {
#pragma unroll
          for (int kk = 0; kk < UKC; kk += 8)
            mma3_step(acc, Qs + kk * ULD + wm * 32, 1, ULD, us + (c * UKC + kk) * ULD + wn * 32,
                      g, t);
        });
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int p = pc + wm * 32 + mi * 16 + g + 8 * e2;
        if (p >= P) continue;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = v0 + wn * 32 + ni * 8 + 2 * t + e;
            if (c < Dv)
              A_out[((ll)n * P + p) * Dv + c] = An[(ll)p * Dv + c] + acc[mi][ni][2 * e2 + e];
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

// bf16 path, before the product: Phi [N,2,T,sp] and W [N,2,P,sw] bf16
// split operands (sp >= P, sw >= Dv), den [N,T] fp32. One launch.
extern "C" int armt_read_split_launch(const void* q, const void* A, const void* z, void* Phi,
                                      void* W, void* den, int N, int T, int dm, int P, int Dv,
                                      long long sp, long long sw, void* stream) {
  if (dm > MAXDM || sp < P || sw < Dv) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int phi_blocks = (int)(((ll)N * T + THREADS / 32 - 1) / (THREADS / 32));
  const ll quads = (ll)N * P * ((Dv + 3) / 4);
  const ll want = (quads + THREADS - 1) / THREADS, cap = 16LL * sm_count();
  const int a_blocks = (int)(want < cap ? want : cap);
  if (phi_blocks + a_blocks == 0) return 0;
  armt_read_split<<<phi_blocks + a_blocks, THREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(A), static_cast<const float*>(z),
      static_cast<bf16*>(Phi), static_cast<bf16*>(W), static_cast<float*>(den), N, T, dm, P, Dv,
      sp, sw, phi_blocks, Dv % 4 == 0 && aligned16(A));
  return static_cast<int>(cudaGetLastError());
}

// k [N,M,dm] and v [N,M,Dv] are the fp32 projections of the memory rows m
// [N,M,D] (read through their (n, row) strides; dtype 0 float32, 1
// bfloat16, as wb [G,D] with G = N / wbatch); phi [N,M,Pp] and aux [N,3,M]
// are fp32 scratch, Pp >= P a multiple of the K chunk (32; refused with
// cudaErrorInvalidValue otherwise). M <= 128, dm <= 64.
extern "C" int armt_update_launch(const void* k, const void* v, const void* m, const void* wb,
                                  const void* A, const void* z, void* A_out, void* z_out,
                                  void* phi, void* aux, int N, int M, int dm, int P, int Pp,
                                  int Dv, int D, long long smn, long long smr, int wbatch,
                                  int dtype, void* stream) {
  if (Pp < P || Pp % UKC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(armt_update_main<4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         UP_SMEM);
    cudaFuncSetAttribute(armt_update_main<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         UP_SMEM);
    configured = true;
  }
  const dim3 pgrid(N, (M + THREADS / 32 - 1) / (THREADS / 32));
  if (dtype == 1)
    armt_update_prep<bf16><<<pgrid, THREADS, 0, s>>>(
        static_cast<const float*>(k), static_cast<const bf16*>(m), static_cast<const bf16*>(wb),
        static_cast<const float*>(z), static_cast<float*>(phi), static_cast<float*>(aux), M, dm,
        P, Pp, D, smn, smr, wbatch);
  else
    armt_update_prep<float><<<pgrid, THREADS, 0, s>>>(
        static_cast<const float*>(k), static_cast<const float*>(m),
        static_cast<const float*>(wb), static_cast<const float*>(z), static_cast<float*>(phi),
        static_cast<float*>(aux), M, dm, P, Pp, D, smn, smr, wbatch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Dv + UT - 1) / UT, N);
  if (Dv % 4 == 0 && aligned16(A))
    armt_update_main<4><<<grid, UTHREADS, UP_SMEM, s>>>(
        static_cast<const float*>(v), static_cast<const float*>(A), static_cast<const float*>(z),
        static_cast<float*>(A_out), static_cast<float*>(z_out), static_cast<const float*>(phi),
        static_cast<const float*>(aux), M, P, Pp, Dv);
  else
    armt_update_main<1><<<grid, UTHREADS, UP_SMEM, s>>>(
        static_cast<const float*>(v), static_cast<const float*>(A), static_cast<const float*>(z),
        static_cast<float*>(A_out), static_cast<float*>(z_out), static_cast<const float*>(phi),
        static_cast<const float*>(aux), M, P, Pp, Dv);
  return static_cast<int>(cudaGetLastError());
}
