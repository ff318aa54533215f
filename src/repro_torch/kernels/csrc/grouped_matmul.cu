// Grouped matmul with a fused bias + activation epilogue, for sm_90a.
//
// Replaces: repro/kernels/grouped_matmul.py `grouped_matmul` (Pallas,
// `_gmm_kernel` / `_gmm_bias_kernel`): out[i] = act(x[i] @ w[i / wbatch] +
// bias[i / wbatch]) (+ res[i]), x [G,R,K] (rows read through group and row
// strides, so the grouped cell's [G,B*T,K] activations need no copy), w
// [G/wbatch,K,N], out [G,R,N] contiguous, in the input dtype or in fp32.
//
// The optional residual res [G,R,N] (read through its strides) is added to
// the fp32 accumulator before the single cast: that is the GEMM half of
// `grouped_matmul_armt_update` (Pallas `_gmm_armt_kernel`), whose y = res +
// x @ w rounds once, where adding res to a bf16 x @ w would round twice.
// The TPU kernel then runs the ARMT update on the memory-token rows of the
// fp32 y tile it holds in VMEM; a [128, 2048] fp32 tile is 1 MB against
// 227 KB of shared memory here, so the port's wrapper runs the update on
// the csrc/armt_memory.cu kernels, reading those rows of y from HBM
// (512 KB of bf16 per group). The ARMT kernels
// use the fp32 output for their projections of bf16 activations: bf16 x bf16
// products are exact in fp32, so that is the reference's fp32 math up to
// summation order.
//
// Bound on the H100: the main-path shapes (R = 1152, K,N in 512..8192, bf16)
// do 2*R*K*N flops per group against ~2*(R*K + K*N + R*N) bytes, i.e.
// several hundred flops per byte, above the card's ~295 flop/byte balance
// point: tensor-core throughput bounds it.
//
// Design: on the TPU, K was a sequential grid axis carrying a VMEM
// accumulator across grid steps; GPU blocks run in no order, so each block
// owns one (g, 128-row, 128-col) output tile and runs the whole K loop
// itself. K tiles of 64 stream through a 3-stage cp.async ring in shared
// memory (105 KB, two blocks per SM); 8 warps (2 x 4) each hold a 64 x 32
// fp32 accumulator fed by ldmatrix + mma.sync m16n8k16 (bf16 in, fp32
// accumulate). A 128 x 256 tile (64 x 64 per warp, 218 registers, one block
// per SM) measured slower on the main-path shapes. Bias and silu / tanh-gelu run on the fp32 accumulator before
// the single store. Ragged R/N/K edges are masked in-kernel (cp.async zero-fill, masked
// stores) instead of padded copies. wgmma/TMA is later work.
//
// fp32 inputs, and bf16 shapes whose K or N is not a multiple of 8 (no
// 16-byte rows), take `gmm_simt`: a 64 x 64 tile of fp32 FMAs per block,
// exact fp32 accumulation.
#include "common.cuh"

using namespace rk;
typedef __nv_bfloat16 bf16;
typedef long long ll;

namespace {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3, THREADS = 256;
constexpr int A_LD = BK + 8;   // 144-byte rows: ldmatrix rows hit distinct banks
constexpr int B_LD = BN + 8;   // 272-byte rows
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr int MMA_SMEM = STAGES * (A_STAGE + B_STAGE) * (int)sizeof(bf16);

__device__ __forceinline__ float epilogue(float v, float b, int act) {
  v += b;
  if (act == 1) {
    v = v / (1.f + expf(-v));                         // silu = v * sigmoid(v)
  } else if (act == 2) {
    const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    v = 0.5f * v * (1.f + tanhf(u));                  // tanh-approximate gelu
  }
  return v;
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS, 2)
gmm_bf16_mma(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const bf16* __restrict__ bias, const bf16* __restrict__ res,
             OutT* __restrict__ out, int R, int K, int N, ll sxg, ll sxr, ll srg,
             ll srr, int wbatch, int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + STAGES * A_STAGE;

  const int g = blockIdx.z, gw = g / wbatch;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bf16* xg = x + (ll)g * sxg;
  const bf16* wg = w + (ll)gw * K * N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;   // warp tile: rows wm*64, cols wn*32

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    bf16* as = As + stage * A_STAGE;
    bf16* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int c = tid; c < BM * (BK / 8); c += THREADS) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int gr = m0 + r, gk = k0 + kc;
      const bool ok = gr < R && gk < K;
      cp_async16(as + r * A_LD + kc, ok ? xg + (ll)gr * sxr + gk : xg, ok);
    }
#pragma unroll
    for (int c = tid; c < BK * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      const bool ok = gk < K && gn < N;
      cp_async16(bs + r * B_LD + nc, ok ? wg + (ll)gk * N + gn : wg, ok);
    }
  };

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pf = kt + STAGES - 1;
    if (pf < nk) load_stage(pf % STAGES, pf);
    cp_async_commit();

    const bf16* as = As + (kt % STAGES) * A_STAGE;
    const bf16* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = wm * 64 + mi * 16 + (lane % 16);
        ldmatrix_x4(af[mi], as + row * A_LD + kk + (lane / 16) * 8);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int krow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int ncol = wn * 32 + nj * 16 + (lane >> 4) * 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + krow * B_LD + ncol);
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + (lane % 4) * 2;
    if (col >= N) continue;                 // N % 8 == 0: col + 1 < N too
    const float b0 = bias ? __bfloat162float(bias[(ll)gw * N + col]) : 0.f;
    const float b1 = bias ? __bfloat162float(bias[(ll)gw * N + col + 1]) : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mi * 16 + lane / 4 + h * 8;
        if (row >= R) continue;
        float r0 = 0.f, r1 = 0.f;
        if (res) {
          const bf16* rp = res + (ll)g * srg + (ll)row * srr + col;
          r0 = __bfloat162float(rp[0]);
          r1 = __bfloat162float(rp[1]);
        }
        store2(out + ((ll)g * R + row) * N + col, epilogue(acc[mi][ni][2 * h], b0, act) + r0,
               epilogue(acc[mi][ni][2 * h + 1], b1, act) + r1);
      }
    }
  }
}

constexpr int TM = 64, TN = 64, TK = 16;

template <typename T, typename OutT>
__global__ void __launch_bounds__(256)
gmm_simt(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
         const T* __restrict__ res, OutT* __restrict__ out, int R, int K, int N, ll sxg,
         ll sxr, ll srg, ll srr, int wbatch, int act) {
  __shared__ float xs[TK][TM + 1];
  __shared__ float ws[TK][TN + 1];
  const int g = blockIdx.z, gw = g / wbatch;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const T* xg = x + (ll)g * sxg;
  const T* wg = w + (ll)gw * K * N;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = tid; e < TM * TK; e += 256) {
      const int r = e / TK, k = e % TK;
      const bool ok = m0 + r < R && k0 + k < K;
      xs[k][r] = ok ? to_f(xg[(ll)(m0 + r) * sxr + k0 + k]) : 0.f;
    }
    for (int e = tid; e < TK * TN; e += 256) {
      const int k = e / TN, n = e % TN;
      const bool ok = k0 + k < K && n0 + n < N;
      ws[k][n] = ok ? to_f(wg[(ll)(k0 + k) * N + n0 + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= N) continue;
      const float b = bias ? to_f(bias[(ll)gw * N + col]) : 0.f;
      const float r = res ? to_f(res[(ll)g * srg + (ll)row * srr + col]) : 0.f;
      out[((ll)g * R + row) * N + col] = from_f<OutT>(epilogue(acc[i][j], b, act) + r);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename OutT>
void launch_mma(const void* x, const void* w, const void* bias, const void* res, void* out,
                int G, int R, int K, int N, ll sxg, ll sxr, ll srg, ll srr, int wbatch,
                int act, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(gmm_bf16_mma<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         MMA_SMEM);
    configured = true;
  }
  dim3 grid((N + BN - 1) / BN, (R + BM - 1) / BM, G);
  gmm_bf16_mma<OutT><<<grid, THREADS, MMA_SMEM, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<const bf16*>(res), static_cast<OutT*>(out),
      R, K, N, sxg, sxr, srg, srr, wbatch, act);
}

template <typename T, typename OutT>
void launch_simt(const void* x, const void* w, const void* bias, const void* res, void* out,
                 int G, int R, int K, int N, ll sxg, ll sxr, ll srg, ll srr, int wbatch,
                 int act, cudaStream_t s) {
  dim3 grid((N + TN - 1) / TN, (R + TM - 1) / TM, G);
  gmm_simt<T, OutT><<<grid, 256, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<const T*>(res), static_cast<OutT*>(out), R, K, N, sxg, sxr, srg, srr,
      wbatch, act);
}

}  // namespace

// x [G,R,K] through (group, row) strides; w [G/wbatch,K,N]; bias [G/wbatch,N]
// or null; res [G,R,N] through (group, row) strides, or null; out [G,R,N].
// dtype: 0 float32, 1 bfloat16 (x, w, bias, res); out_f32: 1 writes fp32,
// 0 the input dtype. act: 0 none, 1 silu, 2 tanh-gelu (applied before res
// is added).
extern "C" int gmm_launch(const void* x, const void* w, const void* bias, const void* res,
                          void* out, int G, int R, int K, int N, long long sxg, long long sxr,
                          long long srg, long long srr, int wbatch, int dtype, int out_f32,
                          int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && K % 8 == 0 && N % 8 == 0 && sxg % 8 == 0 && sxr % 8 == 0 &&
      aligned16(x) && aligned16(w) && aligned16(out)) {
    if (out_f32)
      launch_mma<float>(x, w, bias, res, out, G, R, K, N, sxg, sxr, srg, srr, wbatch, act, s);
    else
      launch_mma<bf16>(x, w, bias, res, out, G, R, K, N, sxg, sxr, srg, srr, wbatch, act, s);
  } else if (dtype == 1) {
    if (out_f32)
      launch_simt<bf16, float>(x, w, bias, res, out, G, R, K, N, sxg, sxr, srg, srr, wbatch,
                               act, s);
    else
      launch_simt<bf16, bf16>(x, w, bias, res, out, G, R, K, N, sxg, sxr, srg, srr, wbatch,
                              act, s);
  } else {
    launch_simt<float, float>(x, w, bias, res, out, G, R, K, N, sxg, sxr, srg, srr, wbatch,
                              act, s);
  }
  return static_cast<int>(cudaGetLastError());
}
