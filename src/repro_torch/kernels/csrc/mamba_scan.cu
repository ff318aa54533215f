// Mamba-1 selective scan for sm_90a.
//
// Replaces: repro/kernels/mamba_scan.py `mamba_scan` (Pallas `_scan_kernel`).
// For every row n, channel i and token t, in fp32:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   A = -exp(A_log)
//   y_t = h_t . C_t + D * x_t
// x [N,T,dI] (fp32 or bf16) and dt [N,T,dI] (fp32) are read through their
// row and token strides, B/C [N,T,dS] (fp32) through theirs (the model
// passes column slices of the x_proj output), A_log [G,dI,dS] and D [G,dI]
// per group (row n takes group n / (N / G), so one launch covers a whole
// band of the diagonal schedule; G = 1 is the TPU kernel's own signature),
// h0 [N,dI,dS] contiguous. Writes y [N,T,dI] and hT [N,dI,dS], fp32,
// contiguous.
//
// Bound on the H100: each channel-step does dS exponentials and ~4 dS
// flops against 10 bytes of x (bf16), dt and y, so the exponentials on the
// special-function units (16 per clock per SM) and the bytes are the two
// terms. At a full band step of the falcon-mamba prefill (N = 16 rows,
// T = 1024, dI = 8192, dS = 16) that is 2.15 G exponentials, ~0.5 ms at the
// card's boost clock, against ~1.36 GB, ~0.41 ms at 3.35 TB/s. The
// recurrence is serial in t; what this kernel has to hide is the latency
// of each token's loads behind the arithmetic of the ones before it.
//
// Design: one thread per channel keeps its h[dS] and A[dS] in registers for
// the whole sequence, so h never leaves the chip (the TPU kernel's VMEM
// scratch). A block is 128 channels of one row; the grid is (N, dI / 128).
// Tokens go in tiles of TT: B_t/C_t of a tile, shared by all channels of
// the row, are staged in shared memory by cp.async into a double buffer;
// x/dt belong to one channel each, so every thread fetches its own next
// tile into registers (coalesced across the warp) while it scans the
// current one. One __syncthreads per tile. y is written per token,
// coalesced across the block's channels; hT once at the end. Ragged dI is
// handled by clamping the loads of the block's last channels and masking
// their stores; T = 1 (decode) is one partial tile. exp is the accurate
// `expf` (not `__expf`).
#include <math.h>

#include "common.cuh"

using namespace rk;
typedef __nv_bfloat16 bf16;
typedef long long ll;

namespace {

constexpr int THREADS = 128;   // channels of one row per block, one per thread
constexpr int TT = 16;         // tokens per tile

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}

template <typename TX, int DS>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ A_log, const float* __restrict__ Dp,
                  const float* __restrict__ h0, float* __restrict__ y,
                  float* __restrict__ hT, int T, int dI, int rows_per_group, ll sxn,
                  ll sxt, ll sdn, ll sdt, ll sbn, ll sbt, ll scn, ll sct) {
  __shared__ float bc[2][TT][2 * DS];    // [buffer][token][B_t then C_t]
  const int n = blockIdx.x;
  const int i = blockIdx.y * THREADS + threadIdx.x;
  const bool valid = i < dI;
  const int ic = valid ? i : dI - 1;     // clamped channel: loads stay in bounds
  const ll g = n / rows_per_group;

  float A[DS], h[DS];
  const float* al = A_log + (g * dI + ic) * DS;
  const float* hp = h0 + ((ll)n * dI + ic) * DS;
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    A[s] = -expf(al[s]);
    h[s] = hp[s];
  }
  const float Dd = Dp[g * dI + ic];

  const TX* xp = x + (ll)n * sxn + ic;
  const float* dp = dt + (ll)n * sdn + ic;
  const float* bp = Bm + (ll)n * sbn;
  const float* cq = Cm + (ll)n * scn;
  float* yp = y + (ll)n * T * dI + ic;

  // B/C of tokens [t0, t0 + cnt) into bc[buf]: one 4-byte cp.async per value,
  // so any stride and any column offset of the x_proj output is taken
  auto load_bc = [&](int buf, int t0, int cnt) {
    for (int e = threadIdx.x; e < cnt * 2 * DS; e += THREADS) {
      const int t = e / (2 * DS), s = e - t * (2 * DS);
      const float* src = s < DS ? bp + (ll)(t0 + t) * sbt + s
                                : cq + (ll)(t0 + t) * sct + (s - DS);
      cp_async4(&bc[buf][t][s], src);
    }
    cp_async_commit();
  };
  // x/dt of this thread's channel for tokens [t0, t0 + cnt), into registers;
  // converted only when used, so the loads stay in flight meanwhile
  TX xn[TT];
  float dn[TT];
  auto fetch = [&](int t0, int cnt) {
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      if (t < cnt) {
        xn[t] = xp[(ll)(t0 + t) * sxt];
        dn[t] = dp[(ll)(t0 + t) * sdt];
      }
    }
  };

  if (T > 0) {
    load_bc(0, 0, min(TT, T));
    fetch(0, min(TT, T));
  }
  int buf = 0;
  for (int t0 = 0; t0 < T; t0 += TT) {
    const int cnt = min(TT, T - t0);
    TX xc[TT];
    float dc[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      xc[t] = xn[t];
      dc[t] = dn[t];
    }
    cp_async_wait<0>();
    // this tile's B/C have landed, and every thread is done with the other
    // buffer (read by the previous tile), which the next loads overwrite
    __syncthreads();
    if (t0 + TT < T) {
      const int nxt = min(TT, T - t0 - TT);
      load_bc(buf ^ 1, t0 + TT, nxt);
      fetch(t0 + TT, nxt);
    }
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      if (t < cnt) {
        const float xv = to_f(xc[t]), dv = dc[t];
        const float dx = dv * xv;
        float acc = Dd * xv;
#pragma unroll
        for (int s = 0; s < DS; ++s) {
          h[s] = fmaf(expf(dv * A[s]), h[s], dx * bc[buf][t][s]);
          acc = fmaf(h[s], bc[buf][t][DS + s], acc);
        }
        if (valid) yp[(ll)(t0 + t) * dI] = acc;
      }
    }
    buf ^= 1;
  }
  if (valid) {
    float* ho = hT + ((ll)n * dI + i) * DS;
#pragma unroll
    for (int s = 0; s < DS; ++s) ho[s] = h[s];
  }
}

template <typename TX, int DS>
void launch(const void* x, const void* dt, const void* B, const void* C, const void* A_log,
            const void* D, const void* h0, void* y, void* hT, int N, int T, int dI, int G,
            ll sxn, ll sxt, ll sdn, ll sdt, ll sbn, ll sbt, ll scn, ll sct, cudaStream_t s) {
  dim3 grid(N, (dI + THREADS - 1) / THREADS);
  mamba_scan_kernel<TX, DS><<<grid, THREADS, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(A_log),
      static_cast<const float*>(D), static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(hT), T, dI, N / G, sxn, sxt, sdn, sdt, sbn, sbt, scn, sct);
}

template <typename TX>
int dispatch(int dS, const void* x, const void* dt, const void* B, const void* C,
             const void* A_log, const void* D, const void* h0, void* y, void* hT, int N,
             int T, int dI, int G, ll sxn, ll sxt, ll sdn, ll sdt, ll sbn, ll sbt, ll scn,
             ll sct, cudaStream_t s) {
  switch (dS) {
    case 4:
      launch<TX, 4>(x, dt, B, C, A_log, D, h0, y, hT, N, T, dI, G, sxn, sxt, sdn, sdt, sbn,
                    sbt, scn, sct, s);
      return 0;
    case 8:
      launch<TX, 8>(x, dt, B, C, A_log, D, h0, y, hT, N, T, dI, G, sxn, sxt, sdn, sdt, sbn,
                    sbt, scn, sct, s);
      return 0;
    case 16:
      launch<TX, 16>(x, dt, B, C, A_log, D, h0, y, hT, N, T, dI, G, sxn, sxt, sdn, sdt, sbn,
                     sbt, scn, sct, s);
      return 0;
    default:
      return 1;
  }
}

}  // namespace

// x [N,T,dI] through strides (n, t), dtype 0 float32 / 1 bfloat16; dt
// [N,T,dI] fp32 through (n, t); B and C [N,T,dS] fp32 through (n, t); the
// last dim of each is contiguous. A_log [G,dI,dS], D [G,dI], h0 [N,dI,dS]
// fp32 contiguous; y [N,T,dI], hT [N,dI,dS] fp32 contiguous outputs. Needs
// N % G == 0 and dS in {4, 8, 16}.
extern "C" int mamba_scan_launch(const void* x, const void* dt, const void* B,
                                 const void* C, const void* A_log, const void* D,
                                 const void* h0, void* y, void* hT, int N, int T, int dI,
                                 int dS, int G, long long sxn, long long sxt, long long sdn,
                                 long long sdt, long long sbn, long long sbt, long long scn,
                                 long long sct, int dtype, void* stream) {
  if (N <= 0 || dI <= 0 || T < 0 || G <= 0 || N % G != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = dtype == 1
      ? dispatch<bf16>(dS, x, dt, B, C, A_log, D, h0, y, hT, N, T, dI, G, sxn, sxt, sdn,
                       sdt, sbn, sbt, scn, sct, s)
      : dispatch<float>(dS, x, dt, B, C, A_log, D, h0, y, hT, N, T, dI, G, sxn, sxt, sdn,
                        sdt, sbn, sbt, scn, sct, s);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
