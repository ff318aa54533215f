// The backward of the Mamba-1 selective scan (mamba_scan.cu) for sm_90a.
//
// Replaces: XLA's gradient of repro/kernels/mamba_scan.py's `mamba_scan`
// (the reference takes its gradient through the plain scan; the Pallas
// kernel has no backward).
//
// Gradients of the scan of mamba_scan.cu (either form) given dy [N,T,dI]
// (y's dtype) and dhT [N,dI,dS] (fp32, or null for zero), from the
// forward's kept states hs. Every [N,T,.] operand contiguous here. Per row n, channel i
// and state s, with delta the step (the fused form's softplus(dt +
// dt_bias)), e = exp(delta A), h_{t-1} the state before token t and g the
// gradient of the ungated output (dy silu(z) in the fused form), from t =
// T - 1 down:
//   dC_t += g h_t, dD += g x, dh += g C_t, dx = g D + delta sum_s dh B_t,
//   dB_t += dh delta x, d delta = sum_s dh (A e h_{t-1} + x B_t),
//   dA += dh delta e h_{t-1}, then dh <- dh e;
// the fused form's d dt is d delta times sigmoid(dt + dt_bias) (1 past
// softplus's threshold of 20) and dz = dy rnd(y) silu'(z), rnd the
// rounding to x's dtype the forward's gate reads. dA_log = dA A.
// (grad.py's mamba_scan_bwd_plain is the same maths in PyTorch ops.)
//
// Design (simple, not yet fast):
// - One thread per (row, channel), dh[dS], dA[dS] and A'[dS] in registers,
//   a block BTH channels of one row. The chunks between kept states go in
//   reverse. For each, the states at its SUB-token sub-chunk starts are
//   recomputed forward from the kept state into a scratch buffer `mid`
//   [N, chunk / SUB, dS, dI] (coalesced over the channels); then per
//   sub-chunk, in reverse, the SUB states before its tokens are recomputed
//   into registers and the SUB tokens run backward. The recurrence is the
//   forward's instruction for instruction (ex2.approx, the same fma), so
//   the recomputed states are the forward's bits. h_{t-1} is never
//   recovered by dividing by e, which underflows to 0 within a chunk.
// - dB_t and dC_t are sums over the channels: each warp reduce-scatters a
//   token's 2 dS values (one shuffle round per halving), the warps' sums
//   meet in shared memory and the block writes its partial
//   [blocks, N, T, 2 dS]; the caller sums the blocks. dA_log, dD and
//   d dt_bias, sums over rows and tokens, are written per row [N, dI(, dS)]
//   and summed over a group's rows by the caller. No atomics: the bits are
//   the same in every run.
// - B_t and C_t are the same address for every thread of a block: one
//   broadcast load each.
#include <type_traits>

#include "common.cuh"
#include "mamba_scan.cuh"

using namespace rk;
using namespace rk::scan;

namespace {

constexpr int BTH = 128;   // channels of one row per backward block
constexpr int SUB = 4;     // tokens whose states a thread holds in registers

struct BwdArgs {
  const void* x;
  const void* dt;
  const float* B;
  const float* C;
  const float* A_log;
  const float* D;
  const void* dt_bias;
  const void* z;
  const void* dy;
  const float* hs;
  const float* dhT;
  void* dx;
  void* ddt;
  void* dz;
  float* dbc;    // [blocks, N, T, 2 dS]
  float* dA;     // [N, dI, dS]
  float* dD;     // [N, dI]
  float* dbias;  // [N, dI]
  float* dh0;    // [N, dI, dS]
  float* mid;    // [N, chunk / SUB, dS, dI]
  int N, T, dI, rows_per_group, bias_bf16, chunk, nchunks;
};

// The warp's sums of V values a lane (a power of 2, at most 32): after it,
// v[0] of lane l holds the sum over the warp of value l / (32 / V). Each
// halving step sends the half a lane does not keep.
template <int V, int O>
struct ReduceScatter {
  static __device__ __forceinline__ void run(float* v, int lane) {
    constexpr int H = V / 2;
    const bool up = lane & O;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float send = up ? v[j] : v[j + H];
      const float keep = up ? v[j + H] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    ReduceScatter<H, O / 2>::run(v, lane);
  }
};
template <int O>
struct ReduceScatter<1, O> {
  static __device__ __forceinline__ void run(float* v, int lane) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
    ReduceScatter<1, O / 2>::run(v, lane);
  }
};
template <>
struct ReduceScatter<1, 0> {
  static __device__ __forceinline__ void run(float*, int) {}
};

template <typename TX, int DS, bool FUSED>
__global__ void __launch_bounds__(BTH) mamba_scan_bwd_kernel(const BwdArgs a) {
  typedef typename std::conditional<FUSED, TX, float>::type TD;   // dt, d dt
  typedef typename std::conditional<FUSED, TX, float>::type TY;   // y, dy
  constexpr int V = 2 * DS, NW = BTH / 32, LANES = 32 / V;
  constexpr float LN2 = 0.6931471805599453f;
  __shared__ float red[NW][SUB][V];

  const int n = blockIdx.y, i = blockIdx.x * BTH + threadIdx.x;
  const int dI = a.dI, T = a.T, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool valid = i < dI;
  const int ic = valid ? i : dI - 1;    // clamped: loads stay in bounds
  const ll g = n / a.rows_per_group;

  float A2[DS], dh[DS], da[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    A2[s] = -expf(a.A_log[(g * dI + ic) * DS + s]) * LOG2E;
    dh[s] = a.dhT != nullptr ? a.dhT[((ll)n * dI + ic) * DS + s] : 0.f;
    da[s] = 0.f;
  }
  const float Dd = a.D[g * dI + ic];
  float bias = 0.f;
  if (FUSED)
    bias = a.bias_bf16 ? __bfloat162float(static_cast<const bf16*>(a.dt_bias)[g * dI + ic])
                       : static_cast<const float*>(a.dt_bias)[g * dI + ic];
  float dDacc = 0.f, dbacc = 0.f;

  const ll row = (ll)n * T * dI + ic;
  const TX* xp = static_cast<const TX*>(a.x) + row;
  const TD* dp = static_cast<const TD*>(a.dt) + row;
  const TX* zp = FUSED ? static_cast<const TX*>(a.z) + row : nullptr;
  const TY* gp = static_cast<const TY*>(a.dy) + row;
  TX* dxp = static_cast<TX*>(a.dx) + row;
  TD* ddp = static_cast<TD*>(a.ddt) + row;
  TX* dzp = FUSED ? static_cast<TX*>(a.dz) + row : nullptr;
  const float* Bp = a.B + (ll)n * T * DS;
  const float* Cp = a.C + (ll)n * T * DS;
  const int nsub = a.chunk / SUB;
  float* midp = a.mid + (ll)n * nsub * DS * dI + ic;

  // the step size of token t
  auto step_of = [&](int t) {
    return FUSED ? softplus(to_f(dp[(ll)t * dI]) + bias) : to_f(dp[(ll)t * dI]);
  };
  // the forward's recurrence over token t, instruction for instruction
  auto advance = [&](float (&h)[DS], int t) {
    const float xv = to_f(xp[(ll)t * dI]), dv = step_of(t), dx = dv * xv;
#pragma unroll
    for (int s = 0; s < DS; ++s) h[s] = fmaf(ex2_approx(dv * A2[s]), h[s], dx * Bp[t * DS + s]);
  };

  for (int ch = a.nchunks - 1; ch >= 0; --ch) {
    const int c0 = ch * a.chunk, c1 = min(T, c0 + a.chunk);
    const int nk = (c1 - c0 + SUB - 1) / SUB;
    {
      float h[DS];
      const float* hk = a.hs + (((ll)n * a.nchunks + ch) * dI + ic) * DS;
#pragma unroll
      for (int s = 0; s < DS; ++s) h[s] = hk[s];
      for (int k = 0; k < nk; ++k) {
#pragma unroll
        for (int s = 0; s < DS; ++s) midp[((ll)k * DS + s) * dI] = h[s];
        for (int t = c0 + k * SUB; t < min(c1, c0 + (k + 1) * SUB); ++t) advance(h, t);
      }
    }
    for (int k = nk - 1; k >= 0; --k) {
      const int s0 = c0 + k * SUB, cnt = min(SUB, c1 - s0);
      float hb[SUB][DS];   // the state before each token of the sub-chunk
      {
        float h[DS];
#pragma unroll
        for (int s = 0; s < DS; ++s) h[s] = midp[((ll)k * DS + s) * dI];
#pragma unroll
        for (int j = 0; j < SUB; ++j) {
#pragma unroll
          for (int s = 0; s < DS; ++s) hb[j][s] = h[s];
          if (j < cnt) advance(h, s0 + j);
        }
      }
#pragma unroll
      for (int j = SUB - 1; j >= 0; --j) {
        float v[V];   // this channel's parts of dB_t (first dS) and dC_t
#pragma unroll
        for (int s = 0; s < V; ++s) v[s] = 0.f;
        if (j < cnt) {
          const int t = s0 + j;
          const float xv = to_f(xp[(ll)t * dI]);
          const float u = FUSED ? to_f(dp[(ll)t * dI]) + bias : 0.f;
          const float dv = FUSED ? softplus(u) : to_f(dp[(ll)t * dI]);
          const float dxv = dv * xv;
          const float* bt = Bp + t * DS;
          const float* ct = Cp + t * DS;
          float gy = to_f(gp[(ll)t * dI]), gz = 0.f, sz = 0.f, zf = 0.f;
          if (FUSED) {
            zf = to_f(zp[(ll)t * dI]);
            sz = 1.f / (1.f + expf(-zf));
            gz = gy;
            gy = gy * (zf * sz);
          }
          float e[DS], y = 0.f;
#pragma unroll
          for (int s = 0; s < DS; ++s) {
            e[s] = ex2_approx(dv * A2[s]);
            const float ht = fmaf(e[s], hb[j][s], dxv * bt[s]);
            y = fmaf(ht, ct[s], y);
            v[DS + s] = gy * ht;
          }
          dDacc = fmaf(gy, xv, dDacc);
          float dxa = gy * Dd, dd = 0.f;
#pragma unroll
          for (int s = 0; s < DS; ++s) {
            dh[s] = fmaf(gy, ct[s], dh[s]);
            v[s] = dh[s] * dxv;
            dd = fmaf(dh[s], fmaf(A2[s] * LN2 * e[s], hb[j][s], xv * bt[s]), dd);
            dxa = fmaf(dh[s] * dv, bt[s], dxa);
            da[s] = fmaf(dh[s] * dv, e[s] * hb[j][s], da[s]);
            dh[s] *= e[s];
          }
          if (FUSED) {
            dd *= u > 20.f ? 1.f : 1.f / (1.f + expf(-u));
            dbacc += dd;
            const float yr = to_f(from_f<TX>(fmaf(Dd, xv, y)));
            if (valid) dzp[(ll)t * dI] = from_f<TX>(gz * yr * (sz * (1.f + zf * (1.f - sz))));
          }
          if (valid) {
            dxp[(ll)t * dI] = from_f<TX>(dxa);
            ddp[(ll)t * dI] = from_f<TD>(dd);
          }
          if (!valid) {
#pragma unroll
            for (int s = 0; s < V; ++s) v[s] = 0.f;
          }
        }
        ReduceScatter<V, 16>::run(v, lane);
        if (lane % LANES == 0) red[warp][j][lane / LANES] = v[0];
      }
      __syncthreads();
      for (int e = threadIdx.x; e < cnt * V; e += BTH) {
        const int j = e / V, q = e % V;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) sum += red[w][j][q];
        a.dbc[(((ll)blockIdx.x * a.N + n) * T + s0 + j) * V + q] = sum;
      }
      __syncthreads();
    }
  }
  if (valid) {
    const ll o = (ll)n * dI + i;
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      a.dh0[o * DS + s] = dh[s];
      a.dA[o * DS + s] = da[s] * (A2[s] * LN2);
    }
    a.dD[o] = dDacc;
    if (FUSED) a.dbias[o] = dbacc;
  }
}

template <typename TX, int DS>
cudaError_t bwd_by_form(const BwdArgs& a, cudaStream_t s) {
  const dim3 grid((a.dI + BTH - 1) / BTH, a.N);
  if (a.z != nullptr)
    mamba_scan_bwd_kernel<TX, DS, true><<<grid, BTH, 0, s>>>(a);
  else
    mamba_scan_bwd_kernel<TX, DS, false><<<grid, BTH, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t bwd_by_state(int dS, const BwdArgs& a, cudaStream_t s) {
  switch (dS) {
    case 4: return bwd_by_form<TX, 4>(a, s);
    case 8: return bwd_by_form<TX, 8>(a, s);
    case 16: return bwd_by_form<TX, 16>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The backward (see mamba_scan_bwd_kernel). x, dt, z and dy [N,T,dI], B and
// C [N,T,dS], contiguous, in the forward's dtypes (dy: y's); A_log, D,
// dt_bias, dtype and bias_dtype as the forward's; hs the forward's kept
// states at `chunk` (a multiple of 16); dhT [N,dI,dS] fp32 or null (zero).
// Writes dx and dz in x's dtype and ddt in dt's, [N,T,dI]; dbc [ceil(dI /
// 128), N, T, 2 dS] the blocks' partial dB (first dS) and dC; per row
// dA_log [N,dI,dS], dD and d dt_bias [N,dI], dh0 [N,dI,dS], all fp32; mid
// [N, chunk / 4, dS, dI] fp32 is scratch. block and sub: the channels of a
// block (128) and the sub-chunk (4) the caller sized dbc and mid by; the
// launch is refused unless they are this build's BTH and SUB.
extern "C" int mamba_scan_bwd_launch(const void* x, const void* dt, const void* B, const void* C,
                                     const void* A_log, const void* D, const void* dt_bias,
                                     const void* z, const void* dy, const void* hs,
                                     const void* dhT, void* dx, void* ddt, void* dz, void* dbc,
                                     void* dA, void* dD, void* dbias, void* dh0, void* mid,
                                     int N, int T, int dI, int dS, int G, int chunk, int block,
                                     int sub, int dtype, int bias_dtype, void* stream) {
  if (block != BTH || sub != SUB || N <= 0 || dI <= 0 || T <= 0 || G <= 0 || N % G != 0 ||
      (dtype != 0 && dtype != 1) || (bias_dtype != 0 && bias_dtype != 1) ||
      (dt_bias == nullptr) != (z == nullptr) || (z == nullptr) != (dz == nullptr) ||
      (z != nullptr && dbias == nullptr) || chunk <= 0 || chunk % TT != 0 || chunk % SUB != 0 || hs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.x = x;
  a.dt = dt;
  a.B = static_cast<const float*>(B);
  a.C = static_cast<const float*>(C);
  a.A_log = static_cast<const float*>(A_log);
  a.D = static_cast<const float*>(D);
  a.dt_bias = dt_bias;
  a.z = z;
  a.dy = dy;
  a.hs = static_cast<const float*>(hs);
  a.dhT = static_cast<const float*>(dhT);
  a.dx = dx;
  a.ddt = ddt;
  a.dz = dz;
  a.dbc = static_cast<float*>(dbc);
  a.dA = static_cast<float*>(dA);
  a.dD = static_cast<float*>(dD);
  a.dbias = static_cast<float*>(dbias);
  a.dh0 = static_cast<float*>(dh0);
  a.mid = static_cast<float*>(mid);
  a.N = N;
  a.T = T;
  a.dI = dI;
  a.rows_per_group = N / G;
  a.bias_bf16 = bias_dtype;
  a.chunk = chunk;
  a.nchunks = (T + chunk - 1) / chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 1 ? bwd_by_state<bf16>(dS, a, s)
                                     : bwd_by_state<float>(dS, a, s));
}
