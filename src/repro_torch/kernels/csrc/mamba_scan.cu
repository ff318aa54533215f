// Mamba-1 selective scan for sm_90a, with the dt prologue and the gate
// epilogue of the mixer taken in.
//
// Replaces: repro/kernels/mamba_scan.py `mamba_scan` (Pallas `_scan_kernel`).
// For every row n, channel i and token t, in fp32:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   A = -exp(A_log)
//   y_t = h_t . C_t + D * x_t
// x [N,T,dI] (fp32 or bf16) and dt [N,T,dI] are read through their row and
// token strides, B/C [N,T,dS] (fp32) through theirs (the model passes column
// slices of the x_proj output), A_log [G,dI,dS] and D [G,dI] per group (row
// n takes group n / (N / G), so one launch covers a whole band of the
// diagonal schedule; G = 1 is the TPU kernel's own signature), h0
// [N,dI,dS] contiguous. Writes hT [N,dI,dS] fp32 and y [N,T,dI] contiguous.
// The fused form (dt_bias and z given together) takes in the mixer's work
// around the scan, which PyTorch would run as separate elementwise passes
// over [N,T,dI]:
//   - dt prologue (dt_bias [G,dI], fp32 or x's dtype): dt is the raw
//     dt_proj output in x's dtype, and the scan uses softplus(dt + dt_bias)
//     in fp32 with F.softplus's formula (u > 20 ? u : log1p(exp(u)));
//   - gate epilogue (z [N,T,dI] in x's dtype, read through its strides):
//     y is written in x's dtype as rnd(rnd(y) * rnd(silu(z))), rnd the
//     rounding to x's dtype, silu(z) = z / (1 + exp(-z)): PyTorch eager's
//     roundings in the mixer's order (models/mamba.py).
// Without them the function is the TPU kernel's: dt fp32 (post-softplus),
// y fp32. A call with one of the two is refused.
//
// Under gradients the forward also keeps the state before every chunk-th
// token, hs [N, ceil(T / chunk), dI, dS] fp32, and `mamba_scan_bwd_kernel`
// (mamba_scan_bwd.cu) runs the reverse scan from those states.
//
// Bound on the H100: each channel-step does dS exponentials and ~4 dS fp32
// operations. At a full band step of the falcon-mamba prefill (N = 16
// rows, T = 1024, dI = 8192, dS = 16: 134 M channel-steps) the 2.15 G
// exponentials on the special-function units (16 a clock per SM) take
// ~0.51 ms at the card's boost clock; the bytes, 10 a channel-step
// unfused (x bf16, dt fp32, y fp32) or 8 fused (x, raw dt, z and y in bf16),
// take 0.41 or 0.32 ms at 3.35 TB/s. The recurrence is serial in t.
//
// Design:
// - exp(dt * A) = ex2.approx(dt * A'), A' = A * log2(e) computed once per
//   thread: one FMUL and one MUFU op a state, where the accurate expf took
//   several FP32 instructions besides its MUFU op (the `expf` variant of
//   tools/kernel_variants.py runs 1.6x longer).
// - One thread per channel keeps its h[dS] and A'[dS] in registers for the
//   whole sequence, so h never leaves the chip; a block is 256 channels of
//   one row, the grid (ceil(dI / 256), N). With at most 85 registers a
//   thread, 3 blocks (24 warps) fit an SM. Where that grid would leave half
//   the SMs or more idle (N * ceil(dI / 256) <= 66 on 132 SMs: the first
//   and last steps of a diagonal prefill, 1 or 2 layers), blocks are SMALL
//   = 64 channels, so more SMs run the serial chains: 0.234 ms against
//   0.264 at one falcon layer (tools/kernel_variants.py; at 4 layers, 128
//   blocks, 256 channels are the faster). A thread's arithmetic is the
//   same either way, so the results do not depend on the block size.
// - Tokens go in tiles of 16 through shared memory: x, dt, z and B/C of a
//   tile arrive by cp.async (16 bytes a copy where the strides allow,
//   element loads otherwise) into a double buffer, the next tile's copies
//   in flight while the current one is scanned; one block barrier a tile.
//   B_t and C_t are the same for every thread of the block, so their
//   shared-memory reads are broadcasts (a first design that split a
//   channel's states over 4 lanes spent a shared-memory wavefront per 8
//   channels on each of them, and two shuffles a token on y).
// - The step's softplus, y's D x term and the gate are computed by the
//   channel's thread in fp32 and y is stored per token, coalesced across
//   the block's channels.
// y = h . C sums the states in four-state partial sums added pairwise.
// Ragged dI: the last block's loads of channels past dI are zero-filled and
// its stores masked; T = 1 (decode) is one partial tile. A row's results do
// not depend on the rows launched beside it.
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "mamba_scan.cuh"

using namespace rk;
using namespace rk::scan;

namespace {

constexpr int THREADS = 256;          // channels of one row per block, one per thread
constexpr int SMALL = 64;             // the same where 256-channel blocks leave half the SMs idle
constexpr int RESIDENT = 768;         // threads an SM (85 registers each)
struct ScanArgs {
  const void* x;
  const void* dt;
  const float* B;
  const float* C;
  const float* A_log;
  const float* D;
  const float* h0;
  const void* dt_bias;   // the fused form: both given; the TPU kernel's: both null
  const void* z;
  void* y;
  float* hT;
  float* hs;             // the states kept for the backward, or null
  int T, dI, rows_per_group, bias_bf16, vec, vec_bc, chunk, nchunks;
  ll sxn, sxt, sdn, sdt, sbn, sbt, scn, sct, szn, szt;
};

// Shared memory of one block: a double buffer of each input tile.
template <int TH, typename TX, int DS, bool FUSED>
struct Layout {
  typedef typename std::conditional<FUSED, TX, float>::type TD;
  static constexpr int X = 0;
  static constexpr int DT = X + 2 * TT * TH * (int)sizeof(TX);
  static constexpr int Z = DT + 2 * TT * TH * (int)sizeof(TD);
  static constexpr int BC = Z + (FUSED ? 2 * TT * TH * (int)sizeof(TX) : 0);
  static constexpr int BYTES = BC + 2 * TT * 2 * DS * 4;
};

// A [TT][TH] tile of rows t0.. (cnt of them) of a strided [T][dI]
// operand, channels c0.., into shared memory: 16-byte cp.async copies when
// `vec` (the caller checked that every row's piece is whole 16-byte
// pieces), element loads otherwise. Channels past dI arrive as zeros.
template <int TH, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, ll st, int t0, int cnt,
                                          int c0, int dI, bool vec) {
  if (vec) {
    constexpr int PER = 16 / sizeof(T), CHUNKS = TH / PER;
    for (int e = threadIdx.x; e < cnt * CHUNKS; e += TH) {
      const int t = e / CHUNKS, c = (e % CHUNKS) * PER;
      const T* row = src + (ll)(t0 + t) * st;
      const bool ok = c0 + c < dI;
      cp_async16(dst + t * TH + c, ok ? row + c0 + c : row, ok);
    }
  } else {
    for (int e = threadIdx.x; e < cnt * TH; e += TH) {
      const int t = e / TH, c = e % TH;
      dst[t * TH + c] = c0 + c < dI ? src[(ll)(t0 + t) * st + c0 + c] : from_f<T>(0.f);
    }
  }
}

template <int TH, typename TX, int DS, bool FUSED>
__global__ void __launch_bounds__(TH, RESIDENT / TH) mamba_scan_kernel(const ScanArgs a) {
  using L = Layout<TH, TX, DS, FUSED>;
  typedef typename L::TD TD;
  typedef typename std::conditional<FUSED, TX, float>::type TO;
  constexpr int NG = DS / 4;   // groups of 4 states
  extern __shared__ __align__(16) unsigned char smem[];
  TX* xs = reinterpret_cast<TX*>(smem + L::X);
  TD* ds = reinterpret_cast<TD*>(smem + L::DT);
  TX* zs = reinterpret_cast<TX*>(smem + L::Z);
  float* bc = reinterpret_cast<float*>(smem + L::BC);

  const int n = blockIdx.y, c0 = blockIdx.x * TH, c = threadIdx.x;
  const int dI = a.dI, T = a.T;
  const bool valid = c0 + c < dI;
  const int ic = valid ? c0 + c : dI - 1;              // clamped: loads stay in bounds
  const ll g = n / a.rows_per_group;

  float A2[DS], h[DS];
  {
    const float4* al = reinterpret_cast<const float4*>(a.A_log + (g * dI + ic) * DS);
    const float4* hp = reinterpret_cast<const float4*>(a.h0 + ((ll)n * dI + ic) * DS);
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      const float4 l = al[k], v = hp[k];
      A2[4 * k] = -expf(l.x) * LOG2E;
      A2[4 * k + 1] = -expf(l.y) * LOG2E;
      A2[4 * k + 2] = -expf(l.z) * LOG2E;
      A2[4 * k + 3] = -expf(l.w) * LOG2E;
      h[4 * k] = v.x;
      h[4 * k + 1] = v.y;
      h[4 * k + 2] = v.z;
      h[4 * k + 3] = v.w;
    }
  }
  const float Dd = a.D[g * dI + ic];
  float bias = 0.f;
  if (FUSED)
    bias = a.bias_bf16 ? __bfloat162float(static_cast<const bf16*>(a.dt_bias)[g * dI + ic])
                       : static_cast<const float*>(a.dt_bias)[g * dI + ic];

  const TX* xp = static_cast<const TX*>(a.x) + (ll)n * a.sxn;
  const TD* dp = static_cast<const TD*>(a.dt) + (ll)n * a.sdn;
  const TX* zp = FUSED ? static_cast<const TX*>(a.z) + (ll)n * a.szn : nullptr;
  const float* bp = a.B + (ll)n * a.sbn;
  const float* cq = a.C + (ll)n * a.scn;
  TO* yp = static_cast<TO*>(a.y) + (ll)n * T * dI + c0 + c;

  auto load = [&](int buf, int t0, int cnt) {
    load_tile<TH>(xs + buf * TT * TH, xp, a.sxt, t0, cnt, c0, dI, a.vec);
    load_tile<TH>(ds + buf * TT * TH, dp, a.sdt, t0, cnt, c0, dI, a.vec);
    if (FUSED) load_tile<TH>(zs + buf * TT * TH, zp, a.szt, t0, cnt, c0, dI, a.vec);
    float* dst = bc + buf * TT * 2 * DS;
    if (a.vec_bc) {   // B_t and C_t as DS / 4 16-byte pieces each
      for (int e = threadIdx.x; e < cnt * 2 * NG; e += TH) {
        const int t = e / (2 * NG), k = e % (2 * NG);
        const float* src = k < NG ? bp + (ll)(t0 + t) * a.sbt + 4 * k
                                  : cq + (ll)(t0 + t) * a.sct + 4 * (k - NG);
        cp_async16(dst + t * 2 * DS + 4 * k, src, true);
      }
    } else {
      for (int e = threadIdx.x; e < cnt * 2 * DS; e += TH) {
        const int t = e / (2 * DS), s = e % (2 * DS);
        const float* src = s < DS ? bp + (ll)(t0 + t) * a.sbt + s
                                  : cq + (ll)(t0 + t) * a.sct + (s - DS);
        cp_async4(dst + t * 2 * DS + s, src, true);
      }
    }
    cp_async_commit();
  };

  if (T > 0) load(0, 0, min(TT, T));
  int buf = 0;
  for (int t0 = 0; t0 < T; t0 += TT) {
    const int cnt = min(TT, T - t0);
    cp_async_wait<0>();
    // this tile has landed, and every thread is done with the other buffer
    __syncthreads();
    if (t0 + TT < T) load(buf ^ 1, t0 + TT, min(TT, T - t0 - TT));
    if (a.hs != nullptr && t0 % a.chunk == 0 && valid) {   // h before token t0
      float4* hk = reinterpret_cast<float4*>(
          a.hs + (((ll)n * a.nchunks + t0 / a.chunk) * dI + c0 + c) * DS);
#pragma unroll
      for (int k = 0; k < NG; ++k)
        hk[k] = make_float4(h[4 * k], h[4 * k + 1], h[4 * k + 2], h[4 * k + 3]);
    }
    const TX* xb = xs + buf * TT * TH + c;
    const TD* db = ds + buf * TT * TH + c;
    const TX* zb = zs + buf * TT * TH + c;
    const float4* bt = reinterpret_cast<const float4*>(bc + buf * TT * 2 * DS);
#pragma unroll 4
    for (int t = 0; t < cnt; ++t) {
      const float xv = to_f(xb[t * TH]);
      const float dv = FUSED ? softplus(to_f(db[t * TH]) + bias) : to_f(db[t * TH]);
      const float dx = dv * xv;
      // B_t and C_t are the same for every thread of the block: broadcast reads
      float part[NG];
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        const float4 b4 = bt[t * 2 * NG + k], c4 = bt[t * 2 * NG + NG + k];
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w}, cv[4] = {c4.x, c4.y, c4.z, c4.w};
        float p = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = 4 * k + j;
          h[s] = fmaf(ex2_approx(dv * A2[s]), h[s], dx * bv[j]);
          p = fmaf(h[s], cv[j], p);
        }
        part[k] = p;
      }
      // y = h . C + D x, the four-state partial sums added pairwise
#pragma unroll
      for (int w = 1; w < NG; w <<= 1)
#pragma unroll
        for (int k = 0; k + w < NG; k += 2 * w) part[k] += part[k + w];
      float v = fmaf(Dd, xv, part[0]);
      if (FUSED) {
        const float zf = to_f(zb[t * TH]);
        v = to_f(from_f<TX>(v)) * to_f(from_f<TX>(zf / (1.f + expf(-zf))));
      }
      if (valid) yp[(ll)(t0 + t) * dI] = from_f<TO>(v);
    }
    buf ^= 1;
  }
  if (valid) {
    float4* ho = reinterpret_cast<float4*>(a.hT + ((ll)n * dI + c0 + c) * DS);
#pragma unroll
    for (int k = 0; k < NG; ++k)
      ho[k] = make_float4(h[4 * k], h[4 * k + 1], h[4 * k + 2], h[4 * k + 3]);
  }
}

template <int TH, typename TX, int DS, bool FUSED>
cudaError_t launch(const ScanArgs& a, int N, cudaStream_t s) {
  constexpr int smem = Layout<TH, TX, DS, FUSED>::BYTES;
  auto kernel = mamba_scan_kernel<TH, TX, DS, FUSED>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3((a.dI + TH - 1) / TH, N), TH, smem, s>>>(a);
  return cudaGetLastError();
}

// The block's channels at block = 0: SMALL where 256-channel blocks would
// leave half the SMs idle, else THREADS.
int choose_block(int N, int dI) {
  return 2LL * N * ((dI + THREADS - 1) / THREADS) <= sm_count() ? SMALL : THREADS;
}

template <typename TX, int DS>
cudaError_t by_form(const ScanArgs& a, int N, int block, cudaStream_t s) {
  if (block == 0) block = choose_block(N, a.dI);
  if (block != SMALL && block != THREADS) return cudaErrorInvalidValue;
  const bool small = block == SMALL;
  if (a.z != nullptr)
    return small ? launch<SMALL, TX, DS, true>(a, N, s) : launch<THREADS, TX, DS, true>(a, N, s);
  return small ? launch<SMALL, TX, DS, false>(a, N, s) : launch<THREADS, TX, DS, false>(a, N, s);
}

template <typename TX>
cudaError_t by_state(int dS, const ScanArgs& a, int N, int block, cudaStream_t s) {
  switch (dS) {
    case 4: return by_form<TX, 4>(a, N, block, s);
    case 8: return by_form<TX, 8>(a, N, block, s);
    case 16: return by_form<TX, 16>(a, N, block, s);
    default: return cudaErrorInvalidValue;
  }
}

// every row's piece of a block's channels of a [.., T, dI] operand is whole
// 16-byte pieces
bool rows16(const void* p, ll sn, ll st, int dI, int es) {
  return aligned16(p) && (sn * es) % 16 == 0 && (st * es) % 16 == 0 && ((ll)dI * es) % 16 == 0;
}

}  // namespace

// x [N,T,dI] through strides (n, t), dtype 0 float32 / 1 bfloat16; dt
// [N,T,dI] through (n, t): fp32 post-softplus when dt_bias is null, else the
// raw dt_proj output in x's dtype; B and C [N,T,dS] fp32 through (n, t); the
// last dim of each is contiguous. A_log [G,dI,dS], D [G,dI], h0 [N,dI,dS]
// fp32 contiguous; dt_bias [G,dI] contiguous (bias_dtype 0 fp32, 1 bf16) and
// z [N,T,dI] in x's dtype through (n, t), both or neither (null). Outputs:
// y [N,T,dI] contiguous, in x's dtype when fused, else fp32; hT [N,dI,dS]
// fp32 contiguous; hs (or null) [N, ceil(T / chunk), dI, dS] fp32 takes the
// state before every chunk-th token (chunk a multiple of 16). Needs N % G
// == 0 and dS in {4, 8, 16}. block: a block's channels, 64 or 256, or 0 for
// choose_block's pick (the same bits: a channel's scan is one thread's).
extern "C" int mamba_scan_launch(const void* x, const void* dt, const void* B, const void* C,
                                 const void* A_log, const void* D, const void* h0,
                                 const void* dt_bias, const void* z, void* y, void* hT,
                                 void* hs, int chunk, int N,
                                 int T, int dI, int dS, int G, long long sxn, long long sxt,
                                 long long sdn, long long sdt, long long sbn, long long sbt,
                                 long long scn, long long sct, long long szn, long long szt,
                                 int dtype, int bias_dtype, int block, void* stream) {
  if (N <= 0 || dI <= 0 || T < 0 || G <= 0 || N % G != 0 || (dtype != 0 && dtype != 1) ||
      (bias_dtype != 0 && bias_dtype != 1) || (dt_bias == nullptr) != (z == nullptr) ||
      !aligned16(A_log) || !aligned16(h0) || !aligned16(hT) ||
      (hs != nullptr && (chunk <= 0 || chunk % TT != 0 || !aligned16(hs))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = dtype == 1 ? 2 : 4;
  ScanArgs a;
  a.x = x;
  a.dt = dt;
  a.B = static_cast<const float*>(B);
  a.C = static_cast<const float*>(C);
  a.A_log = static_cast<const float*>(A_log);
  a.D = static_cast<const float*>(D);
  a.h0 = static_cast<const float*>(h0);
  a.dt_bias = dt_bias;
  a.z = z;
  a.y = y;
  a.hT = static_cast<float*>(hT);
  a.hs = static_cast<float*>(hs);
  a.chunk = chunk > 0 ? chunk : TT;
  a.nchunks = (T + a.chunk - 1) / a.chunk;
  a.T = T;
  a.dI = dI;
  a.rows_per_group = N / G;
  a.bias_bf16 = bias_dtype;
  a.vec = rows16(x, sxn, sxt, dI, es) && rows16(dt, sdn, sdt, dI, dt_bias ? es : 4) &&
          (z == nullptr || rows16(z, szn, szt, dI, es));
  a.vec_bc = dS % 4 == 0 && aligned16(B) && aligned16(C) && sbn % 4 == 0 && sbt % 4 == 0 &&
             scn % 4 == 0 && sct % 4 == 0;
  a.sxn = sxn;
  a.sxt = sxt;
  a.sdn = sdn;
  a.sdt = sdt;
  a.sbn = sbn;
  a.sbt = sbt;
  a.scn = scn;
  a.sct = sct;
  a.szn = szn;
  a.szt = szt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 1 ? by_state<bf16>(dS, a, N, block, s)
                                     : by_state<float>(dS, a, N, block, s));
}

// The channels a block that mamba_scan_launch runs at block = 0 for N rows
// of dI channels on this card. A query: it launches nothing.
extern "C" int mamba_scan_choose_block(int N, int dI) { return choose_block(N, dI); }

