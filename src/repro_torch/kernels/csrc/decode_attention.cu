// Single-token decode attention against the serve KV cache, for sm_90a.
//
// Replaces: repro/kernels/decode_attention.py `decode_attention` (Pallas
// `_decode_kernel`): out[b, h] = softmax_s(q[b, h] . k[b, s, h / rep] *
// hd^-1/2) v[b, s, h / rep] over the valid keys s in [len_b - window, len_b)
// (all of [0, len_b) when window == 0), fp32 running max and sum. q is
// [B,Hq,hd], k/v are the cache layout [B,S,Hkv,hd], read through their
// strides (no transpose), lengths [B] int32 (the current token included),
// out [B,Hq,hd] contiguous.
//
// Bound on the H100: one query row per (b, head) does 4 * len * hd flops
// against 2 * len * hd * 2 bytes of K/V per kv head, about one flop per
// byte, far below the card's ~295 flop/byte balance point: HBM bytes bound
// it. At the serve path's B = 4 and full length (1152 keys, 8 kv heads,
// hd 64, bf16) that is ~9.4 MB per layer, ~2.8 us at 3.35 TB/s. This
// kernel is far from that: its grid has only B * Hkv = 32 blocks (one per
// (row, kv head), below) for 132 SMs, each walking its keys tile by tile,
// so most of the card's bandwidth goes unused. Split-K (Later work, below)
// is what would close that gap.
//
// Design: one block per (row, kv head), so the rep query heads that share
// a kv head read each K/V tile once. The loop over keys starts at the
// window's lower bound and stops at the row's length (the TPU kernel's
// fori_loop bounds): keys past a row's prefix are never read, and the
// ragged end of the last tile is masked here, with no padded copy of the
// cache. Tiles of 32 keys go through shared memory as fp32; for bf16 with
// 16-byte rows the next tile's K/V is fetched into registers while the
// current one is scored (one tile of prefetch). Per tile, warp h scores
// head h with one key per lane (shuffle max and sum, fp32 online softmax
// state in shared memory), then every thread rescales and accumulates its
// (head, dim) outputs against the V tile.
//
// Later work: at B = 4 the grid is only B * Hkv = 32 blocks of 132 SMs; a
// split over the keys (flash-decoding: per-split partial max/sum/output,
// then a combine pass) would fill the card.
#include <math.h>

#include "common.cuh"

using namespace rk;
typedef __nv_bfloat16 bf16;
typedef long long ll;

namespace {

constexpr int THREADS = 128, WARPS = THREADS / 32, BK = 32;
constexpr int MAX_HD = 128;
constexpr int MAX_OUT = 8;                         // rep * hd <= THREADS * MAX_OUT
constexpr int VCH = BK * MAX_HD / 8 / THREADS;     // 16-byte chunks per thread and tile

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lengths,
                        T* __restrict__ out, int S, int Hq, int rep, int hd, ll sqb,
                        ll sqh, ll skb, ll sks, ll skh, ll svb, ll svs, ll svh,
                        int window, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.y, kvh = blockIdx.x;
  const int ld = hd + 1;                 // odd row stride: lanes read distinct banks
  float* qs = smem;                      // [rep][hd], pre-scaled
  float* ks = qs + rep * hd;             // [BK][ld]
  float* vs = ks + BK * ld;              // [BK][hd]
  float* ps = vs + BK * hd;              // [rep][BK] probabilities of the tile
  float* alpha_s = ps + rep * BK;        // [rep] rescale of the running sums
  float* m_s = alpha_s + rep;            // [rep] running max
  float* l_s = m_s + rep;                // [rep] running sum
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = lengths[b];
  const int hi = min(len, S);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const T* kb = k + (ll)b * skb + (ll)kvh * skh;
  const T* vb = v + (ll)b * svb + (ll)kvh * svh;

  for (int e = tid; e < rep * hd; e += THREADS) {
    const int h = e / hd, d = e - h * hd;
    qs[e] = to_f(q[(ll)b * sqb + (ll)(kvh * rep + h) * sqh + d]) * scale;
  }
  for (int h = tid; h < rep; h += THREADS) {
    m_s[h] = -INFINITY;
    l_s[h] = 0.f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) acc[i] = 0.f;

  // VEC: bf16 rows of 16-byte chunks, fetched a tile ahead into registers
  uint4 kr[VCH], vr[VCH];
  const int cpr = hd / 8;
  auto fetch = [&](int t0, int n) {
#pragma unroll
    for (int i = 0; i < VCH; ++i) {
      const int c = tid + i * THREADS, j = c / cpr, d0 = (c - j * cpr) * 8;
      uint4 kz = make_uint4(0, 0, 0, 0), vz = kz;
      if (j < n) {
        kz = *reinterpret_cast<const uint4*>(kb + (ll)(t0 + j) * sks + d0);
        vz = *reinterpret_cast<const uint4*>(vb + (ll)(t0 + j) * svs + d0);
      }
      kr[i] = kz;
      vr[i] = vz;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < VCH; ++i) {
      const int c = tid + i * THREADS, j = c / cpr, d0 = (c - j * cpr) * 8;
      if (j >= BK) continue;
      const bf16* kk = reinterpret_cast<const bf16*>(&kr[i]);
      const bf16* vv = reinterpret_cast<const bf16*>(&vr[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        ks[j * ld + d0 + e] = __bfloat162float(kk[e]);
        vs[j * hd + d0 + e] = __bfloat162float(vv[e]);
      }
    }
  };
  if constexpr (VEC) {
    if (lo < hi) fetch(lo, min(BK, hi - lo));
  }

  for (int t0 = lo; t0 < hi; t0 += BK) {
    const int n = min(BK, hi - t0);      // >= 1: every tile holds a valid key
    __syncthreads();                     // the previous tile is consumed
    if constexpr (VEC) {
      stash();
      if (t0 + BK < hi) fetch(t0 + BK, min(BK, hi - t0 - BK));
    } else {
      for (int e = tid; e < BK * hd; e += THREADS) {
        const int j = e / hd, d = e - j * hd;
        const bool ok = j < n;
        ks[j * ld + d] = ok ? to_f(kb[(ll)(t0 + j) * sks + d]) : 0.f;
        vs[j * hd + d] = ok ? to_f(vb[(ll)(t0 + j) * svs + d]) : 0.f;
      }
    }
    __syncthreads();

    for (int h = warp; h < rep; h += WARPS) {
      float s = -INFINITY;
      if (lane < n) {
        s = 0.f;
        const float* qh = qs + h * hd;
        const float* kj = ks + lane * ld;
        for (int d = 0; d < hd; ++d) s = fmaf(qh[d], kj[d], s);
      }
      float mt = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mt);
      const float p = lane < n ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      ps[h * BK + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_old - m_new);      // 0 on the first tile
        alpha_s[h] = a;
        l_s[h] = l_s[h] * a + psum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < MAX_OUT; ++i) {
      const int e = tid + i * THREADS;
      if (e < rep * hd) {
        const int h = e / hd, d = e - h * hd;
        const float* ph = ps + h * BK;
        float a = acc[i] * alpha_s[h];
        for (int j = 0; j < n; ++j) a = fmaf(ph[j], vs[j * hd + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) {
    const int e = tid + i * THREADS;
    if (e < rep * hd) {
      const int h = e / hd, d = e - h * hd;
      const float l = l_s[h];
      out[((ll)b * Hq + kvh * rep + h) * hd + d] = from_f<T>(l > 0.f ? acc[i] / l : 0.f);
    }
  }
}

template <typename T, bool VEC>
void launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
            int B, int Hq, int Hkv, int S, int hd, ll sqb, ll sqh, ll skb, ll sks, ll skh,
            ll svb, ll svs, ll svh, int window, float scale, cudaStream_t s) {
  const int rep = Hq / Hkv;
  const size_t smem = sizeof(float) * (rep * hd + BK * (hd + 1) + BK * hd + rep * BK + 3 * rep);
  dim3 grid(Hkv, B);
  decode_attention_kernel<T, VEC><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(out), S, Hq, rep, hd, sqb, sqh, skb,
      sks, skh, svb, svs, svh, window, scale);
}

}  // namespace

// q [B,Hq,hd] through strides (b, h); k/v [B,S,Hkv,hd] through strides
// (b, s, h); lengths [B] int32; out [B,Hq,hd] contiguous. The last dim of
// every operand is contiguous. dtype: 0 float32, 1 bfloat16. Needs
// hd <= 128, Hq % Hkv == 0 and (Hq / Hkv) * hd <= 1024.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, int B, int Hq,
                                       int Hkv, int S, int hd, long long sqb, long long sqh,
                                       long long skb, long long sks, long long skh,
                                       long long svb, long long svs, long long svh,
                                       int window, float scale, int dtype, void* stream) {
  if (hd > MAX_HD || Hkv <= 0 || Hq % Hkv != 0 || (Hq / Hkv) * hd > THREADS * MAX_OUT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = dtype == 1 && hd % 8 == 0 && skb % 8 == 0 && sks % 8 == 0 &&
                   skh % 8 == 0 && svb % 8 == 0 && svs % 8 == 0 && svh % 8 == 0 &&
                   aligned16(k) && aligned16(v);
  if (dtype == 1 && vec)
    launch<bf16, true>(q, k, v, lengths, out, B, Hq, Hkv, S, hd, sqb, sqh, skb, sks, skh,
                       svb, svs, svh, window, scale, s);
  else if (dtype == 1)
    launch<bf16, false>(q, k, v, lengths, out, B, Hq, Hkv, S, hd, sqb, sqh, skb, sks, skh,
                        svb, svs, svh, window, scale, s);
  else
    launch<float, false>(q, k, v, lengths, out, B, Hq, Hkv, S, hd, sqb, sqh, skb, sks, skh,
                         svb, svs, svh, window, scale, s);
  return static_cast<int>(cudaGetLastError());
}
