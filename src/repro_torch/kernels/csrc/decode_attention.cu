// Single-token decode attention against the serve KV cache, for sm_90a,
// split over the keys (flash-decoding).
//
// Replaces: repro/kernels/decode_attention.py `decode_attention` (Pallas
// `_decode_kernel`): out[b, h] = softmax_s(q[b, h] . k[b, s, h / rep] *
// hd^-1/2) v[b, s, h / rep] over the valid keys s in [len_b - window, len_b)
// (all of [0, len_b) when window == 0), fp32 softmax. q is [B,Hq,hd], k/v
// are the cache layout [B,S,Hkv,hd], read through their strides (no
// transpose), lengths [B] int32 (the current token included), out
// [B,Hq,hd] contiguous.
//
// Bound on the H100: one query row per (b, head) does 4 * len * hd flops
// against 2 * len * hd * 2 bytes of K/V per kv head, about one flop per
// byte, far below the card's ~295 flop/byte balance point: HBM bytes bound
// it. At the serve path's B = 4 and full length (1152 keys, 8 kv heads,
// hd 64, bf16) that is ~9.4 MB per layer, ~2.8 us at 3.35 TB/s, so the
// kernel must spread the keys of a few rows over the whole card.
//
// Design: two launches.
// - decode_partial, grid (split, kv head x head group, row): a split is a
//   fixed chunk of keys that the host chooses from S alone (never from B or
//   the lengths, which stay on the card), so a row's result does not depend
//   on the rows batched with it. The rep q heads that share a kv head are
//   cut into groups of at most hg heads, hg * hd <= 1024 (the outputs one
//   block's threads hold): one group at every shape but chatglm3-6b's (16
//   heads of 128 dims, two groups of 8). A block scores its group's heads
//   against its chunk's valid keys in 64-key tiles, so each group reads the
//   chunk's K/V once and a head's sums do not depend on the grouping. K
//   and V are loaded once into shared memory in their own dtype (for bf16
//   with 16-byte rows, all of a tile's 16-byte loads in flight at once, and
//   K read back 8 elements a load), warp h scores head h with two keys per
//   lane (fp32 dot in element order, shuffle max and sum), and every thread
//   accumulates its (head, dim) outputs, two neighbours at a time for bf16,
//   against V. It writes the partial (m, l, o[hd]) in fp32, o
//   unnormalised; a chunk wholly outside [len - window, len) writes m =
//   -inf, l = 0 and reads no K/V. At B = 4 and S = 1152: 18 chunks of
//   64 keys, 576 blocks, each reading 16 KB of K/V.
// - decode_combine, one block per (row, q head), the partials' (m, l)
//   staged in shared memory: M = the max m_i over the non-empty partials,
//   out = sum_i e^(m_i - M) o_i / sum_i e^(m_i - M) l_i, in split order,
//   cast to q's dtype. Every row has a valid key (len >= 1),
//   so M is finite, and empty partials are skipped, never subtracted.
#include <math.h>

#include "common.cuh"

using namespace rk;
typedef __nv_bfloat16 bf16;
typedef long long ll;

namespace {

constexpr int THREADS = 128, WARPS = THREADS / 32, BK = 64;
constexpr int MAX_HD = 128;
constexpr int MAX_OUT = 8;   // hg * hd <= THREADS * MAX_OUT
constexpr int CHUNKS = BK * MAX_HD / 8 / THREADS;   // 16-byte pieces a thread loads per tile
constexpr int MAX_COMBINE = 1024;                   // splits the combine's shared memory holds

// The row stride of the K tile in shared memory. VEC: 16-byte rows of 8
// more elements, read 16 bytes a lane: each quarter-warp phase of 8 lanes
// (8 keys) covers all 32 banks. Otherwise an odd word stride, read one
// element a lane: 32 keys hit distinct banks.
template <typename T, bool VEC> __host__ __device__ inline int k_stride(int hd) {
  return VEC ? hd + 8 : hd + (sizeof(T) == 2 ? 2 : 1);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
decode_partial(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const int* __restrict__ lengths, float* __restrict__ part_o,
               float* __restrict__ part_ml, int S, int Hq, int rep, int hg, int n_hg, int hd,
               ll sqb, ll sqh, ll skb, ll sks, ll skh, ll svb, ll svs, ll svh, int window,
               float scale, int chunk, int n_splits) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x, kvh = blockIdx.y / n_hg, b = blockIdx.z;
  // this block's heads: hb .. hb + rep_b - 1, group blockIdx.y % n_hg of kv head kvh
  const int g0 = (blockIdx.y - kvh * n_hg) * hg;
  const int rep_b = min(hg, rep - g0), hb = kvh * rep + g0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = lengths[b];
  const int hi = min(len, S);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int a = max(lo, c * chunk), e = min(hi, min(S, (c + 1) * chunk));
  // partial (b, hb + h, c)
  const ll p0 = ((ll)b * Hq + hb) * n_splits + c;
  if (a >= e) {
    for (int h = tid; h < rep_b; h += THREADS) {
      part_ml[2 * (p0 + (ll)h * n_splits)] = -INFINITY;
      part_ml[2 * (p0 + (ll)h * n_splits) + 1] = 0.f;
    }
    return;
  }
  const int ldk = k_stride<T, VEC>(hd);
  float* qs = smem;                                    // [hg][hd], pre-scaled
  float* ps = qs + hg * hd;                            // [hg][BK] probabilities of the tile
  float* alpha_s = ps + hg * BK;                       // [hg] rescale of the running sums
  float* m_s = alpha_s + hg;                           // [hg] running max
  float* l_s = m_s + hg;                               // [hg] running sum
  T* ks = reinterpret_cast<T*>(smem + ((hg * (hd + BK + 3) + 3) & ~3));   // [BK][ldk]
  T* vs = ks + ((BK * ldk + 7) & ~7);                  // [BK][hd], 16-byte aligned
  const T* kb = k + (ll)b * skb + (ll)kvh * skh;
  const T* vb = v + (ll)b * svb + (ll)kvh * svh;

  // every load of q in flight at once (rep_b * hd <= THREADS * MAX_OUT)
  float qv[MAX_OUT];
#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) {
    const int o = tid + i * THREADS;
    if (o < rep_b * hd) {
      const int h = o / hd, d = o - h * hd;
      qv[i] = to_f(q[(ll)b * sqb + (ll)(hb + h) * sqh + d]);
    }
  }
#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i)
    if (tid + i * THREADS < rep_b * hd) qs[tid + i * THREADS] = qv[i] * scale;
  for (int h = tid; h < rep_b; h += THREADS) {
    m_s[h] = -INFINITY;
    l_s[h] = 0.f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) acc[i] = 0.f;

  for (int t0 = a; t0 < e; t0 += BK) {
    const int n = min(BK, e - t0);   // >= 1
    __syncthreads();                 // the previous tile is consumed
    if constexpr (VEC) {
      // bf16 rows of 16-byte pieces, every load of the tile in flight at once
      const int cpr = hd / 8;
      uint4 kz[CHUNKS], vz[CHUNKS];
#pragma unroll
      for (int r = 0; r < CHUNKS; ++r) {
        const int i = tid + r * THREADS, j = i / cpr, d0 = (i - j * cpr) * 8;
        if (j < n) {
          kz[r] = *reinterpret_cast<const uint4*>(kb + (ll)(t0 + j) * sks + d0);
          vz[r] = *reinterpret_cast<const uint4*>(vb + (ll)(t0 + j) * svs + d0);
        }
      }
#pragma unroll
      for (int r = 0; r < CHUNKS; ++r) {
        const int i = tid + r * THREADS, j = i / cpr, d0 = (i - j * cpr) * 8;
        if (j < n) {
          *reinterpret_cast<uint4*>(ks + j * ldk + d0) = kz[r];
          *reinterpret_cast<uint4*>(vs + j * hd + d0) = vz[r];
        }
      }
    } else {
      for (int i = tid; i < n * hd; i += THREADS) {
        const int j = i / hd, d = i - j * hd;
        ks[j * ldk + d] = kb[(ll)(t0 + j) * sks + d];
        vs[j * hd + d] = vb[(ll)(t0 + j) * svs + d];
      }
    }
    __syncthreads();

    for (int h = warp; h < rep_b; h += WARPS) {
      const float* qh = qs + h * hd;
      float s[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = lane + 32 * r;
        s[r] = -INFINITY;
        if (j < n) {
          const T* kj = ks + j * ldk;
          float acc_s = 0.f;
          if constexpr (VEC) {   // 8 keys' elements a 16-byte load, in the same order
            for (int d = 0; d < hd; d += 8) {
              const uint4 kw = *reinterpret_cast<const uint4*>(kj + d);
              const float4 qa = *reinterpret_cast<const float4*>(qh + d);
              const float4 qb = *reinterpret_cast<const float4*>(qh + d + 4);
              acc_s = fmaf(qa.x, __uint_as_float(kw.x << 16), acc_s);
              acc_s = fmaf(qa.y, __uint_as_float(kw.x & 0xffff0000u), acc_s);
              acc_s = fmaf(qa.z, __uint_as_float(kw.y << 16), acc_s);
              acc_s = fmaf(qa.w, __uint_as_float(kw.y & 0xffff0000u), acc_s);
              acc_s = fmaf(qb.x, __uint_as_float(kw.z << 16), acc_s);
              acc_s = fmaf(qb.y, __uint_as_float(kw.z & 0xffff0000u), acc_s);
              acc_s = fmaf(qb.z, __uint_as_float(kw.w << 16), acc_s);
              acc_s = fmaf(qb.w, __uint_as_float(kw.w & 0xffff0000u), acc_s);
            }
          } else {
            for (int d = 0; d < hd; ++d) acc_s = fmaf(qh[d], to_f(kj[d]), acc_s);
          }
          s[r] = acc_s;
        }
      }
      float mt = fmaxf(s[0], s[1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mt);   // finite: the tile holds a valid key
      float psum = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p = lane + 32 * r < n ? expf(s[r] - m_new) : 0.f;
        ps[h * BK + lane + 32 * r] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float al = expf(m_old - m_new);   // 0 on the first tile
        alpha_s[h] = al;
        l_s[h] = l_s[h] * al + psum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    if constexpr (VEC) {   // a pair of neighbouring outputs a thread: 4-byte V loads
#pragma unroll
      for (int i = 0; i < MAX_OUT / 2; ++i) {
        const int o = 2 * (tid + i * THREADS);
        if (o < rep_b * hd) {
          const int h = o / hd, d = o - h * hd;
          const float* ph = ps + h * BK;
          float r0 = acc[2 * i] * alpha_s[h], r1 = acc[2 * i + 1] * alpha_s[h];
          for (int j = 0; j < n; ++j) {
            const uint32_t vw = *reinterpret_cast<const uint32_t*>(vs + j * hd + d);
            r0 = fmaf(ph[j], __uint_as_float(vw << 16), r0);
            r1 = fmaf(ph[j], __uint_as_float(vw & 0xffff0000u), r1);
          }
          acc[2 * i] = r0;
          acc[2 * i + 1] = r1;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < MAX_OUT; ++i) {
        const int o = tid + i * THREADS;
        if (o < rep_b * hd) {
          const int h = o / hd, d = o - h * hd;
          const float* ph = ps + h * BK;
          float r = acc[i] * alpha_s[h];
          for (int j = 0; j < n; ++j) r = fmaf(ph[j], to_f(vs[j * hd + d]), r);
          acc[i] = r;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) {
    // output i of this thread: VEC pairs (tid + (i / 2) * THREADS), else tid + i * THREADS
    const int o = VEC ? 2 * (tid + (i / 2) * THREADS) + (i & 1) : tid + i * THREADS;
    if (o < rep_b * hd) {
      const int h = o / hd, d = o - h * hd;
      part_o[(p0 + (ll)h * n_splits) * hd + d] = acc[i];
    }
  }
  for (int h = tid; h < rep_b; h += THREADS) {   // m_s, l_s: written before the last barrier
    part_ml[2 * (p0 + (ll)h * n_splits)] = m_s[h];
    part_ml[2 * (p0 + (ll)h * n_splits) + 1] = l_s[h];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_combine(const float* __restrict__ part_o, const float* __restrict__ part_ml,
               T* __restrict__ out, int hd, int n_splits) {
  __shared__ float w_s[MAX_COMBINE], l_s[MAX_COMBINE], M_s;
  const ll bh = blockIdx.x;   // b * Hq + h
  const float* ml = part_ml + bh * n_splits * 2;
  const float* po = part_o + bh * n_splits * hd;
  for (int i = threadIdx.x; i < n_splits; i += THREADS) {
    w_s[i] = ml[2 * i];       // m_i for now
    l_s[i] = ml[2 * i + 1];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float M = -INFINITY;
    for (int i = 0; i < n_splits; ++i)
      if (l_s[i] > 0.f) M = fmaxf(M, w_s[i]);
    M_s = M;
  }
  __syncthreads();
  // an empty split (l = 0, m = -inf) gets weight 0, never -inf - -inf
  for (int i = threadIdx.x; i < n_splits; i += THREADS)
    w_s[i] = l_s[i] > 0.f ? expf(w_s[i] - M_s) : 0.f;
  __syncthreads();
  for (int d = threadIdx.x; d < hd; d += THREADS) {
    float num = 0.f, den = 0.f;
#pragma unroll 8
    for (int i = 0; i < n_splits; ++i) {
      const float w = w_s[i];
      if (w > 0.f) {   // an empty split's o was never written
        num = fmaf(w, po[(ll)i * hd + d], num);
        den = fmaf(w, l_s[i], den);
      }
    }
    out[bh * hd + d] = from_f<T>(den > 0.f ? num / den : 0.f);
  }
}

template <typename T, bool VEC>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
                   float* part_o, float* part_ml, int B, int Hq, int Hkv, int S, int hd, ll sqb,
                   ll sqh, ll skb, ll sks, ll skh, ll svb, ll svs, ll svh, int window,
                   float scale, int chunk, int n_splits, int hg, cudaStream_t s) {
  const int rep = Hq / Hkv, n_hg = (rep + hg - 1) / hg;
  const int ldk = k_stride<T, VEC>(hd);
  const size_t smem = sizeof(float) * ((hg * (hd + BK + 3) + 3) & ~3) +
                      sizeof(T) * (((BK * ldk + 7) & ~7) + BK * hd);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(decode_partial<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  decode_partial<T, VEC><<<dim3(n_splits, Hkv * n_hg, B), THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), part_o, part_ml, S, Hq, rep, hg, n_hg, hd, sqb, sqh,
      skb, sks, skh, svb, svs, svh, window, scale, chunk, n_splits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T><<<B * Hq, THREADS, 0, s>>>(part_o, part_ml, static_cast<T*>(out), hd,
                                                n_splits);
  return cudaGetLastError();
}

}  // namespace

// q [B,Hq,hd] through strides (b, h); k/v [B,S,Hkv,hd] through strides
// (b, s, h); lengths [B] int32; out [B,Hq,hd] contiguous; the workspace
// part_o [B,Hq,n_splits,hd] and part_ml [B,Hq,n_splits,2], fp32. The last
// dim of every operand is contiguous. Split c covers keys [c * chunk,
// (c + 1) * chunk), chunk a multiple of 64. A block takes hg of the Hq / Hkv
// q heads of one kv head (the last group of a kv head may hold fewer).
// dtype: 0 float32, 1 bfloat16. Needs hd <= 128, Hq % Hkv == 0 and
// 1 <= hg <= Hq / Hkv with hg * hd <= 1024.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, void* part_o,
                                       void* part_ml, int B, int Hq, int Hkv, int S, int hd,
                                       long long sqb, long long sqh, long long skb,
                                       long long sks, long long skh, long long svb,
                                       long long svs, long long svh, int window, float scale,
                                       int chunk, int n_splits, int hg, int dtype,
                                       void* stream) {
  if (hd > MAX_HD || Hkv <= 0 || Hq % Hkv != 0 || hg < 1 || hg > Hq / Hkv ||
      hg * hd > THREADS * MAX_OUT ||
      chunk <= 0 || chunk % BK || n_splits <= 0 || n_splits > MAX_COMBINE ||
      (ll)n_splits * chunk < S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  const bool vec = dtype == 1 && hd % 8 == 0 && skb % 8 == 0 && sks % 8 == 0 &&
                   skh % 8 == 0 && svb % 8 == 0 && svs % 8 == 0 && svh % 8 == 0 &&
                   aligned16(k) && aligned16(v);
  cudaError_t err;
  if (dtype == 1 && vec)
    err = launch<bf16, true>(q, k, v, lengths, out, po, pml, B, Hq, Hkv, S, hd, sqb, sqh, skb,
                             sks, skh, svb, svs, svh, window, scale, chunk, n_splits, hg, s);
  else if (dtype == 1)
    err = launch<bf16, false>(q, k, v, lengths, out, po, pml, B, Hq, Hkv, S, hd, sqb, sqh, skb,
                              sks, skh, svb, svs, svh, window, scale, chunk, n_splits, hg, s);
  else
    err = launch<float, false>(q, k, v, lengths, out, po, pml, B, Hq, Hkv, S, hd, sqb, sqh,
                               skb, sks, skh, svb, svs, svh, window, scale, chunk, n_splits,
                               hg, s);
  return static_cast<int>(err);
}
