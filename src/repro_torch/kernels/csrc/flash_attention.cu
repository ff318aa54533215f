// Causal GQA flash attention over a group of segments, for sm_90a.
//
// Replaces: repro/kernels/flash_attention.py `flash_attention` (Pallas,
// `_flash_kernel`): out = softmax(q k^T * hd^-1/2 + mask) v with an online
// softmax, kv head = h / (Hq / Hkv), causal and/or sliding-window masks.
// q [N,Hq,T,hd], k/v [N,Hkv,S,hd] are read through (n, h, t) strides with a
// contiguous head dim, so the grouped cell's [G,B,T,H,hd] activations go in
// without the transpose copy the TPU path made; out is [N,T,Hq,hd].
//
// Bound on the H100: on the main path (T = S = 1152, hd = 64, causal) a
// (n, h) pair does ~4*T*T/2*hd flops against 2*T*hd*2 bytes of q/out plus
// its share of k/v: hundreds of flops per byte, so tensor-core throughput
// (and the exp work on the CUDA cores) bounds it, not memory.
//
// Design: one block of 4 warps per (64-query tile, q head, n); each warp
// owns 16 query rows. Q is loaded once into registers as mma A-fragments;
// K/V tiles of 64 keys stream through a double-buffered cp.async ring.
// S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 in, fp32
// accumulate); P never leaves registers (its C-fragment is the next A-
// fragment). Running max and sum stay fp32 in registers (log2 domain).
// Tiles fully above the causal diagonal or below the sliding window are
// never visited, element masks are applied only on tiles that cross a mask
// edge, and the longest causal query tiles are scheduled first; hd = 64 is
// used as is, with no padding to 128.
//
// fp32 inputs and head dims other than 64/128 take `flash_simt`: one thread
// per query row, fp32 throughout.
#include <math_constants.h>

#include "common.cuh"

using namespace rk;
typedef __nv_bfloat16 bf16;
typedef long long ll;

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 128;

__device__ __forceinline__ void kv_range(int q0, int nq, int S, int causal, int window,
                                         int* begin, int* end) {
  int e = causal ? min(S, q0 + nq) : S;
  int b = 0;
  if (window > 0) {
    b = max(0, q0 - window + 1);
    if (!causal) e = min(S, q0 + nq - 1 + window);
  }
  *begin = b;
  *end = e;
}

__device__ __forceinline__ bool visible(int row, int col, int S, int causal, int window) {
  if (col >= S) return false;
  if (causal && col > row) return false;
  if (window > 0) {
    if (col <= row - window) return false;
    if (!causal && col >= row + window) return false;
  }
  return true;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bf16_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out, int Hq, int Hkv,
               int T, int S, ll sqn, ll sqh, ll sqt, ll skn, ll skh, ll sks, ll svn,
               ll svh, ll svs, int causal, int window, float scale_log2) {
  constexpr int LD = HD + 8;           // 16-byte pad: ldmatrix rows hit distinct banks
  constexpr int CH = HD / 8;           // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LD;             // [2][BKV * LD]
  bf16* Vs = Ks + 2 * BKV * LD;        // [2][BKV * LD]

  // the last query tiles see the most keys under a causal mask: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, n = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const bf16* qb = q + n * sqn + h * sqh;
  const bf16* kb = k + n * skn + hk * skh;
  const bf16* vb = v + n * svn + hk * svh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int c = tid; c < BQ * CH; c += THREADS) {
    const int r = c / CH, d = (c % CH) * 8;
    const bool ok = q0 + r < T;
    cp_async16(Qs + r * LD + d, ok ? qb + (q0 + r) * sqt + d : qb, ok);
  }
  cp_async_commit();

  int kv_begin, kv_end;
  kv_range(q0, BQ, S, causal, window, &kv_begin, &kv_end);
  kv_begin = (kv_begin / BKV) * BKV;
  const int ntiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  auto load_kv = [&](int stage, int tile) {
    const int kv0 = kv_begin + tile * BKV;
    bf16* ks = Ks + stage * BKV * LD;
    bf16* vs = Vs + stage * BKV * LD;
    for (int c = tid; c < BKV * CH; c += THREADS) {
      const int r = c / CH, d = (c % CH) * 8;
      const bool ok = kv0 + r < S;
      cp_async16(ks + r * LD + d, ok ? kb + (kv0 + r) * sks + d : kb, ok);
      cp_async16(vs + r * LD + d, ok ? vb + (kv0 + r) * svs + d : vb, ok);
    }
  };
  if (ntiles > 0) load_kv(0, 0);
  cp_async_commit();

  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  uint32_t qf[HD / 16][4];
  const int rowA = q0 + warp * 16 + lane / 4;   // C-fragment rows: rowA, rowA + 8

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_kv((it + 1) & 1, it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
    }
    const bf16* ks = Ks + (it & 1) * BKV * LD;
    const bf16* vs = Vs + (it & 1) * BKV * LD;

    float s[BKV / 8][4];
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int nb2 = 0; nb2 < BKV / 16; ++nb2) {
        uint32_t r[4];
        const int row = nb2 * 16 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(r, ks + row * LD + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * nb2], qf[kk], r);
        mma_bf16(s[2 * nb2 + 1], qf[kk], r + 2);
      }
    }

    const int kv0 = kv_begin + it * BKV;
    // element masks only where this warp's 16 rows meet an edge of the tile
    const int wr0 = q0 + warp * 16, wr1 = wr0 + 15;
    const bool edge = kv0 + BKV > S || (causal && kv0 + BKV - 1 > wr0) ||
                      (window > 0 && (kv0 <= wr1 - window ||
                                      (!causal && kv0 + BKV - 1 >= wr0 + window)));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rowA + hh * 8;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int nb = 0; nb < BKV / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kv0 + nb * 8 + (lane % 4) * 2 + e;
          float& sv = s[nb][2 * hh + e];
          sv = !edge || visible(row, col, S, causal, window) ? sv * scale_log2
                                                             : -CUDART_INF_F;
          mx = fmaxf(mx, sv);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hh], mx);
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = exp2f(m_r[hh] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < BKV / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& sv = s[nb][2 * hh + e];
          sv = exp2f(sv - m_use);
          sum += sv;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_r[hh] = l_r[hh] * alpha + sum;
      m_r[hh] = m_new;
#pragma unroll
      for (int db = 0; db < HD / 8; ++db) {
        o[db][2 * hh] *= alpha;
        o[db][2 * hh + 1] *= alpha;
      }
    }

#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int db2 = 0; db2 < HD / 16; ++db2) {
        uint32_t r[4];
        const int krow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(r, vs + krow * LD + db2 * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * db2], a, r);
        mma_bf16(o[2 * db2 + 1], a, r + 2);
      }
    }
    __syncthreads();   // this stage is refilled by the prefetch two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = rowA + hh * 8;
    if (row >= T) continue;
    const float inv = l_r[hh] > 0.f ? 1.f / l_r[hh] : 0.f;
    bf16* orow = out + (((ll)n * T + row) * Hq + h) * HD;
#pragma unroll
    for (int db = 0; db < HD / 8; ++db) {
      const int d = db * 8 + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(orow + d) =
          __floats2bfloat162_rn(o[db][2 * hh] * inv, o[db][2 * hh + 1] * inv);
    }
  }
}

constexpr int SIMT_ROWS = 64, SIMT_KEYS = 32;

template <typename T, int HDMAX>
__global__ void __launch_bounds__(SIMT_ROWS)
flash_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ out, int Hq, int Hkv, int T_, int S, int hd, ll sqn, ll sqh,
           ll sqt, ll skn, ll skh, ll sks, ll svn, ll svh, ll svs, int causal, int window,
           float scale_log2) {
  __shared__ float Ksm[SIMT_KEYS][HDMAX];
  __shared__ float Vsm[SIMT_KEYS][HDMAX];
  const int q0 = blockIdx.x * SIMT_ROWS, h = blockIdx.y, n = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* kb = k + n * skn + hk * skh;
  const T* vb = v + n * svn + hk * svh;
  const int row = q0 + threadIdx.x;
  const bool live = row < T_;
  float qr[HDMAX], acc[HDMAX];
  const T* qrow = q + n * sqn + h * sqh + (ll)min(row, T_ - 1) * sqt;
#pragma unroll
  for (int d = 0; d < HDMAX; ++d) {
    qr[d] = d < hd ? to_f(qrow[d]) * scale_log2 : 0.f;
    acc[d] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;
  int kv_begin, kv_end;
  kv_range(q0, SIMT_ROWS, S, causal, window, &kv_begin, &kv_end);
  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += SIMT_KEYS) {
    for (int e = threadIdx.x; e < SIMT_KEYS * HDMAX; e += SIMT_ROWS) {
      const int j = e / HDMAX, d = e % HDMAX;
      const bool ok = kv0 + j < S && d < hd;
      Ksm[j][d] = ok ? to_f(kb[(ll)(kv0 + j) * sks + d]) : 0.f;
      Vsm[j][d] = ok ? to_f(vb[(ll)(kv0 + j) * svs + d]) : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < SIMT_KEYS; ++j) {
      if (!live || !visible(row, kv0 + j, S, causal, window)) continue;
      float sv = 0.f;
#pragma unroll
      for (int d = 0; d < HDMAX; ++d) sv = fmaf(qr[d], Ksm[j][d], sv);
      const float m_new = fmaxf(m, sv);
      const float alpha = exp2f(m - m_new);
      const float p = exp2f(sv - m_new);
      l = l * alpha + p;
#pragma unroll
      for (int d = 0; d < HDMAX; ++d) acc[d] = fmaf(p, Vsm[j][d], acc[d] * alpha);
      m = m_new;
    }
    __syncthreads();
  }
  if (!live) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  T* orow = out + (((ll)n * T_ + row) * Hq + h) * hd;
  for (int d = 0; d < hd; ++d) orow[d] = from_f<T>(acc[d] * inv);
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, int N,
                       int Hq, int Hkv, int T, int S, const ll* st, int causal,
                       int window, float scale_log2, cudaStream_t s) {
  constexpr int smem = (BQ + 4 * BKV) * (HD + 8) * (int)sizeof(bf16);
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(flash_bf16_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    configured = true;
  }
  dim3 grid((T + BQ - 1) / BQ, Hq, N);
  flash_bf16_mma<HD><<<grid, THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), Hq, Hkv, T, S, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], causal, window, scale_log2);
  return cudaSuccess;
}

template <typename T, int HDMAX>
void launch_simt(const void* q, const void* k, const void* v, void* out, int N, int Hq,
                 int Hkv, int T_, int S, int hd, const ll* st, int causal, int window,
                 float scale_log2, cudaStream_t s) {
  dim3 grid((T_ + SIMT_ROWS - 1) / SIMT_ROWS, Hq, N);
  flash_simt<T, HDMAX><<<grid, SIMT_ROWS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Hq, Hkv, T_, S, hd, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], causal, window, scale_log2);
}

template <typename T>
void dispatch_simt(const void* q, const void* k, const void* v, void* out, int N, int Hq,
                   int Hkv, int T_, int S, int hd, const ll* st, int causal, int window,
                   float scale_log2, cudaStream_t s) {
  if (hd <= 32)
    launch_simt<T, 32>(q, k, v, out, N, Hq, Hkv, T_, S, hd, st, causal, window, scale_log2, s);
  else if (hd <= 64)
    launch_simt<T, 64>(q, k, v, out, N, Hq, Hkv, T_, S, hd, st, causal, window, scale_log2, s);
  else
    launch_simt<T, 128>(q, k, v, out, N, Hq, Hkv, T_, S, hd, st, causal, window, scale_log2, s);
}

}  // namespace

// Strides are in elements; dtype: 0 float32, 1 bfloat16; hd <= 128.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int N, int Hq, int Hkv, int T, int S,
                                      int hd, long long sqn, long long sqh, long long sqt,
                                      long long skn, long long skh, long long sks,
                                      long long svn, long long svh, long long svs,
                                      int causal, int window, float scale, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ll st[9] = {sqn, sqh, sqt, skn, skh, sks, svn, svh, svs};
  const float scale_log2 = scale * 1.4426950408889634f;   // softmax in base 2
  bool strides8 = true;
  for (int i = 0; i < 9; ++i) strides8 = strides8 && st[i] % 8 == 0;
  const bool vec = strides8 && aligned16(q) && aligned16(k) && aligned16(v);
  if (dtype == 1 && vec && hd == 64) {
    launch_mma<64>(q, k, v, out, N, Hq, Hkv, T, S, st, causal, window, scale_log2, s);
  } else if (dtype == 1 && vec && hd == 128) {
    launch_mma<128>(q, k, v, out, N, Hq, Hkv, T, S, st, causal, window, scale_log2, s);
  } else if (dtype == 1) {
    dispatch_simt<bf16>(q, k, v, out, N, Hq, Hkv, T, S, hd, st, causal, window, scale_log2,
                        s);
  } else {
    dispatch_simt<float>(q, k, v, out, N, Hq, Hkv, T, S, hd, st, causal, window, scale_log2,
                         s);
  }
  return static_cast<int>(cudaGetLastError());
}
