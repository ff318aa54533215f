// Causal GQA flash attention over a group of segments, for sm_90a.
//
// Replaces: repro/kernels/flash_attention.py `flash_attention` (Pallas,
// `_flash_kernel`): out = softmax(q k^T * hd^-1/2 + mask) v with an online
// softmax, kv head = h / (Hq / Hkv), causal and/or sliding-window masks.
// q [N,Hq,T,hd], k/v [N,Hkv,S,hd] are read through (n, h, t) strides with a
// contiguous head dim, so the grouped cell's [G,B,T,H,hd] activations go in
// without the transpose copy the TPU path made; out is [N,T,Hq,hd].
//
// Bound on the H100: on the main path (N = 16, Hq = 32, T = S = 1152,
// hd = 64, causal) the two products are 87 GFLOP, 0.088 ms at the bf16
// tensor-core peak, and the softmax takes N * Hq * T(T+1)/2 = 3.4e8
// exponentials, ~0.081 ms at 16 a clock per SM, plus ~6-8 other fp32
// operations per score on the FMA pipe: at hd 64 the softmax is nearly as
// large as the matrix work, and memory (~0.03 ms of bytes) is not the limit.
//
// Design (flash_wgmma, after FlashAttention-3):
// - A persistent grid, one CTA per SM, walks the work items (n, q head,
//   query tile of 64 rows per consumer warpgroup: 192 rows at hd 64, 128 at
//   hd 128), the longest causal tiles first.
// - The last warpgroup is the producer: one thread loads each item's Q tile
//   once, into one of two buffers so that it runs an item ahead, and
//   streams its K/V tiles of 64 keys (16 KB a stage at hd 64, 32 KB at hd
//   80 and 128) through a 128 KB mbarrier ring, by TMA through 4-D tensor maps
//   over the strided [N, H, T, hd] views (dims hd, T, H, N), 128-byte
//   swizzle; rows past T or S arrive as zeros. setmaxnreg gives its
//   registers to the consumers.
// - The other warpgroups each own 64 query rows of the item. S = Q K^T is
//   wgmma m64n64k16 with Q and K (K-major) from shared memory; O += P V is
//   wgmma m64nHDk16 with P taken from registers (the fp32 S accumulators
//   packed to bf16, as mma.sync's C fragment becomes its A fragment) and V
//   N-major (the transpose-B mode). The PV product of tile j - 1 is issued
//   with the S product of tile j, so it runs while tile j's softmax runs.
// - The consumer warpgroups run free of each other. FlashAttention-3 makes
//   them take turns (ping-pong on named barriers) so that one's softmax
//   hides the other's products; here the softmax is several times longer
//   than the products, and taking turns leaves fewer warps a scheduler in
//   the softmax to hide each other's latency: 0.368 against 0.349 ms at
//   the main shape on an H100 at 700 W (tools/flash_variants.py; PERF.md).
// - The softmax rounds as the previous kernel's did, to the bit: 64-key
//   tiles, so the running max moves at the same keys and p rounds to bf16
//   against the same max; fp32 in registers, base 2 with the scale applied
//   to each score before the max is taken, exp2 on the special-function
//   unit, l summed from the fp32 p in key order. (128-key tiles ran 10 %
//   faster at hd 64 but moved an ill-conditioned segment of the untrained
//   llama past chip_smoke's teacher-forced gate: PERF.md.)
// - Tiles wholly above the causal diagonal, below the window or past S are
//   never loaded; element masks run only in warps whose 16 rows meet a mask
//   edge, as selects, not branches. All warpgroups of a CTA walk the same
//   K/V tiles (those of the whole item; a tile no row of a warpgroup sees
//   leaves its sums exactly as they were), so producer and consumers count
//   tiles with one function (kv_tiles).
// - The epilogue scales by 1/l and stores bf16 pairs straight from the
//   registers, rows past T skipped.
//
// - Head dim 80 (h2o-danube-1.8b) runs hd 128's kernel over the same
//   shared-memory layout: a 160-byte row is more than one 128-byte swizzle
//   span, so each Q, K and V tile is two 64-column boxes, as at hd 128, and
//   the TMA fills the second box's columns 80-127 with zeros (they lie past
//   the tensor map's 80 columns; nothing past a row is read). S = Q K^T
//   takes the 5 k16 steps that hold data, so scores and softmax are
//   computed as for any head dim; O += P V multiplies all 128 columns,
//   since a 128-byte-swizzled N-major operand spans whole 64-column boxes,
//   and columns 80-127 stay zero and are never stored: 60 % more PV work
//   than the data needs, no copy. (A 16-column box with 32-byte swizzle
//   and an n80 PV product would do only the data's work.)
// - Head dim 112 (kimi-k2-1t-a32b) takes the same layout: the TMA zero-fills
//   columns 112-127, S = Q K^T takes 7 k16 steps and O += P V runs at n128
//   (14 % more PV work than the data needs).
//
// fp32 inputs, head dims other than 64/80/112/128, and operands the TMA cannot
// describe take `flash_simt`: one thread per query row, fp32 throughout.
// The caller picks the route (the wrapper's `route()` in
// kernels/flash_attention.py) and counts it; a wgmma launch the operands do
// not allow is refused, never rerouted.
#include <math_constants.h>

#include "common.cuh"

using namespace rk;
typedef __nv_bfloat16 bf16;
typedef long long ll;

namespace {

constexpr int WG_THREADS = 128;

template <int HD> struct FlashCfg {
  // the head dims a tile holds in shared memory: hd 80 and 112 take hd
  // 128's layout, two 64-column boxes of 128-byte-swizzled rows, the second
  // zero-filled by the TMA past column 80 or 112 (see the design note)
  static constexpr int HDP = HD == 80 || HD == 112 ? 128 : HD;
  static constexpr int KSTEPS = HD / 16;   // k16 steps of S = Q K^T: 5 at hd 80, 7 at 112
  // consumer warpgroups, 64 query rows each: 3 at hd 64, where a third warp
  // a scheduler hides more of the softmax's latency (6 %, PERF.md);
  // 2 at hd 80, 112 and 128, since with 512 threads a thread gets 128 registers,
  // too few beside hd 128's 64 O accumulators
  static constexpr int NWG = HD == 64 ? 3 : 2;
  static constexpr int BQ = 64 * NWG;                // query rows a work item
  static constexpr int THREADS = WG_THREADS * (NWG + 1);
  // setmaxnreg: the producer's registers go to the consumers (65,536 a CTA)
  static constexpr int REG_LOAD = NWG == 2 ? 40 : 24;
  static constexpr int REG_MMA = NWG == 2 ? 232 : 160;
  static constexpr int BKV = 64;                     // keys a tile (see the design note)
  static constexpr int Q_BYTES = BQ * HDP * 2;
  static constexpr int BOX = BKV * 128;             // one 64-column TMA box of K or V
  static constexpr int KV_BYTES = BKV * HDP * 2;    // K (or V) of a tile
  static constexpr int STAGE = 2 * KV_BYTES;        // 16 KB at hd 64, 32 KB at hd 80-128
  static constexpr int STAGES = 128 * 1024 / STAGE;   // 8 at hd 64, 4 at hd 80-128
  // two Q buffers, the ring, 2 * STAGES + 4 barriers, slack to align to 1024 bytes
  static constexpr int SMEM = 2 * Q_BYTES + STAGES * STAGE + (2 * STAGES + 4) * 8 + 1024;
};

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

// whether query row sees key col; bitwise on purpose: per element the
// compiler then emits compares and a select, where && and early returns
// became a divergent branch around every score
__device__ __forceinline__ bool visible(int row, int col, int S, int causal, int window) {
  return (col < S) & (!causal | (col <= row)) &
         ((window <= 0) | ((col > row - window) & (causal | (col < row + window))));
}

// 2^x on the special-function unit, as exp2f computes it, but with results
// below 2^-126 flushed to zero (exp2f scales those into denormals with
// three more instructions a call; such a p moves no fp32 sum it enters)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The K/V tiles of the bq-row item at q0: the first key (a multiple of
// bkv) and the count. Producer and consumers both call this.
__device__ __forceinline__ void kv_tiles(int q0, int bq, int S, int causal, int window, int bkv,
                                         int* begin, int* count) {
  int b, e;
  kv_range(q0, bq, S, causal, window, &b, &e);
  b = (b / bkv) * bkv;
  *begin = b;
  *count = e > b ? (e - b + bkv - 1) / bkv : 0;
}

// Work item t: the query tiles from the last (under a causal mask, the
// longest) to the first, every (n, h) of one tile before the next
struct Work {
  int n, h, q0;
  __device__ Work(int t, int NH, int m_tiles, int Hq, int bq) {
    const int nh = t % NH;
    q0 = (m_tiles - 1 - t / NH) * bq;
    n = nh / Hq;
    h = nh % Hq;
  }
};

// o's rescale and p's packing complete before the wgmma fence, so no
// write of a PV operand lands inside the products' pipeline stage
template <int HDP, int BKV>
__device__ __forceinline__ void fence_operands(float* o, uint32_t (*p)[4]) {
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) reg_fence(o[i]);
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) reg_fence(p[kk][e]);
}

// o += P V over one tile: P from registers, V N-major in shared memory, all
// HDP columns (at hd 80 and 112 the zero columns too: a 128-byte-swizzled
// N-major operand spans whole 64-column boxes)
template <int HD>
__device__ __forceinline__ void mma_pv(float* o, const uint32_t (*p)[4], const unsigned char* vs) {
  using C = FlashCfg<HD>;
#pragma unroll
  for (int kk = 0; kk < C::BKV / 16; ++kk) {   // k16 steps: 16 key rows = 2048 bytes
    const uint64_t db = wgmma_desc_sw128(vs + kk * 2048, C::BOX, 1024);
    if constexpr (C::HDP == 64)
      wgmma_rs_m64n64k16_bf16(o, p[kk], db, 1);
    else
      wgmma_rs_m64n128k16_bf16(o, p[kk], db, 1);
  }
}

template <int HD>
__global__ void __launch_bounds__(FlashCfg<HD>::THREADS, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int Hq, int Hkv,
            int T, int S, int causal, int window, float scale_log2, int m_tiles, int items) {
  using C = FlashCfg<HD>;
  constexpr int BKV = C::BKV, BQ = C::BQ, NWG = C::NWG;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte-swizzled tiles start on 1024-byte boundaries
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // two Q buffers, item k's in buffer k % 2, so the next item's loads need
  // not wait for this one's last products; each HDP / 64 boxes of BQ rows x 128 bytes
  unsigned char* Qbuf = smem;
  unsigned char* ring = smem + 2 * C::Q_BYTES;   // per stage: K boxes, then V boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;
  uint64_t* q_full = empty + C::STAGES;
  uint64_t* q_empty = q_full + 2;
  const int wg = threadIdx.x / WG_THREADS;
  const int NH = items / m_tiles;   // N * Hq

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);   // one arrival per consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], NWG);   // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: one thread issues every TMA load
    setmaxnreg_dec<C::REG_LOAD>();
    if (threadIdx.x == NWG * WG_THREADS) {
      int stage = 0;
      uint32_t phase = 0;
      int k = 0;
      for (int t = blockIdx.x; t < items; t += gridDim.x, ++k) {
        const Work w(t, NH, m_tiles, Hq, BQ);
        const int hk = w.h / (Hq / Hkv);
        int kv_begin, nt;
        kv_tiles(w.q0, BQ, S, causal, window, BKV, &kv_begin, &nt);
        const int qb = k & 1;   // the buffer's use (k >> 1) waits for the previous one's end
        mbar_wait(&q_empty[qb], ((k >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&q_full[qb], C::Q_BYTES);
#pragma unroll
        for (int j = 0; j < C::HDP / 64; ++j)
          tma_load_4d(Qbuf + qb * C::Q_BYTES + j * BQ * 128, &tq, &q_full[qb], 64 * j, w.q0,
                      w.h, w.n);
        for (int it = 0; it < nt; ++it) {
          mbar_wait(&empty[stage], phase ^ 1);   // the first pass finds it free
          unsigned char* st = ring + stage * C::STAGE;
          mbar_arrive_expect_tx(&full[stage], C::STAGE);
          const int kv0 = kv_begin + it * BKV;
#pragma unroll
          for (int j = 0; j < C::HDP / 64; ++j) {
            tma_load_4d(st + j * C::BOX, &tk, &full[stage], 64 * j, kv0, hk, w.n);
            tma_load_4d(st + C::KV_BYTES + j * C::BOX, &tv, &full[stage], 64 * j, kv0, hk, w.n);
          }
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 * wg .. 64 * wg + 63 of each item
  setmaxnreg_inc<C::REG_MMA>();
  const int tid = threadIdx.x % WG_THREADS, warp = tid / 32, lane = tid % 32;
  int stage = 0;
  uint32_t phase = 0;
  int k = 0;
  for (int t = blockIdx.x; t < items; t += gridDim.x, ++k) {
    const Work w(t, NH, m_tiles, Hq, BQ);
    int kv_begin, nt;
    kv_tiles(w.q0, BQ, S, causal, window, BKV, &kv_begin, &nt);
    const int wr0 = w.q0 + 64 * wg + 16 * warp, wr1 = wr0 + 15;   // this warp's rows
    const int rowA = wr0 + lane / 4;   // accumulator rows: rowA, rowA + 8
    const int qb = k & 1;
    const unsigned char* Qs = Qbuf + qb * C::Q_BYTES;
    mbar_wait(&q_full[qb], (k >> 1) & 1);
    if (nt == 0 && tid == 0) mbar_arrive(&q_empty[qb]);

    float o[C::HDP / 2];
#pragma unroll
    for (int i = 0; i < C::HDP / 2; ++i) o[i] = 0.f;
    float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f}, alpha[2];
    uint32_t p[BKV / 16][4];

    // S = Q K^T of the tile in stage st, into s (not yet waited for)
    auto issue_s = [&](float* s, const unsigned char* st) {
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk) {   // k16 steps: +32 bytes in a 64-column box
        const int box = kk / 4, off = (kk % 4) * 32;
        const uint64_t da = wgmma_desc_sw128(Qs + box * BQ * 128 + wg * 64 * 128 + off, 16, 1024);
        const uint64_t db = wgmma_desc_sw128(st + box * C::BOX + off, 16, 1024);
        wgmma_ss_m64n64k16_bf16<0>(s, da, db, kk > 0);   // K: K-major B
      }
      wgmma_commit();
    };
    // the online softmax of tile kv0's scores: s becomes p (fp32), m and l
    // move on, alpha is the rescale of the earlier sums
    auto softmax = [&](float* s, int kv0) {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) reg_fence(s[i]);
      // element masks only where this warp's 16 rows meet an edge of the tile
      const bool edge = kv0 + BKV > S || (causal && kv0 + BKV - 1 > wr0) ||
                        (window > 0 && (kv0 <= wr1 - window ||
                                        (!causal && kv0 + BKV - 1 >= wr0 + window)));
      if (edge) {   // warp-uniform: one branch a tile, a select per score
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          const int row = rowA + ((i >> 1) & 1) * 8;
          const int col = kv0 + 8 * (i >> 2) + (lane % 4) * 2 + (i & 1);
          s[i] = visible(row, col, S, causal, window) ? s[i] : -CUDART_INF_F;
        }
      }
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) s[i] *= scale_log2;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // four independent partial maxima a row (a max is exact in any order)
        float mx4[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            mx4[(2 * j + e) % 4] = fmaxf(mx4[(2 * j + e) % 4], s[4 * j + 2 * hh + e]);
        float mx = fmaxf(fmaxf(mx4[0], mx4[1]), fmaxf(mx4[2], mx4[3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[hh], mx);
        const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
        alpha[hh] = exp2_ftz(m_r[hh] - m_use);
        float sum = 0.f;   // in key order, as before
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& sv = s[4 * j + 2 * hh + e];
            sv = exp2_ftz(sv - m_use);
            sum += sv;
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_r[hh] = l_r[hh] * alpha[hh] + sum;
        m_r[hh] = m_new;
      }
    };
    // P rounded to bf16 once, in the A-fragment layout of the PV wgmma
    auto pack = [&](const float* s) {
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    auto advance = [&]() {
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };

    if (nt > 0) {
      // the first tile: S alone
      int prev = stage;
      {
        float s[BKV / 2];
        mbar_wait(&full[stage], phase);
        wgmma_fence();
        issue_s(s, ring + stage * C::STAGE);
        wgmma_wait<0>();
        if (nt == 1 && tid == 0) mbar_arrive(&q_empty[qb]);   // Q's last use is done
        softmax(s, kv_begin);
        pack(s);
        advance();
      }
      // then S of tile it with PV of tile it - 1, which runs during the softmax
      for (int it = 1; it < nt; ++it) {
        float s[BKV / 2];
        mbar_wait(&full[stage], phase);
        fence_operands<C::HDP, BKV>(o, p);
        wgmma_fence();
        issue_s(s, ring + stage * C::STAGE);
        mma_pv<HD>(o, p, ring + prev * C::STAGE + C::KV_BYTES);
        wgmma_commit();
        wgmma_wait<1>();   // S is done, PV may still run
        if (it == nt - 1 && tid == 0) mbar_arrive(&q_empty[qb]);
        softmax(s, kv_begin + it * BKV);
        wgmma_wait<0>();   // PV is done: o, p and the previous stage are free
#pragma unroll
        for (int i = 0; i < C::HDP / 2; ++i) reg_fence(o[i]);
        if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {   // columns past HD hold zeros
          o[4 * j] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
        pack(s);
        prev = stage;
        advance();
      }
      // the last tile's PV
      fence_operands<C::HDP, BKV>(o, p);
      wgmma_fence();
      mma_pv<HD>(o, p, ring + prev * C::STAGE + C::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < C::HDP / 2; ++i) reg_fence(o[i]);
      if (lane == 0) mbar_arrive(&empty[prev]);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rowA + hh * 8;
      if (row >= T) continue;
      const float inv = l_r[hh] > 0.f ? 1.f / l_r[hh] : 0.f;
      bf16* orow = out + (((ll)w.n * T + row) * Hq + w.h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int d = 8 * j + (lane % 4) * 2;
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
      }
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

// The TMA + wgmma route, or cudaErrorInvalidValue where its operands do not
// allow it (the caller's route() should have sent those to flash_simt).
template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int N, int Hq,
                         int Hkv, int T, int S, const ll* st, int causal, int window,
                         float scale_log2, cudaStream_t s) {
  using C = FlashCfg<HD>;
  for (int i = 0; i < 9; ++i)
    if (st[i] <= 0 || st[i] % 8) return cudaErrorInvalidValue;
  if (T <= 0 || S <= 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return cudaErrorInvalidValue;
  // [N, H, T, hd] views as 4-D tensor maps: dims (hd, T, H, N), byte strides
  // of T, H and N; one box is 64 head-dim columns (128 bytes) of a tile's rows
  CUtensorMap mq, mk, mv;
  const cuuint64_t dq[4] = {(cuuint64_t)HD, (cuuint64_t)T, (cuuint64_t)Hq, (cuuint64_t)N};
  const cuuint64_t dk[4] = {(cuuint64_t)HD, (cuuint64_t)S, (cuuint64_t)Hkv, (cuuint64_t)N};
  const cuuint64_t sq[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2, (cuuint64_t)st[0] * 2};
  const cuuint64_t sk[3] = {(cuuint64_t)st[5] * 2, (cuuint64_t)st[4] * 2, (cuuint64_t)st[3] * 2};
  const cuuint64_t sv[3] = {(cuuint64_t)st[8] * 2, (cuuint64_t)st[7] * 2, (cuuint64_t)st[6] * 2};
  const cuuint32_t bq[4] = {64, C::BQ, 1, 1}, bkv[4] = {64, C::BKV, 1, 1};
  if (!encode_bf16(&mq, q, 4, dq, sq, bq) || !encode_bf16(&mk, k, 4, dk, sk, bkv) ||
      !encode_bf16(&mv, v, 4, dk, sv, bkv))
    return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(flash_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    configured = true;
  }
  const int m_tiles = (T + C::BQ - 1) / C::BQ;
  const int items = N * Hq * m_tiles;
  const int grid = items < sm_count() ? items : sm_count();
  flash_wgmma<HD><<<grid, C::THREADS, C::SMEM, s>>>(mq, mk, mv, static_cast<bf16*>(out), Hq, Hkv,
                                                    T, S, causal, window, scale_log2, m_tiles,
                                                    items);
  return cudaGetLastError();
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

// Strides are in elements (a size-1 dim's given as if contiguous); dtype:
// 0 float32, 1 bfloat16; hd <= 128. tc: 1 the TMA + wgmma route (bf16, hd
// 64, 80, 112 or 128, 16-byte-aligned bases and strides; refused with
// cudaErrorInvalidValue where the operands do not allow it), 0 flash_simt.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int N, int Hq, int Hkv, int T, int S,
                                      int hd, long long sqn, long long sqh, long long sqt,
                                      long long skn, long long skh, long long sks,
                                      long long svn, long long svh, long long svs,
                                      int causal, int window, float scale, int dtype, int tc,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ll st[9] = {sqn, sqh, sqt, skn, skh, sks, svn, svh, svs};
  const float scale_log2 = scale * 1.4426950408889634f;   // softmax in base 2
  if (tc) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    switch (hd) {
      case 64:
        return static_cast<int>(launch_wgmma<64>(q, k, v, out, N, Hq, Hkv, T, S, st, causal,
                                                 window, scale_log2, s));
      case 80:
        return static_cast<int>(launch_wgmma<80>(q, k, v, out, N, Hq, Hkv, T, S, st, causal,
                                                 window, scale_log2, s));
      case 112:
        return static_cast<int>(launch_wgmma<112>(q, k, v, out, N, Hq, Hkv, T, S, st, causal,
                                                  window, scale_log2, s));
      case 128:
        return static_cast<int>(launch_wgmma<128>(q, k, v, out, N, Hq, Hkv, T, S, st, causal,
                                                  window, scale_log2, s));
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 1)
    dispatch_simt<bf16>(q, k, v, out, N, Hq, Hkv, T, S, hd, st, causal, window, scale_log2, s);
  else
    dispatch_simt<float>(q, k, v, out, N, Hq, Hkv, T, S, hd, st, causal, window, scale_log2,
                         s);
  return static_cast<int>(cudaGetLastError());
}
