// Grouped matmul with a fused bias + activation epilogue, for sm_90a.
//
// Replaces: repro/kernels/grouped_matmul.py `grouped_matmul` (Pallas,
// `_gmm_kernel` / `_gmm_bias_kernel`): out[i] = act(x[i] @ w[j] + bias[j])
// (+ res[i]), j = i / wbatch, x [G,R,K] (rows read through group and row
// strides, so the grouped cell's [G,B*T,K] activations and y's memory-row
// view need no copy), w [G/wbatch,K,N], out [G,R,N] contiguous, in the
// input dtype or in fp32.
//
// With a layer index widx (int32 [G] on the device) j = widx[i] instead,
// over a stack w [wgroups,K,N]: a pooled band step of several pipelines
// runs each group with its own layer in one launch, reading the model's
// own stacked weights (the w tensor map spans the whole stack), where a
// gathered copy would move the weights' bytes once more. The producer
// reads j per tile; the k loop and the tile walk are those of the plain
// launch, so a group's sums do not depend on the groups beside it.
//
// The optional residual res [G,R,N] (read through its strides) is added to
// the fp32 accumulator before the single cast: that is the GEMM half of
// `grouped_matmul_armt_update` (Pallas `_gmm_armt_kernel`), whose y = res +
// x @ w rounds once, where adding res to a bf16 x @ w would round twice.
// The TPU kernel then runs the ARMT update on the memory-token rows of the
// fp32 y tile it holds in VMEM; a [128, 2048] fp32 tile is 1 MB against
// 227 KB of shared memory here, so the port's wrapper runs the update on
// the csrc/armt_memory.cu kernels, which find y's memory rows (512 KB of
// bf16 per group) in the 50 MB L2 right after this launch. The ARMT kernels
// use the fp32 output for their projections of bf16 activations: bf16 x bf16
// products are exact in fp32, so that is the reference's fp32 math up to
// summation order.
//
// Bound on the H100: the main-path shapes (R = 1152, K,N in 512..8192, bf16)
// do 2*R*K*N flops per group against ~2*(R*K + K*N + R*N) bytes, several
// hundred flops per byte, above the card's ~295 flop/byte balance point:
// tensor-core throughput bounds it, and only wgmma reaches that rate.
//
// Design (gmm_wgmma): a persistent, warp-specialised TMA + wgmma mainloop.
// - Clusters of two CTAs, one CTA of 384 threads per SM, as many clusters
//   as the card holds at once, walk the output tiles: a cluster takes one
//   128-row tile of x and two neighbouring BN-column tiles (BN 128 or 256,
//   chosen from N and the tile count), one per CTA; walk step t covers
//   tiles t, t + clusters, ... with the row tile fastest, so the clusters
//   working at one moment cover the row tiles of a few w column panels:
//   each panel comes from HBM once and x's group stays in L2.
// - Warpgroup 2 is the producer: one thread keeps a ring of 64-deep K
//   stages (4 at BN 256, 6 at BN 128) filled by TMA, x through a 3-D tensor
//   map over [G, R, K] with the caller's strides, w through one over
//   [G/wbatch, K, N], both with 128-byte swizzle. Each CTA loads its own w
//   tile and one 64-row half of the shared x tile, multicast to both CTAs:
//   at ~8 TB/s of L2 reads the mainloop ran at ~71 % of the tensor-core
//   peak, and this cuts each CTA's reads by a sixth. Each stage has a
//   "full" mbarrier (TMA bytes) and an "empty" one (the 8 consumer warps
//   of both CTAs, since the peer's half lands here too). Ragged R, K and N
//   edges arrive as TMA's zero fill: no padding copy, no predicate in the
//   loop. setmaxnreg gives the producer's registers to the consumers.
// - Warpgroups 0 and 1 are consumers: each owns 64 rows of the tile and
//   issues wgmma.m64nBNk16 (bf16 in, fp32 accumulators in registers) on A
//   K-major and B N-major (the transpose-B mode, so the weights keep the
//   reference's [K, N] layout), four per stage, one stage's group left in
//   flight while the next is issued.
// - The epilogue moves the accumulators through shared memory 64 columns
//   at a time, and a short loop applies bias, silu / tanh-gelu and res and
//   stores whole rows with the one cast, while the producer already loads
//   the next tile. (Fully unrolled over the 128 accumulators, with the
//   activations inline, it ran longer than the mainloop of a K = 2048 tile.)
// The tensor maps are encoded on the host per call (pointers change per
// call) through cuTensorMapEncodeTiled, a libcuda function reached with
// cudaGetDriverEntryPointByVersion, so the library needs no -lcuda.
//
// The same mainloop runs armt_read's bf16 product (READ, through
// armt_read_gemm_launch; csrc/armt_memory.cu writes its split operands):
// x and w hold a hi and a lo half per group, K walks three terms (x_hi w_hi,
// x_hi w_lo, x_lo w_hi), each loading its tiles from its halves, and the
// epilogue divides each row by its denominator before the one cast.
//
// fp32 inputs, and bf16 shapes whose K or N is not a multiple of 8 (no
// 16-byte rows for the TMA), take `gmm_simt`: a 64 x 64 tile of fp32 FMAs
// per block, exact fp32 accumulation. The caller picks the route (the
// wrapper's `route()` in kernels/grouped_matmul.py) and counts it; a
// tensor-core launch the operands do not allow is refused, never rerouted.
#include "common.cuh"

using namespace rk;
typedef __nv_bfloat16 bf16;
typedef long long ll;

namespace {

constexpr int TBM = 128, TBK = 64, TC_THREADS = 384;
constexpr int A_TILE = TBM * TBK * 2;   // 16 KB: 128 rows of 64 k
constexpr int B_BOX = TBK * 64 * 2;     // 8 KB: 64 k rows of 64 columns, one TMA box
constexpr int EP_COLS = 64;             // epilogue chunk: 64 rows x 64 fp32 per warpgroup
constexpr int EP_BYTES = 2 * 64 * EP_COLS * 4;

template <int BN> struct TcCfg {
  static constexpr int STAGE = A_TILE + (BN / 64) * B_BOX;
  static constexpr int STAGES = 192 * 1024 / STAGE;   // 4 at BN 256, 6 at BN 128
  // the ring, the epilogue's staging, 2 * STAGES barriers, and slack to
  // align the ring to 1024 bytes: 230,464 / 230,496 of 232,448 bytes
  static constexpr int SMEM = STAGES * STAGE + EP_BYTES + 2 * STAGES * 8 + 1024;
};

__device__ __forceinline__ float epilogue(float v, float b, int act) {
  v += b;
  if (act == 1) {
    // silu = v * sigmoid(v) with the accurate exp and divide. The fast pair
    // (__expf, __fdividef) takes ~20 % off the gate projection, but its other
    // roundings moved the untrained model's teacher-forced bf16 check
    // (chip_smoke.py) past its tolerance at an ill-conditioned segment
    v = v / (1.f + expf(-v));
  } else if (act == 2) {
    const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    v = 0.5f * v * (1.f + tanhf(u));                  // tanh-approximate gelu
  }
  return v;
}

__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// staging index of (row, col) in a 64 x EP_COLS chunk: columns XOR-swizzled
// by the row, so the accumulator writes and the row reads hit distinct banks
__device__ __forceinline__ int ep_at(int r, int c) { return r * EP_COLS + (c ^ ((r & 3) << 3)); }

__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 256)
    wgmma_m64n256k16_bf16(d, da, db, scale_d);
  else
    wgmma_ss_m64n128k16_bf16<1>(d, da, db, scale_d);
}

// Tile t of a cluster's persistent walk: row tile fastest, then the pair
// of column tiles, then group; CTA rank r of the cluster takes column tile
// 2 * pair + r (past N when the tile count is odd: its columns are all
// masked, but its half of x still feeds the other CTA).
struct Tile {
  int g, m0, n0;
  __device__ Tile(int t, int m_tiles, int n_pairs, int bn, int rank) {
    m0 = (t % m_tiles) * TBM;
    t /= m_tiles;
    n0 = (2 * (t % n_pairs) + rank) * bn;
    g = t / n_pairs;
  }
};

// Launched in clusters of 2 CTAs (the launch attribute of launch_tc_bn).
// READ: armt_read's three-term product (armt_read_gemm_launch), out =
// rnd(x w / den).
template <int BN, typename OutT, bool READ>
__global__ void __launch_bounds__(TC_THREADS, 1)
gmm_wgmma(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
          const bf16* __restrict__ bias, const bf16* __restrict__ res, OutT* __restrict__ out,
          int R, int K, int N, ll srg, ll srr, int wbatch, const int* __restrict__ widx, int act,
          int m_tiles, int n_pairs, int tiles, const float* __restrict__ den) {
  using C = TcCfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte-swizzled tiles must start on 1024-byte boundaries; the layout
  // is the same in both CTAs of the cluster, as multicast needs
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* staging = reinterpret_cast<float*>(smem + C::STAGES * C::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE + EP_BYTES);
  uint64_t* empty = full + C::STAGES;
  const int wg = threadIdx.x / 128;
  const int kpt = (K + TBK - 1) / TBK, nk = (READ ? 3 : 1) * kpt;   // K tiles: a term's, all
  const uint32_t rank = cluster_ctarank(), peer = rank ^ 1;
  const int cluster = blockIdx.x / 2, clusters = gridDim.x / 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 16);     // one arrival per consumer warp of both CTAs
    }
    mbar_fence_init();
  }
  cluster_sync();                   // both CTAs' barriers exist before any remote use

  if (wg == 2) {
    // ---- producer: one thread issues every TMA load. Each CTA loads its
    // own w tile and one 64-row half of the x tile, multicast to both CTAs
    // (their column tiles share the row tile), so each reads 5/6 of what a
    // lone CTA would from L2. A stage is rewritten only when the consumers
    // of both CTAs have released it, since the peer's half lands here too.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = cluster; t < tiles; t += clusters) {
        const Tile tl(t, m_tiles, n_pairs, BN, rank);
        const int gw = widx ? widx[tl.g] : tl.g / wbatch;
        for (int kt = 0; kt < nk; ++kt) {
          int k0 = kt * TBK, xg = tl.g, wgr = gw;
          if constexpr (READ) {   // x and w hold a hi and a lo half per group:
            const int term = kt / kpt;   // x_hi w_hi, x_hi w_lo, x_lo w_hi
            k0 = (kt - term * kpt) * TBK;
            xg = 2 * tl.g + (term == 2);
            wgr = 2 * tl.g + (term == 1);
          }
          mbar_wait(&empty[stage], phase ^ 1);        // the first pass finds it free
          unsigned char* st = smem + stage * C::STAGE;
          mbar_arrive_expect_tx(&full[stage], C::STAGE);
          tma_load_3d_multicast(st + rank * (A_TILE / 2), &tmx, &full[stage], k0,
                                tl.m0 + rank * (TBM / 2), xg, 0x3);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_3d(st + A_TILE + j * B_BOX, &tmw, &full[stage], tl.n0 + j * 64, k0, wgr);
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      // drain: the peer's consumers have made their last arrivals here
      // before this CTA may exit
      for (int i = 0; i < C::STAGES; ++i) {
        mbar_wait(&empty[stage], phase ^ 1);
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 * wg .. 64 * wg + 63 of the tile
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    float* ep = staging + wg * 64 * EP_COLS;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = cluster; t < tiles; t += clusters) {
      const Tile tl(t, m_tiles, n_pairs, BN, rank);
      int prev = -1;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[stage], phase);
        const unsigned char* st = smem + stage * C::STAGE;
        const uint64_t da = wgmma_desc_sw128(st + wg * 64 * 128, 16, 1024);
        const uint64_t db = wgmma_desc_sw128(st + A_TILE, B_BOX, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TBK / 16; ++kk)   // k16 steps: A +32 bytes, B +16 rows
          wgmma_tile<BN>(acc, da + 2 * kk, db + 128 * kk, kt > 0 || kk > 0);
        wgmma_commit();
        // one group stays in flight: the previous stage's products are done
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) {
          mbar_arrive(&empty[prev]);
          mbar_arrive_cluster(&empty[prev], peer);
        }
        prev = stage;
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) {
        mbar_arrive(&empty[prev]);
        mbar_arrive_cluster(&empty[prev], peer);
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);

      // epilogue, 64 columns at a time through shared memory: the unrolled
      // part only moves registers; bias, activation, res and the one cast
      // run in short loops that store whole rows
      const int gw = widx ? widx[tl.g] : tl.g / wbatch;
      float dr[8];   // READ: den of this thread's rows, loaded once a tile
      if constexpr (READ) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = tl.m0 + wg * 64 + tid / 16 + 8 * i;
          dr[i] = row < R ? den[(ll)tl.g * R + row] : 1.f;
        }
      }
#pragma unroll
      for (int cb = 0; cb < BN / EP_COLS; ++cb) {
        wg_barrier(1 + wg);                     // the previous chunk has been read
#pragma unroll
        for (int jj = 0; jj < EP_COLS / 8; ++jj) {
          const int j = cb * (EP_COLS / 8) + jj;
          const int r = warp * 16 + lane / 4, c = 8 * jj + 2 * (lane % 4);
          *reinterpret_cast<float2*>(ep + ep_at(r, c)) = make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(ep + ep_at(r + 8, c)) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
        wg_barrier(1 + wg);
        const int c = (tid % 16) * 4, col = tl.n0 + cb * EP_COLS + c;
        if (col >= N) continue;                 // and col + 3 < N (N % 8 == 0) but in READ
        if constexpr (READ) {                   // out = rnd(num / den), any N
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = tid / 16 + 8 * i, row = tl.m0 + wg * 64 + r;
            if (row >= R) break;
            const float d = dr[i];
            const float4 a = *reinterpret_cast<const float4*>(ep + ep_at(r, c));
            const float v[4] = {a.x / d, a.y / d, a.z / d, a.w / d};
            OutT* o = out + ((ll)tl.g * R + row) * N + col;
            if (N % 4 == 0) {
              store4(o, v);
            } else {
              for (int e = 0; e < 4 && col + e < N; ++e) o[e] = from_f<OutT>(v[e]);
            }
          }
          continue;
        }
        if (act == 0 && bias == nullptr && res == nullptr) {   // the plain projections
#pragma unroll 1
          for (int r = tid / 16; r < 64; r += 8) {
            const int row = tl.m0 + wg * 64 + r;
            if (row >= R) break;
            const float4 a = *reinterpret_cast<const float4*>(ep + ep_at(r, c));
            store4(out + ((ll)tl.g * R + row) * N + col, {a.x, a.y, a.z, a.w});
          }
          continue;
        }
        if (act == 0 && bias == nullptr) {      // y = res + x @ w: the fused op's GEMM half
          // all 8 rows' residual loads first, so they are in flight at
          // once; 8-byte loads where aligned
          const bool vec = ((srg | srr) & 3) == 0 && (reinterpret_cast<uintptr_t>(res) & 7) == 0;
          const int r0 = tid / 16, row0 = tl.m0 + wg * 64 + r0;
          float v[8][4];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (row0 + 8 * i >= R) continue;
            const bf16* rp = res + (ll)tl.g * srg + (ll)(row0 + 8 * i) * srr + col;
            if (vec) {
              const uint2 raw = *reinterpret_cast<const uint2*>(rp);
              const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
              const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
              v[i][0] = __low2float(lo);
              v[i][1] = __high2float(lo);
              v[i][2] = __low2float(hi);
              v[i][3] = __high2float(hi);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) v[i][e] = __bfloat162float(rp[e]);
            }
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (row0 + 8 * i >= R) continue;
            const float4 a = *reinterpret_cast<const float4*>(ep + ep_at(r0 + 8 * i, c));
            v[i][0] += a.x;
            v[i][1] += a.y;
            v[i][2] += a.z;
            v[i][3] += a.w;
            store4(out + ((ll)tl.g * R + row0 + 8 * i) * N + col, v[i]);
          }
          continue;
        }
        float b[4] = {0.f, 0.f, 0.f, 0.f};
        if (bias) {
#pragma unroll
          for (int e = 0; e < 4; ++e) b[e] = __bfloat162float(bias[(ll)gw * N + col + e]);
        }
#pragma unroll 1
        for (int r = tid / 16; r < 64; r += 8) {
          const int row = tl.m0 + wg * 64 + r;
          if (row >= R) break;
          const float4 a = *reinterpret_cast<const float4*>(ep + ep_at(r, c));
          float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = epilogue(v[e], b[e], act);
          if (res) {
            const bf16* rp = res + (ll)tl.g * srg + (ll)row * srr + col;
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] += __bfloat162float(rp[e]);
          }
          store4(out + ((ll)tl.g * R + row) * N + col, v);
        }
      }
    }
  }
}

constexpr int TM = 64, TN = 64, TK = 16;

template <typename T, typename OutT>
__global__ void __launch_bounds__(256)
gmm_simt(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
         const T* __restrict__ res, OutT* __restrict__ out, int R, int K, int N, ll sxg,
         ll sxr, ll srg, ll srr, int wbatch, const int* __restrict__ widx, int act) {
  __shared__ float xs[TK][TM + 1];
  __shared__ float ws[TK][TN + 1];
  const int g = blockIdx.z, gw = widx ? widx[g] : g / wbatch;
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

// A bf16 tensor map of dims {d0 (contiguous), d1, d2} with byte strides s1, s2
// and boxes of {b0, b1, 1}, 128-byte swizzle, zero fill out of bounds.
bool encode_3d(CUtensorMap* map, const void* base, ll d0, ll d1, ll d2, ll s1, ll s2, int b0,
               int b1) {
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1, (cuuint64_t)s2};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  return encode_bf16(map, base, 3, dims, strides, box);
}

// BN = 256 unless 128-column tiles finish sooner: the serial work of the
// busiest cluster is ceil(walk steps / clusters) steps of BN columns each.
int choose_bn(int G, int R, int N, int clusters) {
  if (N <= 128) return 128;
  const ll m_tiles = (R + TBM - 1) / TBM;
  const ll p256 = G * m_tiles * (((N + 255) / 256 + 1) / 2);
  const ll p128 = G * m_tiles * (((N + 127) / 128 + 1) / 2);
  return ((p256 + clusters - 1) / clusters) * 256 <= ((p128 + clusters - 1) / clusters) * 128
             ? 256
             : 128;
}

// How many 2-CTA clusters of gmm_wgmma<BN, OutT, READ> the card holds at
// once (a cluster needs two free SMs of one GPC), cached per device.
template <int BN, typename OutT, bool READ = false>
int resident_clusters() {
  static int count[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (count[dev] == 0) {
    cudaFuncSetAttribute(gmm_wgmma<BN, OutT, READ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         TcCfg<BN>::SMEM);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 2;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2 * sm_count(), 1, 1);
    cfg.blockDim = dim3(TC_THREADS, 1, 1);
    cfg.dynamicSmemBytes = TcCfg<BN>::SMEM;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, gmm_wgmma<BN, OutT, READ>, &cfg) != cudaSuccess ||
        n < 1)
      n = sm_count() / 2;
    count[dev] = n;
  }
  return count[dev];
}

template <int BN, typename OutT, bool READ = false>
cudaError_t launch_tc_bn(const CUtensorMap& mx, const CUtensorMap& mw, const void* bias,
                         const void* res, void* out, int G, int R, int K, int N, ll srg, ll srr,
                         int wbatch, const int* widx, int act, cudaStream_t s,
                         const float* den = nullptr) {
  const int clusters = resident_clusters<BN, OutT, READ>();
  const int m_tiles = (R + TBM - 1) / TBM, n_pairs = ((N + BN - 1) / BN + 1) / 2;
  const int tiles = G * m_tiles * n_pairs;   // walk steps: two column tiles each
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 2;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * (tiles < clusters ? tiles : clusters), 1, 1);
  cfg.blockDim = dim3(TC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = TcCfg<BN>::SMEM;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gmm_wgmma<BN, OutT, READ>, mx, mw,
                            static_cast<const bf16*>(bias), static_cast<const bf16*>(res),
                            static_cast<OutT*>(out), R, K, N, srg, srr, wbatch, widx, act,
                            m_tiles, n_pairs, tiles, den);
}

// The TMA + wgmma route, or cudaErrorInvalidValue where its operands do not
// allow it (the caller's route() should have sent those to gmm_simt).
template <typename OutT>
cudaError_t launch_tc(const void* x, const void* w, const void* bias, const void* res,
                      void* out, int G, int R, int K, int N, ll sxg, ll sxr, ll srg, ll srr,
                      int wbatch, const int* widx, int wgroups, int act, cudaStream_t s) {
  if (K <= 0 || K % 8 || N % 8 || sxg <= 0 || sxr <= 0 || sxg % 8 || sxr % 8 ||
      !aligned16(x) || !aligned16(w) || !aligned16(out))
    return cudaErrorInvalidValue;
  CUtensorMap mx, mw;   // x in 64-row half tiles, one per CTA of a cluster
  if (!encode_3d(&mx, x, K, R, G, sxr * 2, sxg * 2, TBK, TBM / 2) ||
      !encode_3d(&mw, w, N, K, wgroups, (ll)N * 2, (ll)K * N * 2, 64, TBK))
    return cudaErrorInvalidValue;
  if (choose_bn(G, R, N, resident_clusters<256, OutT>()) == 256)
    return launch_tc_bn<256, OutT>(mx, mw, bias, res, out, G, R, K, N, srg, srr, wbatch, widx,
                                   act, s);
  return launch_tc_bn<128, OutT>(mx, mw, bias, res, out, G, R, K, N, srg, srr, wbatch, widx,
                                 act, s);
}

template <typename T, typename OutT>
void launch_simt(const void* x, const void* w, const void* bias, const void* res, void* out,
                 int G, int R, int K, int N, ll sxg, ll sxr, ll srg, ll srr, int wbatch,
                 const int* widx, int act, cudaStream_t s) {
  dim3 grid((N + TN - 1) / TN, (R + TM - 1) / TM, G);
  gmm_simt<T, OutT><<<grid, 256, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<const T*>(res), static_cast<OutT*>(out), R, K, N, sxg, sxr, srg, srr,
      wbatch, widx, act);
}

}  // namespace

// x [G,R,K] through (group, row) strides; w [wgroups,K,N] with wgroups =
// G/wbatch, or any depth with a layer index widx (int32 [G], values in
// [0, wgroups); wbatch is then 1); bias [wgroups,N] or null; res [G,R,N]
// through (group, row) strides, or null; out [G,R,N]. dtype: 0 float32, 1
// bfloat16 (x, w, bias, res); out_f32: 1 writes fp32, 0 the input dtype.
// act: 0 none, 1 silu, 2 tanh-gelu (applied before res is added). tc: 1 the
// TMA + wgmma route (bf16 only; refused with cudaErrorInvalidValue where
// the operands do not allow it), 0 gmm_simt.
extern "C" int gmm_launch(const void* x, const void* w, const void* bias, const void* res,
                          void* out, int G, int R, int K, int N, long long sxg, long long sxr,
                          long long srg, long long srr, int wbatch, const void* layer_index,
                          int wgroups, int dtype, int out_f32, int act, int tc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* widx = static_cast<const int*>(layer_index);
  if (wbatch < 1 || wgroups < 1 || (widx == nullptr && wgroups * wbatch != G) ||
      (widx != nullptr && wbatch != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tc) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        out_f32 ? launch_tc<float>(x, w, bias, res, out, G, R, K, N, sxg, sxr, srg, srr, wbatch,
                                   widx, wgroups, act, s)
                : launch_tc<bf16>(x, w, bias, res, out, G, R, K, N, sxg, sxr, srg, srr, wbatch,
                                  widx, wgroups, act, s));
  }
  if (dtype == 1) {
    if (out_f32)
      launch_simt<bf16, float>(x, w, bias, res, out, G, R, K, N, sxg, sxr, srg, srr, wbatch,
                               widx, act, s);
    else
      launch_simt<bf16, bf16>(x, w, bias, res, out, G, R, K, N, sxg, sxr, srg, srr, wbatch,
                              widx, act, s);
  } else {
    launch_simt<float, float>(x, w, bias, res, out, G, R, K, N, sxg, sxr, srg, srr, wbatch,
                              widx, act, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// armt_read's bf16 product (csrc/armt_memory.cu): out [N,T,Dv] bf16
// contiguous = rnd((phi_hi A_hi + phi_hi A_lo + phi_lo A_hi) / den), from
// the split operands Phi [N,2,T,sp] (hi, lo) and W [N,2,P,sw] (hi, lo)
// bf16 and den [N,T] fp32; sp and sw are row strides, multiples of 8, at
// least P and Dv. K runs over the three terms in that order, each term's
// tiles loaded from its halves (TMA's zero fill past P), which is the
// order of one K = 3P product of [phi_hi | phi_hi | phi_lo] and [A_hi;
// A_lo; A_hi].
extern "C" int armt_read_gemm_launch(const void* phi, const void* W, const void* den, void* out,
                                     int N, int T, int P, int Dv, long long sp, long long sw,
                                     void* stream) {
  if (N <= 0 || T <= 0 || P <= 0 || Dv <= 0 || sp % 8 || sw % 8 || sp < P || sw < Dv ||
      !aligned16(phi) || !aligned16(W) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mw;
  if (!encode_3d(&mx, phi, P, T, 2LL * N, sp * 2, (ll)T * sp * 2, TBK, TBM / 2) ||
      !encode_3d(&mw, W, Dv, P, 2LL * N, sw * 2, (ll)P * sw * 2, 64, TBK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(den);
  if (choose_bn(N, T, Dv, resident_clusters<256, bf16, true>()) == 256)
    return static_cast<int>(launch_tc_bn<256, bf16, true>(mx, mw, nullptr, nullptr, out, N, T, P,
                                                          Dv, 0, 0, 1, nullptr, 0, s, d));
  return static_cast<int>(launch_tc_bn<128, bf16, true>(mx, mw, nullptr, nullptr, out, N, T, P,
                                                        Dv, 0, 0, 1, nullptr, 0, s, d));
}
