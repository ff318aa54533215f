// Shared device helpers for the port's Hopper kernels (sm_90a): bf16
// conversion, cp.async, ldmatrix and the m16n8k16 bf16 tensor-core MMA.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (lane = threadIdx.x % 32,
// g = lane / 4, c = (lane % 4) * 2):
//   A (16x16, row-major)  a0: (g, c..c+1)  a1: (g+8, c..)  a2: (g, c+8..)  a3: (g+8, c+8..)
//   B (16x8, k x n)       b0: (k = c..c+1, n = g)          b1: (k = c+8.., n = g)
//   C (16x8, fp32)        c0,c1: (g, c..c+1)               c2,c3: (g+8, c..c+1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rk {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global->shared copy; when !pred the 16 bytes are zero-filled
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(smem)), "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b on the tensor cores, bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// DPFP-nu feature phi[p] of a row q[0..dm): r = [relu(q), relu(-q)] (2dm),
// phi[(j-1)*2dm + i] = r[i] * r[(i - j) mod 2dm] for j = 1..nu (jnp.roll).
__device__ __forceinline__ float dpfp_r(const float* q, int dm, int i) {
  return i < dm ? fmaxf(q[i], 0.f) : fmaxf(-q[i - dm], 0.f);
}
__device__ __forceinline__ float dpfp_at(const float* q, int dm, int p) {
  const int two = 2 * dm;
  const int j = p / two + 1;
  const int i = p - (j - 1) * two;
  int ij = i - j;
  ij = ((ij % two) + two) % two;
  return dpfp_r(q, dm, i) * dpfp_r(q, dm, ij);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace rk
