// What the Mamba scan's forward (mamba_scan.cu) and backward
// (mamba_scan_bwd.cu) kernels share: the exponential and softplus they
// compute the step with, so that the backward's recomputed states are the
// forward's bits, and the token tile (the kept states' chunk is a multiple
// of it).
#pragma once

#include <math.h>

#include "common.cuh"

namespace rk {
namespace scan {

typedef __nv_bfloat16 bf16;
typedef long long ll;

constexpr int TT = 16;                // the forward's tokens per tile
constexpr float LOG2E = 1.4426950408889634f;

// exp2 on the special-function unit: exp(dt * A) = ex2(dt * A * log2(e))
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// F.softplus(u) with beta 1 and threshold 20, as PyTorch's CUDA kernel
// computes it
__device__ __forceinline__ float softplus(float u) {
  return u > 20.f ? u : log1pf(expf(u));
}

}  // namespace scan
}  // namespace rk
