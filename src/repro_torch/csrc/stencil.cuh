// The Sobel stencil shared by sobel.cu and canny_fused.cu.
//
// It is the arithmetic of repro/kernels/sobel/ref.py in the same order:
// gx = (tr + 2*mr + br) - (tl + 2*ml + bl), and gy likewise, then
// sqrt(gx*gx + gy*gy) and round(atan2(gy, gx) / (pi/4)) mod 4.  Every
// multiply and add goes through a _rn intrinsic, which nvcc never fuses
// into an FMA, so the result matches PyTorch's one-op-per-kernel plain
// version bit for bit whatever --fmad says.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// f32(pi / 4), the divisor jnp.pi / 4 rounds to
constexpr float kQuarterPi = 0.785398163397448309616f;

// the gradients gx, gy of a 3x3 neighbourhood (t: top, m: middle, b:
// bottom row; l, c, r: left, centre, right column)
__device__ __forceinline__ void sobel_grad(float tl, float tc, float tr,
                                           float ml, float mr, float bl,
                                           float bc, float br, float* gx,
                                           float* gy) {
  *gx = __fsub_rn(__fadd_rn(__fadd_rn(tr, __fmul_rn(2.0f, mr)), br),
                  __fadd_rn(__fadd_rn(tl, __fmul_rn(2.0f, ml)), bl));
  *gy = __fsub_rn(__fadd_rn(__fadd_rn(bl, __fmul_rn(2.0f, bc)), br),
                  __fadd_rn(__fadd_rn(tl, __fmul_rn(2.0f, tc)), tr));
}

__device__ __forceinline__ float sobel_mag(float gx, float gy) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)));
}

// the direction quantized to 4 bins: rintf rounds half to even, as
// jnp.round and torch.round do; the modulo is taken non-negative, as
// Python's % is
__device__ __forceinline__ int sobel_dir(float gx, float gy) {
  const int q = static_cast<int>(rintf(__fdiv_rn(atan2f(gy, gx),
                                                 kQuarterPi)));
  return ((q % 4) + 4) % 4;
}

__device__ __forceinline__ void sobel_stencil(
    float tl, float tc, float tr, float ml, float mr, float bl, float bc,
    float br, float* mag, int* dir) {
  float gx, gy;
  sobel_grad(tl, tc, tr, ml, mr, bl, bc, br, &gx, &gy);
  *mag = sobel_mag(gx, gy);
  *dir = sobel_dir(gx, gy);
}

}  // namespace repro_torch
