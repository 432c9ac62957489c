// Tile helpers shared by the flash-attention and flash-decode kernels:
// element conversion and the cooperative load of a tile of rows from
// device memory into shared memory as f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr float NEG_INF = -1e30f;  // the JAX kernels' mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Copy rows [0, nrows) of a tile (row r of D elements at base + r * stride)
// into dst[r * ld + c] as f32, in 16-byte loads; rows >= nvalid become 0 so
// that masked columns never carry garbage into a sum.  The caller
// guarantees 16-byte alignment of base and of stride * sizeof(T).
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* base,
                                          long long stride, int nrows,
                                          int nvalid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < nrows * CPR; c += blockDim.x) {
    const int r = c / CPR, col = (c % CPR) * VEC;
    float* out = dst + r * ld + col;
    if (r < nvalid) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(base + r * stride + col);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[i] = to_f32(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[i] = 0.f;
    }
  }
}

// tanh softcap (cap <= 0: none), as the JAX kernels apply it
__device__ __forceinline__ float apply_softcap(float x, float cap) {
  return cap > 0.f ? tanhf(x / cap) * cap : x;
}

}  // namespace repro_torch
