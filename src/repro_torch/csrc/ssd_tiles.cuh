// Tiles of the SSD scan's kernels, shared by the forward (csrc/ssd_scan.cu)
// and its gradient (csrc/ssd_scan_bwd.cu): the strides at which both read
// x, dt, B and C (column views of the Mamba-2 block's conv output at any
// element offset, the last dim contiguous), and the copy of a row-major
// bf16 tile into shared memory by cp.async, as wide as the rows' alignment
// allows, zero-filling rows past the tensor and columns past its width.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace repro_torch {

struct Strides {
  long long xb, xs, xh;  // x [b, s, h, p], the last dim contiguous
  long long db, ds, dh;  // dt [b, s, h]
  long long bb, bs;      // B [b, s, n], the last dim contiguous
  long long cb, cs;      // C [b, s, n], the last dim contiguous
};

__host__ __device__ inline float* align32(float* p) {
  return reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(p) + 31) &
                                  ~static_cast<uintptr_t>(31));
}

// rows [0, nrows) x columns [0, width) of a bf16 matrix (row r at src +
// r * stride, ncols columns) into dst[r * ld + c], vec elements a copy, by
// the NT threads of the block; rows >= nvalid and columns >= ncols become 0
template <int NT>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src,
                                          long long stride, int nrows,
                                          int nvalid, int width, int ncols,
                                          int vec) {
  auto piece = [&](int r, int col) {
    const bool ok = r < nvalid && col < ncols;
    const __nv_bfloat16* from = src + (ok ? r * stride + col : 0);
    __nv_bfloat16* to = dst + r * ld + col;
    if (vec == 8)
      cp_async16(to, from, ok);
    else if (vec == 4)
      cp_async8(to, from, ok);
    else if (vec == 2)
      cp_async4(to, from, ok);
    else
      *to = ok ? *from : __float2bfloat16_rn(0.f);
  };
  const int per_row = width / vec;
  if (NT % per_row == 0) {  // a thread keeps its column: no division a piece
    const int col = threadIdx.x % per_row * vec;
    for (int r = threadIdx.x / per_row; r < nrows; r += NT / per_row)
      piece(r, col);
  } else {
    for (int c = threadIdx.x; c < nrows * per_row; c += NT)
      piece(c / per_row, c % per_row * vec);
  }
}

// the widest copy (8, 4, 2 or 1 elements) that every row start (base plus
// any multiple of the strides) and the row's ncols allow
inline int vec_of(const void* base, const long long* strides, int nstrides,
                  int ncols) {
  for (int v = 8; v > 1; v /= 2) {
    bool ok = reinterpret_cast<uintptr_t>(base) % (2 * v) == 0 &&
              ncols % v == 0;
    for (int i = 0; i < nstrides; ++i) ok = ok && strides[i] % v == 0;
    if (ok) return v;
  }
  return 1;
}

}  // namespace repro_torch
