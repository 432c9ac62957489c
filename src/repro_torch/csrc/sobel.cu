// Sobel gradient magnitude and quantized direction, replicated edges.
//
// Replaces the TPU kernel repro/kernels/sobel/sobel.py::sobel_grad_pallas
// (_sobel_kernel), which held one whole image in VMEM per program.  Here
// one thread computes one pixel from its 3x3 neighbourhood, read straight
// from device memory with the row and column clamped to the image; the
// neighbours a warp reads overlap and are served from L1.
//
// Bound on the H100: memory.  The function reads 4 B and writes 8 B per
// pixel (f32 magnitude, i32 direction) and does ~20 flops and one atan2
// per pixel, far below the card's 67 TFLOP/s of f32 for 3.35 TB/s.
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

__global__ void sobel_kernel(const float* __restrict__ img,
                             float* __restrict__ mag, int* __restrict__ dir,
                             int h, int w) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= h || c >= w) return;
  const size_t plane = static_cast<size_t>(h) * w;
  const float* x = img + blockIdx.z * plane;
  const int ru = max(r - 1, 0), rd = min(r + 1, h - 1);
  const int cl = max(c - 1, 0), cr = min(c + 1, w - 1);
  float m;
  int q;
  repro_torch::sobel_stencil(
      x[ru * w + cl], x[ru * w + c], x[ru * w + cr],
      x[r * w + cl], x[r * w + cr],
      x[rd * w + cl], x[rd * w + c], x[rd * w + cr], &m, &q);
  const size_t at = blockIdx.z * plane + static_cast<size_t>(r) * w + c;
  mag[at] = m;
  dir[at] = q;
}

}  // namespace

// img [b, h, w] f32 -> mag [b, h, w] f32, dir [b, h, w] i32, all
// contiguous on the device.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int sobel_grad(const float* img, float* mag, int* dir, int b,
                          int h, int w, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8, b);
  sobel_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, mag, dir, h, w);
  return static_cast<int>(cudaGetLastError());
}
