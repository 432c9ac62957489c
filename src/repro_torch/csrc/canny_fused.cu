// The whole Canny edge stage in one launch: 5-tap gaussian blur -> Sobel
// -> 4-direction non-maximum suppression -> double threshold -> 8
// hysteresis dilations, img [b, h, w] f32 -> edge map [b, h, w] bool.
//
// Replaces the TPU kernel
// repro/kernels/canny_fused/canny_fused.py::canny_edge_pallas
// (_canny_kernel), and computes what repro_torch/kernels/canny_fused/ref.py
// computes, bit for bit.
//
// Design.  One block owns one TILE x TILE output tile.  It loads the tile
// and a HALO-pixel ring around it into shared memory, runs all five stages
// there with __syncthreads() between stages and between the dilation
// rounds, and writes only the bool tile: no intermediate map touches
// device memory.  HALO = 2 (blur) + 1 (Sobel) + 1 (NMS) + 8 (hysteresis)
// is the receptive field of one output pixel; each stage computes a region
// one radius smaller than the one before, so the tile itself comes out
// exact.  Each stage applies its own rule at the frame's TRUE edge (the
// per-frame `dims`, not the array edge): the raw input is replicated
// before the blur, the BLURRED frame is replicated before Sobel, the
// magnitude is zero outside the frame before NMS, and strong and weak are
// False outside the frame.  Output beyond `dims` is therefore False.
//
// Bound on the H100: memory.  The function reads 4 B and writes 1 B per
// pixel; at (8, 1080, 1920) that is 83 MB, about 25 us at 3.35 TB/s.  The
// arithmetic (~100 flops and one atan2 per pixel, times the (56/32)^2
// halo overhead) stays below the f32 rate for that time only if the
// kernel keeps enough blocks in flight: 37.6 KB of static shared memory a
// block lets six blocks share an SM.
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

constexpr int TILE = 32;
constexpr int ITERS = 8;                   // HYSTERESIS_ITERS of the ref
constexpr int HALO = 2 + 1 + 1 + ITERS;    // 12
constexpr int WIN = TILE + 2 * HALO;       // 56
constexpr int BX = 32, BY = 8;             // 256 threads

struct Gauss {
  float k[5];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(BX * BY)
canny_kernel(const float* __restrict__ img, const int* __restrict__ dims,
             unsigned char* __restrict__ out, int H, int W, float lo,
             float hi, Gauss g) {
  __shared__ float fa[WIN][WIN];           // raw window, then blurred
  __shared__ float fb[WIN][WIN];           // horizontal blur, then |grad|
  __shared__ unsigned char dir[WIN][WIN];
  __shared__ unsigned char weak[WIN][WIN];
  __shared__ unsigned char s0[WIN][WIN];   // strong, ping
  __shared__ unsigned char s1[WIN][WIN];   // strong, pong

  const int b = blockIdx.z;
  const int h = dims ? dims[2 * b] : H;    // this frame's true extent
  const int w = dims ? dims[2 * b + 1] : W;
  const int r0 = blockIdx.y * TILE - HALO; // frame row of window row 0
  const int c0 = blockIdx.x * TILE - HALO;
  const float* x = img + static_cast<size_t>(b) * H * W;
  const int tx = threadIdx.x, ty = threadIdx.y;

  // raw window; the input is replicated at the frame edge
  for (int r = ty; r < WIN; r += BY) {
    const int gr = clampi(r0 + r, 0, h - 1);
    for (int c = tx; c < WIN; c += BX) {
      fa[r][c] = x[static_cast<size_t>(gr) * W + clampi(c0 + c, 0, w - 1)];
    }
  }
  __syncthreads();

  // horizontal blur, taps t = 0..4 summed in order
  for (int r = ty; r < WIN; r += BY) {
    for (int c = 2 + tx; c < WIN - 2; c += BX) {
      float acc = __fmul_rn(fa[r][c - 2], g.k[0]);
      for (int t = 1; t < 5; ++t) {
        acc = __fadd_rn(acc, __fmul_rn(fa[r][c - 2 + t], g.k[t]));
      }
      fb[r][c] = acc;
    }
  }
  __syncthreads();

  // vertical blur
  for (int r = 2 + ty; r < WIN - 2; r += BY) {
    for (int c = 2 + tx; c < WIN - 2; c += BX) {
      float acc = __fmul_rn(fb[r - 2][c], g.k[0]);
      for (int t = 1; t < 5; ++t) {
        acc = __fadd_rn(acc, __fmul_rn(fb[r - 2 + t][c], g.k[t]));
      }
      fa[r][c] = acc;
    }
  }
  __syncthreads();

  // Sobel over the blurred frame, replicated at the frame edge; the
  // magnitude is zero outside the frame (NMS's zero padding)
  for (int r = 3 + ty; r < WIN - 3; r += BY) {
    const int gr = r0 + r;
    const int ru = clampi(gr - 1, 0, h - 1) - r0;
    const int rd = clampi(gr + 1, 0, h - 1) - r0;
    for (int c = 3 + tx; c < WIN - 3; c += BX) {
      const int gc = c0 + c;
      float m = 0.0f;
      int q = 0;
      if (gr >= 0 && gr < h && gc >= 0 && gc < w) {
        const int cl = clampi(gc - 1, 0, w - 1) - c0;
        const int cr = clampi(gc + 1, 0, w - 1) - c0;
        repro_torch::sobel_stencil(fa[ru][cl], fa[ru][c], fa[ru][cr],
                                   fa[r][cl], fa[r][cr],
                                   fa[rd][cl], fa[rd][c], fa[rd][cr], &m, &q);
      }
      fb[r][c] = m;
      dir[r][c] = static_cast<unsigned char>(q);
    }
  }
  __syncthreads();

  // NMS along the quantized direction, then the double threshold
  for (int r = 4 + ty; r < WIN - 4; r += BY) {
    const int gr = r0 + r;
    for (int c = 4 + tx; c < WIN - 4; c += BX) {
      const int gc = c0 + c;
      const float m = fb[r][c];
      float a, bb;
      switch (dir[r][c]) {
        case 0: a = fb[r][c + 1]; bb = fb[r][c - 1]; break;          // E/W
        case 1: a = fb[r + 1][c + 1]; bb = fb[r - 1][c - 1]; break;  // SE/NW
        case 2: a = fb[r + 1][c]; bb = fb[r - 1][c]; break;          // S/N
        default: a = fb[r + 1][c - 1]; bb = fb[r - 1][c + 1]; break; // SW/NE
      }
      const float keep = (m >= a && m >= bb) ? 1.0f : 0.0f;
      const float thin = __fmul_rn(m, keep);
      const bool in = gr >= 0 && gr < h && gc >= 0 && gc < w;
      s0[r][c] = in && thin > hi;
      weak[r][c] = in && thin > lo;
    }
  }
  __syncthreads();

  // hysteresis: grow strong into weak through 3x3 neighbourhoods; round i
  // is exact on a region i pixels narrower than the thresholded one
  for (int it = 0; it < ITERS; ++it) {
    unsigned char (*src)[WIN] = (it % 2 == 0) ? s0 : s1;
    unsigned char (*dst)[WIN] = (it % 2 == 0) ? s1 : s0;
    for (int r = 5 + it + ty; r < WIN - 5 - it; r += BY) {
      for (int c = 5 + it + tx; c < WIN - 5 - it; c += BX) {
        const unsigned char any =
            src[r - 1][c - 1] | src[r - 1][c] | src[r - 1][c + 1] |
            src[r][c - 1] | src[r][c] | src[r][c + 1] |
            src[r + 1][c - 1] | src[r + 1][c] | src[r + 1][c + 1];
        dst[r][c] = any & weak[r][c];
      }
    }
    __syncthreads();
  }

  // ITERS is even, so the last round wrote s0
  unsigned char* o = out + static_cast<size_t>(b) * H * W;
  for (int r = HALO + ty; r < HALO + TILE; r += BY) {
    const int gr = r0 + r;
    if (gr >= H) break;
    for (int c = HALO + tx; c < HALO + TILE; c += BX) {
      const int gc = c0 + c;
      if (gc < W) o[static_cast<size_t>(gr) * W + gc] = s0[r][c];
    }
  }
}

}  // namespace

// img [b, h, w] f32 and out [b, h, w] bool, contiguous on the device;
// dims [b, 2] i32 (true height, width of each frame) on the device, or
// null for frames that fill the array; k the 5 gaussian weights (host).
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int canny_edge(const float* img, const int* dims,
                          unsigned char* out, int b, int h, int w, float lo,
                          float hi, const float* k, void* stream) {
  static_assert(ITERS % 2 == 0, "the output is read from s0");
  Gauss g;
  for (int t = 0; t < 5; ++t) g.k[t] = k[t];
  const dim3 block(BX, BY);
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, b);
  canny_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, dims, out, h, w, lo, hi, g);
  return static_cast<int>(cudaGetLastError());
}
