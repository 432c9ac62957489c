// The whole Canny edge stage in one launch: 5-tap gaussian blur -> Sobel
// -> 4-direction non-maximum suppression -> double threshold -> 8
// hysteresis dilations, img [b, h, w] f32 -> edge map [b, h, w] bool.
//
// Replaces the TPU kernel
// repro/kernels/canny_fused/canny_fused.py::canny_edge_pallas
// (_canny_kernel), and computes what repro_torch/kernels/canny_fused/ref.py
// computes, bit for bit.
//
// Design.  One block owns one 64 x 64 output tile.  It works on a window:
// the tile and HALO pixels around it, clipped to the frame's TRUE extent
// (the per-frame `dims`, not the array's).  All five stages run on the
// whole window in shared memory and only the bool tile is written: no
// intermediate map touches device memory.  A stage that reads past the
// window's edge takes the rule of the frame's edge: the raw input and the
// BLURRED frame are replicated (the index is clamped), the magnitude is
// zero, strong and weak are False.  Where the window's edge is the frame's
// edge that is the plain version's rule; where it is not, the value read
// is wrong, and the error moves one stage radius inward a stage, HALO = 2
// (blur) + 1 (Sobel) + 1 (NMS) + 8 (hysteresis) pixels in all, so it never
// reaches the tile.  A frame that fits one tile (the gateway's 64 x 64)
// is its own window: one block a frame, no halo, each pixel read once.
// Larger frames take windows of up to 88 x 88 for a 64 x 64 tile (1.9
// times the tile's pixels).
//
// Stages: the raw window; the horizontal blur; the vertical blur; the
// gradient magnitude; then, one warp a row, non-maximum suppression and
// the double threshold, whose booleans __ballot_sync packs into 32-bit
// words (bit c of word s: column 32 s + c).  The direction is worked out
// only where it can matter (a pixel whose magnitude is at most both
// non-negative thresholds is neither strong nor weak whatever it is), and
// by atan2 only near a bin's edge (canny_dir).  512 threads a block (1024
// when a block owns a whole frame).  The 8 hysteresis rounds run in one
// warp's registers on the packed rows: a lane holds a few consecutive
// rows, a round ORs each row with its shifts by one column and its
// neighbour rows (from the lanes beside it by shuffles) and ANDs weak.
// Six barriers a block, where the byte-map design took thirteen and read
// nine bytes a pixel a round.
//
// Bound on the H100: memory.  The function reads 4 B and writes 1 B per
// pixel; at (8, 1080, 1920) that is 83 MB, about 25 us at 3.35 TB/s.  The
// arithmetic, ~100 flops a window pixel for the blur and the magnitude,
// with the halo's 1.9x, is of the same order at the card's f32 rate.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stencil.cuh"

namespace {

constexpr int TILE = 64;
constexpr int ITERS = 8;                   // HYSTERESIS_ITERS of the ref
constexpr int HALO = 2 + 1 + 1 + ITERS;    // 12

struct Gauss {
  float k[5];
};

// a window of up to W x W pixels and the block's threads: 64 x 64 and
// 1024 threads for frames that fit one tile (few blocks, each a whole
// frame), TILE + 2 HALO = 88 and 512 threads otherwise (three blocks an SM)
template <int W>
struct Win {
  static constexpr int NT = W == TILE ? 1024 : 512;
  static constexpr int NSEG = (W + 31) / 32;  // 32-bit words a row
  static constexpr int RPL = (W + 31) / 32;   // rows a lane, hysteresis
  static constexpr size_t smem = sizeof(float) * 2 * W * W + W * W +
                                 sizeof(uint32_t) * 2 * W * NSEG;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// the 5-tap blur of p[0], p[S], ..., p[4 S], taps summed in order
template <int S>
__device__ __forceinline__ float blur5(const float* p, const Gauss& g) {
  float acc = __fmul_rn(p[0], g.k[0]);
#pragma unroll
  for (int t = 1; t < 5; ++t)
    acc = __fadd_rn(acc, __fmul_rn(p[t * S], g.k[t]));
  return acc;
}

// sobel_dir without atan2 where the ratio |gy| / |gx| lies clear of the
// bins' edges, tan(pi / 8) and tan(3 pi / 8), by 2^-10 of itself: that
// moves the angle by ~3e-4 rad, where atan2f's and the division's
// rounding move it by ~1e-6 of itself, so the bin is certain.  Near an
// edge, and for gradients that are tiny, infinite or NaN, sobel_dir
// decides.
__device__ __forceinline__ int canny_dir(float gx, float gy) {
  constexpr float T1 = 0.414213562373095f, T2 = 2.414213562373095f;
  constexpr float E = 1.0f / 1024.0f;
  const float ax = fabsf(gx), ay = fabsf(gy);
  if (ax + ay > 1e-30f && ax + ay < 1e30f) {
    if (ay < ax * (T1 * (1.0f - E))) return 0;
    if (ay > ax * (T2 * (1.0f + E))) return 2;
    if (ay > ax * (T1 * (1.0f + E)) && ay < ax * (T2 * (1.0f - E)))
      return (gx > 0.0f) == (gy > 0.0f) ? 1 : 3;
  }
  return repro_torch::sobel_dir(gx, gy);
}

template <int WC>
__global__ void __launch_bounds__(Win<WC>::NT)
canny_kernel(const float* __restrict__ img, const int* __restrict__ dims,
             unsigned char* __restrict__ out, int H, int W, float lo,
             float hi, Gauss g) {
  constexpr int WR = WC, NT = Win<WC>::NT;
  constexpr int NSEG = Win<WC>::NSEG, RPL = Win<WC>::RPL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* fa = reinterpret_cast<float*>(smem_raw);  // raw, then blurred
  float* fb = fa + WR * WC;        // horizontal blur, then magnitude
  uint32_t* sbits = reinterpret_cast<uint32_t*>(fb + WR * WC);  // strong
  uint32_t* wbits = sbits + WR * NSEG;                          // weak
  unsigned char* dir = reinterpret_cast<unsigned char*>(wbits + WR * NSEG);

  const int b = blockIdx.z;
  const int h = dims ? dims[2 * b] : H;    // this frame's true extent
  const int w = dims ? dims[2 * b + 1] : W;
  const int R0 = blockIdx.y * TILE, C0 = blockIdx.x * TILE;  // the tile
  const int r0 = max(0, R0 - HALO), c0 = max(0, C0 - HALO);  // the window
  const int nr = min(h, R0 + TILE + HALO) - r0;
  const int nc = min(w, C0 + TILE + HALO) - c0;
  const bool any = R0 < h && C0 < w;  // else the tile lies past the frame
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  if (any) {
    // the raw window, every load of a thread in flight at once
    constexpr int PER = (WR * WC + NT - 1) / NT;
    const float* x = img + static_cast<size_t>(b) * H * W;
    float raw[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * NT, r = i / WC, c = i % WC;
      raw[j] = r < nr && c < nc
                   ? x[static_cast<size_t>(r0 + r) * W + c0 + c]
                   : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (tid + j * NT < WR * WC) fa[tid + j * NT] = raw[j];
    __syncthreads();

    // horizontal blur, taps t = 0..4 summed in order; the clamped reads
    // only within 2 pixels of the window's edge
    for (int i = tid; i < nr * WC; i += NT) {
      const int r = i / WC, c = i % WC;
      if (c >= nc) continue;
      if (c >= 2 && c + 2 < nc) {
        fb[i] = blur5<1>(fa + i - 2, g);
      } else {
        const float* row = fa + r * WC;
        float acc = __fmul_rn(row[clampi(c - 2, 0, nc - 1)], g.k[0]);
#pragma unroll
        for (int t = 1; t < 5; ++t)
          acc = __fadd_rn(acc, __fmul_rn(row[clampi(c - 2 + t, 0, nc - 1)],
                                         g.k[t]));
        fb[i] = acc;
      }
    }
    __syncthreads();

    // vertical blur
    for (int i = tid; i < nr * WC; i += NT) {
      const int r = i / WC, c = i % WC;
      if (c >= nc) continue;
      if (r >= 2 && r + 2 < nr) {
        fa[i] = blur5<WC>(fb + i - 2 * WC, g);
      } else {
        float acc = __fmul_rn(fb[clampi(r - 2, 0, nr - 1) * WC + c], g.k[0]);
#pragma unroll
        for (int t = 1; t < 5; ++t)
          acc = __fadd_rn(acc, __fmul_rn(
                                   fb[clampi(r - 2 + t, 0, nr - 1) * WC + c],
                                   g.k[t]));
        fa[i] = acc;
      }
    }
    __syncthreads();

    // gradient magnitude over the blurred window, replicated at its edge,
    // and the direction where it can matter: a pixel whose magnitude is at
    // most both (non-negative) thresholds is neither strong nor weak
    const bool may_skip = lo >= 0.f && hi >= 0.f;
    for (int i = tid; i < nr * WC; i += NT) {
      const int r = i / WC, c = i % WC;
      if (c >= nc) continue;
      float gx, gy;
      if (r >= 1 && r + 1 < nr && c >= 1 && c + 1 < nc) {
        const float* p = fa + i;
        repro_torch::sobel_grad(p[-WC - 1], p[-WC], p[-WC + 1], p[-1], p[1],
                                p[WC - 1], p[WC], p[WC + 1], &gx, &gy);
      } else {
        const float* u = fa + max(r - 1, 0) * WC;
        const float* m = fa + r * WC;
        const float* d = fa + min(r + 1, nr - 1) * WC;
        const int cl = max(c - 1, 0), cr = min(c + 1, nc - 1);
        repro_torch::sobel_grad(u[cl], u[c], u[cr], m[cl], m[cr], d[cl],
                                d[c], d[cr], &gx, &gy);
      }
      const float mag = repro_torch::sobel_mag(gx, gy);
      fb[i] = mag;
      if (!(may_skip && mag <= lo && mag <= hi))
        dir[i] = static_cast<unsigned char>(canny_dir(gx, gy));
    }
    __syncthreads();

    // NMS along the quantized direction (the magnitude is zero outside the
    // window), then the double threshold; one warp a row
    for (int r = warp; r < nr; r += NT / 32) {
#pragma unroll
      for (int s = 0; s < NSEG; ++s) {
        const int c = 32 * s + lane;
        bool strong = false, weak = false;
        const float m = c < nc ? fb[r * WC + c] : 0.f;
        if (c < nc && !(may_skip && m <= lo && m <= hi)) {
          int dr, dc;  // the neighbour (r + dr, c + dc) and its mirror
          switch (dir[r * WC + c]) {
            case 0: dr = 0; dc = 1; break;   // E/W
            case 1: dr = 1; dc = 1; break;   // SE/NW
            case 2: dr = 1; dc = 0; break;   // S/N
            default: dr = 1; dc = -1; break; // SW/NE
          }
          auto mag = [&](int rr, int cc) {
            return rr >= 0 && rr < nr && cc >= 0 && cc < nc ? fb[rr * WC + cc]
                                                            : 0.0f;
          };
          const float a = mag(r + dr, c + dc), bb = mag(r - dr, c - dc);
          const float keep = (m >= a && m >= bb) ? 1.0f : 0.0f;
          const float thin = __fmul_rn(m, keep);
          strong = thin > hi;
          weak = thin > lo;
        }
        const uint32_t sb = __ballot_sync(0xffffffffu, strong);
        const uint32_t wb = __ballot_sync(0xffffffffu, weak);
        if (lane == 0) {
          sbits[r * NSEG + s] = sb;
          wbits[r * NSEG + s] = wb;
        }
      }
    }
    __syncthreads();

    // hysteresis: grow strong into weak through 3x3 neighbourhoods (zero
    // outside the window), in warp 0: lane l holds rows RPL l .. RPL l +
    // RPL - 1, and takes the rows beside its own from lanes l - 1, l + 1
    if (warp == 0) {
      uint32_t st[RPL][NSEG], wk[RPL][NSEG];
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        const int r = RPL * lane + k;
#pragma unroll
        for (int s = 0; s < NSEG; ++s) {
          st[k][s] = r < nr ? sbits[r * NSEG + s] : 0u;
          wk[k][s] = r < nr ? wbits[r * NSEG + s] : 0u;
        }
      }
#pragma unroll
      for (int it = 0; it < ITERS; ++it) {
        uint32_t hd[RPL][NSEG];  // each row OR its shifts by one column
#pragma unroll
        for (int k = 0; k < RPL; ++k)
#pragma unroll
          for (int s = 0; s < NSEG; ++s) {
            const uint32_t x = st[k][s];
            const uint32_t left = (x << 1) | (s > 0 ? st[k][s - 1] >> 31 : 0u);
            const uint32_t right =
                (x >> 1) | (s + 1 < NSEG ? st[k][s + 1] << 31 : 0u);
            hd[k][s] = x | left | right;
          }
#pragma unroll
        for (int s = 0; s < NSEG; ++s) {
          uint32_t up = __shfl_up_sync(0xffffffffu, hd[RPL - 1][s], 1);
          uint32_t dn = __shfl_down_sync(0xffffffffu, hd[0][s], 1);
          if (lane == 0) up = 0u;
          if (lane == 31) dn = 0u;
#pragma unroll
          for (int k = 0; k < RPL; ++k) {
            const uint32_t above = k > 0 ? hd[k - 1][s] : up;
            const uint32_t below = k + 1 < RPL ? hd[k + 1][s] : dn;
            st[k][s] = wk[k][s] & (above | hd[k][s] | below);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        const int r = RPL * lane + k;
        if (r < nr)
#pragma unroll
          for (int s = 0; s < NSEG; ++s) sbits[r * NSEG + s] = st[k][s];
      }
    }
    __syncthreads();
  }

  // the tile, four columns a thread; False past the frame's true extent
  unsigned char* o = out + static_cast<size_t>(b) * H * W;
  for (int i = tid; i < TILE * TILE / 4; i += NT) {
    const int gr = R0 + i / (TILE / 4), gc = C0 + (i % (TILE / 4)) * 4;
    if (gr >= H || gc >= W) continue;
    uint32_t bits = 0u;
    if (any && gr < h) {
      // the window's column of gc is a multiple of 4: one word holds all 4
      const int wc = gc - c0;
      bits = (sbits[(gr - r0) * NSEG + wc / 32] >> (wc % 32)) & 0xFu;
    }
    const uint32_t v = (bits & 1u) | ((bits >> 1) & 1u) << 8 |
                       ((bits >> 2) & 1u) << 16 | ((bits >> 3) & 1u) << 24;
    unsigned char* p = o + static_cast<size_t>(gr) * W + gc;
    if (W % 4 == 0) {
      *reinterpret_cast<uint32_t*>(p) = v;
    } else {
      for (int e = 0; e < 4 && gc + e < W; ++e) p[e] = (v >> (8 * e)) & 1u;
    }
  }
}

template <int WC>
int launch(const float* img, const int* dims, unsigned char* out, int b,
           int h, int w, float lo, float hi, const Gauss& g,
           cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      canny_kernel<WC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Win<WC>::smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, b);
  canny_kernel<WC><<<grid, Win<WC>::NT, Win<WC>::smem, stream>>>(
      img, dims, out, h, w, lo, hi, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img [b, h, w] f32 and out [b, h, w] bool, contiguous on the device;
// dims [b, 2] i32 (true height, width of each frame, at most h, w) on the
// device, or null for frames that fill the array; k the 5 gaussian weights
// (host).  Launches on `stream` and returns cudaGetLastError() (0 =
// launched).
extern "C" int canny_edge(const float* img, const int* dims,
                          unsigned char* out, int b, int h, int w, float lo,
                          float hi, const float* k, void* stream) {
  Gauss g;
  for (int t = 0; t < 5; ++t) g.k[t] = k[t];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h <= TILE && w <= TILE)  // every frame is its own window
    return launch<TILE>(img, dims, out, b, h, w, lo, hi, g, s);
  return launch<TILE + 2 * HALO>(img, dims, out, b, h, w, lo, hi, g, s);
}
