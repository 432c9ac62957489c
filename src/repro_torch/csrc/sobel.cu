// Sobel gradient magnitude and quantized direction, replicated edges.
//
// Replaces the TPU kernel repro/kernels/sobel/sobel.py::sobel_grad_pallas
// (_sobel_kernel), which held one whole image in VMEM per program.  A
// 1080p frame (8.3 MB) does not fit a block's 227 KB of shared memory, so
// here each shuffle segment of a warp streams a strip of R rows down its
// image, its 3x3 windows held in registers.
//
// What bounds it on the H100:
// - bytes: it reads 4 B and writes 8 B a pixel (f32 magnitude, i32
//   direction), so at 3.35 TB/s the card must finish ~279 G pixels/s;
// - the issue rate: ~1.05e12 warp-instructions/s (132 SMs x 4 schedulers
//   x ~1.98 GHz) leave ~120 lane-instructions a pixel before the ALUs, not
//   the memory, set the pace, and the exact arithmetic of
//   repro_torch::sobel_stencil (IEEE sqrt and division, atan2f, rintf,
//   shared with the Canny kernel, whose output holds it bit for bit) takes
//   most of them.
//
// What the design does about each:
// - a lane owns 4 adjacent columns: one 16-byte load a row on the
//   read-only path, one float4 and one int4 store, so a warp moves 512 B of
//   a row in one instruction and spends no index math per neighbour;
// - the window rolls down the strip in registers: every input row is read
//   once, plus one halo row above and below the strip, and row r + 2 is
//   loaded before row r is computed, so the load overlaps the arithmetic;
// - left and right neighbours come from the adjacent lanes by shuffles;
//   only a segment's end lanes load one scalar.  Images up to 64 columns
//   wide use segments of 8 or 16 lanes, one image row each, so no lane
//   idles on the gateway's 64 x 64 frames;
// - the launcher picks R, a template argument, so that the grid holds
//   about one wave of resident warps, which keeps ~2 MB of loads in flight
//   (strips of 32 rows at 8 x 1080p, of 1 row for the gateway's batch);
//   halo rows then come mostly from L2.  64 registers a thread at most
//   keep 32 warps on an SM;
// - a batch too small for that wave even at 1 row (a few dozen 64 x 64
//   frames) is latency-bound: a lane's sobel_stencil calls run one after
//   the other, since the branches of the math library's division, square
//   root and atan2f keep them from overlapping, so there a lane takes 2
//   columns (8-byte accesses) and the chain is half as long.
// Rows that cannot be read a vector at a time (a width the vector does not
// divide, or a pointer off its alignment) run the same kernel with scalar
// loads and stores (VEC = false), chosen by the launcher.  Every pixel goes
// through repro_torch::sobel_stencil, so the outputs equal those of the
// kernel that read each neighbour from memory, bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

#include "stencil.cuh"

namespace {

constexpr int kWarps = 8;  // warps a block
// blocks an SM holds: 64 registers a thread at most
constexpr int kBlocksPerSM = 4;
constexpr unsigned kAll = 0xffffffffu;
// ~one wave of resident warps (132 SMs x 32 warps at 64 registers a
// thread), which keeps ~2 MB of loads in flight at 512 bytes a warp
constexpr long long kWarpsInFlight = 3840;

// n / d for n < 2^31 as a multiply-high and a shift (Granlund and
// Montgomery's method), so that a lane finds its segment without the
// ~20 dependent instructions of an integer division
struct Divisor {
  unsigned d, m, s;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return d == 1 ? n : __umulhi(n, m) >> s;
  }
};

Divisor divisor(unsigned d) {
  if (d == 1) return {1, 0, 0};
  int l = 0;  // ceil(log2(d))
  while ((1ull << l) < d) ++l;
  const unsigned long long p = 31 + l;
  return {d, static_cast<unsigned>(((1ull << p) + d - 1) / d),
          static_cast<unsigned>(p - 32)};
}

// the vector types of C columns
template <int C> struct Vec;
template <> struct Vec<4> { using F = float4; using I = int4; };
template <> struct Vec<2> { using F = float2; using I = int2; };

// one input row as a lane loads it: its C columns and, for a segment's end
// lanes, the column beyond each end
template <int C>
struct Raw {
  float v[C];
  float l, r;
};

// one input row as a lane computes with it: the column left of its C, the
// C, the column right of them
template <int C>
struct Row {
  float v[C + 2];
};

template <int C, bool VEC>
__device__ __forceinline__ Raw<C> load_row(const float* row, int col, int w,
                                           bool first, bool last) {
  Raw<C> x;
  if (VEC) {
    const typename Vec<C>::F v =
        __ldg(reinterpret_cast<const typename Vec<C>::F*>(row + col));
    const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
    for (int k = 0; k < C; ++k) x.v[k] = f[k];
  } else {  // clamped: past the row's end each column repeats its last
#pragma unroll
    for (int k = 0; k < C; ++k) x.v[k] = __ldg(row + min(col + k, w - 1));
  }
  x.l = first && col > 0 ? __ldg(row + col - 1) : 0.0f;
  x.r = last && col + C < w ? __ldg(row + col + C) : 0.0f;
  return x;
}

// the neighbours from the adjacent lanes of an S-lane segment; the ends
// take the scalar they loaded, or the replicated edge
template <int S, int C>
__device__ __forceinline__ Row<C> extend(const Raw<C>& x, int col, int w,
                                         bool first, bool last) {
  const float l = __shfl_up_sync(kAll, x.v[C - 1], 1, S);
  const float r = __shfl_down_sync(kAll, x.v[0], 1, S);
  Row<C> y;
  y.v[0] = first ? (col > 0 ? x.l : x.v[0]) : l;
#pragma unroll
  for (int k = 0; k < C; ++k) y.v[k + 1] = x.v[k];
  y.v[C + 1] = last ? (col + C < w ? x.r : x.v[C - 1]) : r;
  return y;
}

// the C pixels of a row from the rows above (t), at (m) and below (b)
template <int C>
__device__ __forceinline__ void stencil_row(const Row<C>& t, const Row<C>& m,
                                            const Row<C>& b, float* mag,
                                            int* dir) {
#pragma unroll
  for (int k = 0; k < C; ++k)
    repro_torch::sobel_stencil(t.v[k], t.v[k + 1], t.v[k + 2], m.v[k],
                               m.v[k + 2], b.v[k], b.v[k + 1], b.v[k + 2],
                               &mag[k], &dir[k]);
}

template <int C, bool VEC>
__device__ __forceinline__ void store_row(float* mag, int* dir, int col,
                                          int w, const float* m,
                                          const int* q) {
  if (VEC) {
    typename Vec<C>::F mv;
    typename Vec<C>::I qv;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      reinterpret_cast<float*>(&mv)[k] = m[k];
      reinterpret_cast<int*>(&qv)[k] = q[k];
    }
    *reinterpret_cast<typename Vec<C>::F*>(mag) = mv;
    *reinterpret_cast<typename Vec<C>::I*>(dir) = qv;
  } else {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      if (col + k < w) {
        mag[k] = m[k];
        dir[k] = q[k];
      }
    }
  }
}

// One S-lane segment a strip of R rows of one image, its lanes C columns
// each: `groups` = ceil(w / C) columns of C across `seg_cols` segments;
// `segments` = b * strips * seg_cols in all.  A warp's segments walk as
// many rows as the longest of their strips, so every shuffle has all 32
// lanes; a lane past the image (its column group, row or segment) loads a
// clamped address and stores nothing.
template <int R, int S, int C, bool VEC>
__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSM)
sobel_kernel(const float* __restrict__ img, float* __restrict__ mag,
             int* __restrict__ dir, int h, int w, int groups,
             Divisor seg_cols, Divisor strips, unsigned segments) {
  const int lane = threadIdx.x & 31, seg_lane = lane & (S - 1);
  unsigned seg = (blockIdx.x * kWarps + threadIdx.x / 32) * (32 / S) +
                 lane / S;
  const bool live_seg = seg < segments;
  seg = min(seg, segments - 1);
  const unsigned strip_of = seg_cols.div(seg);  // image * strips + strip
  const unsigned image = strips.div(strip_of);
  const int g =
      static_cast<int>(seg - strip_of * seg_cols.d) * S + seg_lane;
  const int r0 = static_cast<int>(strip_of - image * strips.d) * R;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t base = image * plane;
  const bool live = live_seg && g < groups;
  const int col = C * min(g, groups - 1);
  const bool first = seg_lane == 0, last = seg_lane == S - 1 ||
                                           g >= groups - 1;
  const float* x = img + base;
  const int rows = R == 1 ? 1 : __reduce_max_sync(kAll, min(R, h - r0));

  auto row_at = [&](int r) {
    return x + static_cast<size_t>(min(max(r, 0), h - 1)) * w;
  };
  const Raw<C> up = load_row<C, VEC>(row_at(r0 - 1), col, w, first, last);
  const Raw<C> here = load_row<C, VEC>(row_at(r0), col, w, first, last);
  const Raw<C> down = load_row<C, VEC>(row_at(r0 + 1), col, w, first, last);
  Row<C> top = extend<S, C>(up, col, w, first, last);
  Row<C> mid = extend<S, C>(here, col, w, first, last);
  Row<C> bot = extend<S, C>(down, col, w, first, last);
  size_t at = base + static_cast<size_t>(r0) * w + col;
#pragma unroll 3
  for (int i = 0; i < rows; ++i) {
    // row r + 2, in flight while row r is computed
    const Raw<C> next =
        load_row<C, VEC>(row_at(r0 + i + 2), col, w, first, last);
    float m[C];
    int q[C];
    stencil_row<C>(top, mid, bot, m, q);
    if (live && r0 + i < h)
      store_row<C, VEC>(mag + at, dir + at, col, w, m, q);
    at += w;
    top = mid;
    mid = bot;
    bot = extend<S, C>(next, col, w, first, last);
  }
}

struct Plan {
  int columns, seg, rows;  // columns a lane, lanes a segment, strip rows
};

// lanes a segment: the fewest of 8, 16, 32 that hold a row's `groups`
int segment_lanes(int groups) {
  return groups <= 8 ? 8 : groups <= 16 ? 16 : 32;
}

// 4 columns a lane, and strips of the most rows (32, 16, 8, 4, else 1)
// whose grid still holds kWarpsInFlight warps; a batch too small for that
// even at 1 row takes 2 columns a lane, which halves a lane's chain of
// sobel_stencil calls
Plan plan(int b, int h, int w) {
  const int groups = (w + 3) / 4, seg = segment_lanes(groups);
  const long long seg_cols = (groups + seg - 1) / seg;
  for (int rows : {32, 16, 8, 4, 1}) {
    const long long warps = static_cast<long long>(b) *
                            ((h + rows - 1) / rows) * seg_cols * seg / 32;
    if (warps >= kWarpsInFlight) return {4, seg, rows};
  }
  return {2, segment_lanes((w + 1) / 2), 1};
}

template <int R, int S, int C, bool VEC>
int launch(const float* img, float* mag, int* dir, int b, int h, int w,
           cudaStream_t stream) {
  const int groups = (w + C - 1) / C;
  const unsigned seg_cols = (groups + S - 1) / S, strips = (h + R - 1) / R;
  const long long segments = static_cast<long long>(b) * strips * seg_cols;
  const long long per_block = kWarps * (32 / S);
  const long long blocks = (segments + per_block - 1) / per_block;
  if (segments >= (1LL << 31)) return cudaErrorInvalidValue;
  sobel_kernel<R, S, C, VEC><<<static_cast<unsigned>(blocks), kWarps * 32,
                               0, stream>>>(img, mag, dir, h, w, groups,
                                            divisor(seg_cols),
                                            divisor(strips),
                                            static_cast<unsigned>(segments));
  return static_cast<int>(cudaGetLastError());
}

// strips of more than 1 row only at 4 columns a lane
template <int S, int C, bool VEC>
int with_rows(int rows, const float* img, float* mag, int* dir, int b,
              int h, int w, cudaStream_t s) {
  if constexpr (C == 4) {
    switch (rows) {
      case 32: return launch<32, S, C, VEC>(img, mag, dir, b, h, w, s);
      case 16: return launch<16, S, C, VEC>(img, mag, dir, b, h, w, s);
      case 8: return launch<8, S, C, VEC>(img, mag, dir, b, h, w, s);
      case 4: return launch<4, S, C, VEC>(img, mag, dir, b, h, w, s);
      default: break;
    }
  }
  return launch<1, S, C, VEC>(img, mag, dir, b, h, w, s);
}

template <int C, bool VEC>
int with_plan(const Plan& p, const float* img, float* mag, int* dir, int b,
              int h, int w, cudaStream_t s) {
  switch (p.seg) {
    case 8: return with_rows<8, C, VEC>(p.rows, img, mag, dir, b, h, w, s);
    case 16: return with_rows<16, C, VEC>(p.rows, img, mag, dir, b, h, w, s);
    default: return with_rows<32, C, VEC>(p.rows, img, mag, dir, b, h, w, s);
  }
}

}  // namespace

// img [b, h, w] f32 -> mag [b, h, w] f32, dir [b, h, w] i32, all
// contiguous on the device.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int sobel_grad(const float* img, float* mag, int* dir, int b,
                          int h, int w, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0) return 0;
  const Plan p = plan(b, h, w);
  // a row's C columns load and store as one vector when every row starts
  // on a multiple of C floats from pointers aligned to the vector
  const std::uintptr_t ptrs = reinterpret_cast<std::uintptr_t>(img) |
                              reinterpret_cast<std::uintptr_t>(mag) |
                              reinterpret_cast<std::uintptr_t>(dir);
  const bool vec = w % p.columns == 0 && ptrs % (4 * p.columns) == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (p.columns == 4)
    return vec ? with_plan<4, true>(p, img, mag, dir, b, h, w, s)
               : with_plan<4, false>(p, img, mag, dir, b, h, w, s);
  return vec ? with_plan<2, true>(p, img, mag, dir, b, h, w, s)
             : with_plan<2, false>(p, img, mag, dir, b, h, w, s);
}
