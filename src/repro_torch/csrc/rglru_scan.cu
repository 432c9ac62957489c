// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, elementwise over the
// width W, sequential over time, from h0 (zeros when null); and its
// gradient (rglru_scan_backward, at the end).
//
// Replaces the TPU kernel
// repro/kernels/rglru_scan/rglru_scan.py::rglru_scan_pallas
// (_rglru_kernel), whose grid ran (batch, W / 128) with a fori_loop over
// time inside one [1, S, 128] VMEM block.  Here one thread owns one (batch,
// width) lane and walks the time steps itself.  W is the fastest index, so
// a warp's loads of a and b at one step are one 128-byte line each.  Any W
// is taken (the lanes past W return at once); the Pallas kernel asserted
// W % 128 == 0.
//
// Bound on the H100: bytes.  Each element of [B, S, W] costs 12 bytes (a
// and b read, h written, all f32) for 2 flops.  At RecurrentGemma's
// prefill, (8, 1024, 2560), there are only B * W = 20,480 lanes: 640
// warps, about 5 per SM.  A thread that loads one step at a time leaves
// HBM mostly idle, so each thread loads the next U steps of a and b into
// registers before it runs the U dependent updates of the steps it loaded
// last: 2 * U loads in flight per thread while it computes.  The product
// and the sum round apart (__fmul_rn, __fadd_rn), as the plain version's
// two ops do, so the kernel gives the plain version's values bit for bit.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT = 64;  // threads (lanes) per block
constexpr int U = 16;   // time steps loaded ahead

__global__ void __launch_bounds__(NT)
    rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ h0, float* __restrict__ h,
                 int s_len, int w) {
  const int lane = blockIdx.x * NT + threadIdx.x;
  if (lane >= w) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * s_len * w + lane;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float state = h0 ? h0[static_cast<size_t>(blockIdx.y) * w + lane] : 0.f;

  float ca[U], cb[U], na[U], nb[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const size_t at = static_cast<size_t>(u) * w;
    ca[u] = u < s_len ? ap[at] : 0.f;
    cb[u] = u < s_len ? bp[at] : 0.f;
  }
  for (int t0 = 0; t0 < s_len; t0 += U) {
    // the next U steps' loads go out before this U's dependent updates
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + U + u;
      const size_t at = static_cast<size_t>(t) * w;
      na[u] = t < s_len ? ap[at] : 0.f;
      nb[u] = t < s_len ? bp[at] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < s_len) {
        state = __fadd_rn(__fmul_rn(ca[u], state), cb[u]);
        hp[static_cast<size_t>(t0 + u) * w] = state;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
}

// The gradient, walking time backwards: g_t = dh_t + a_{t+1} g_{t+1},
// da_t = g_t h_{t-1} (h_{-1} = h0, or 0), db_t = g_t, dh0 = a_0 g_0.  It
// replaces no TPU kernel (rglru_scan_pallas has no backward; the JAX
// package trains through autodiff of its associative scan).  Bound:
// bytes, 20 a step (a, h and dh read, da and db written) for 3 flops, so
// it keeps the forward's U-step prefetch, reversed: the U steps below the
// ones it updates are loaded before their updates run.  The product and
// the sum round apart, as in the plain reverse loop, which it equals bit
// for bit.
__global__ void __launch_bounds__(NT)
    rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                     const float* __restrict__ dh, const float* __restrict__ h0,
                     float* __restrict__ da, float* __restrict__ db,
                     float* __restrict__ dh0, int s_len, int w) {
  const int lane = blockIdx.x * NT + threadIdx.x;
  if (lane >= w) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * s_len * w + lane;
  const float* ap = a + base;
  const float* hp = h + base;
  const float* gp = dh + base;
  const float first =
      h0 ? h0[static_cast<size_t>(blockIdx.y) * w + lane] : 0.f;

  // step t's a_t, dh_t and h_{t-1}; nothing past either end is read
  float ca[U], cg[U], ch[U], na[U], ng[U], nh[U];
  auto fetch = [&](int t, float& av, float& gv, float& hv) {
    const size_t at = static_cast<size_t>(t) * w;
    av = t >= 0 ? ap[at] : 0.f;
    gv = t >= 0 ? gp[at] : 0.f;
    hv = t >= 1 ? hp[at - w] : first;
  };
#pragma unroll
  for (int u = 0; u < U; ++u) fetch(s_len - 1 - u, ca[u], cg[u], ch[u]);
  float carry = 0.f;
  for (int t0 = s_len - 1; t0 >= 0; t0 -= U) {
#pragma unroll
    for (int u = 0; u < U; ++u) fetch(t0 - U - u, na[u], ng[u], nh[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        const float g = t == s_len - 1 ? cg[u] : __fadd_rn(cg[u], carry);
        const size_t at = static_cast<size_t>(t) * w;
        db[base + at] = g;
        da[base + at] = __fmul_rn(g, ch[u]);
        carry = __fmul_rn(ca[u], g);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ca[u] = na[u];
      cg[u] = ng[u];
      ch[u] = nh[u];
    }
  }
  if (dh0) dh0[static_cast<size_t>(blockIdx.y) * w + lane] = carry;
}

}  // namespace

// a, b and h [bsz, s, w] f32, contiguous, on the device; h0 [bsz, w] f32
// or null (zeros).  Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int rglru_scan(const float* a, const float* b, const float* h0,
                          float* h, int bsz, int s, int w, void* stream) {
  if (bsz < 1 || s < 1 || w < 1 || bsz > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + NT - 1) / NT, bsz);
  rglru_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h0, h, s, w);
  return static_cast<int>(cudaGetLastError());
}

// a, h (the forward's output) and dh [bsz, s, w] f32, contiguous, on the
// device; h0 [bsz, w] f32 or null (zeros).  Writes da and db [bsz, s, w],
// and dh0 [bsz, w] where it is not null.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int rglru_scan_backward(const float* a, const float* h,
                                   const float* dh, const float* h0,
                                   float* da, float* db, float* dh0, int bsz,
                                   int s, int w, void* stream) {
  if (bsz < 1 || s < 1 || w < 1 || bsz > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + NT - 1) / NT, bsz);
  rglru_bwd_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      a, h, dh, h0, da, db, dh0, s, w);
  return static_cast<int>(cudaGetLastError());
}
