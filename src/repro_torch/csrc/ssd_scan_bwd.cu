// The gradient of the Mamba-2 SSD chunked scan (csrc/ssd_scan.cu) from a
// zero state: dx, ddt, dA, dB, dC, dD from the cotangents of y and, where
// given, of the final state.
//
// Replaces no TPU kernel: repro/kernels/ssd_scan/ssd_scan.py::ssd_pallas
// has no backward, and the JAX package trains through autodiff of its jnp
// oracle.  The port's models call the forward kernel on the card, so its
// gradient is a kernel too.
//
// Per chunk of q rows, with xd_j = x_j dt_j, a_cum the chunk-wide
// cumulative sum of A dt, L_ij = exp(a_cum_i - a_cum_j) for j <= i (0
// above the diagonal, selected, never inf x 0), S_c the state entering
// chunk c and G_c the gradient of the state leaving it:
//   dC_i  = sum_j L_ij (dy_i . xd_j) B_j + exp(a_cum_i) S_c^T dy_i
//   dB_j  = sum_i L_ij (dy_i . xd_j) C_i + w_j G_c^T xd_j
//   dxd_j = sum_i L_ij (C_i . B_j) dy_i  + w_j G_c B_j,  w_j = exp(a_last
//           - a_cum_j)
// T_ij = L_ij (C_i . B_j)(dy_i . xd_j) adds to d a_cum_i and takes from
// d a_cum_j; the off-diagonal term adds exp(a_cum_i) dy_i . (S_c C_i); the
// state terms take w_j xd_j . (G_c B_j) from d a_cum_j and give their sum,
// with exp(a_last) <G_c, S_c>, to a_last.  da is the reverse cumulative
// sum of d a_cum in the chunk, ddt = x . dxd + A da, dx = dt dxd + D dy.
//
// No atomics: two calls give equal bits.  d a_cum nearly cancels: each
// T_ij is added at i and taken at j, and over a chunk whose a_cum reaches
// thousands the row and column sums dwarf their difference.  Each T_ij
// enters both sums with the same bits and is added up in f64 (a product
// of two floats is exact there), so the pairs inside any suffix of the
// chunk cancel exactly in the reverse sum (summed in f32, their rounding
// alone moves an f32 model's A_log gradient ~1e-4 of its largest value).
//
// Bound on the H100: at mamba2-370m's training shape (8, 512, 32, 64,
// 128), chunk 256, the work is 20.6 GFLOP (the causal pairs' dot products
// and sums, the state products) against 56 MB read and written in bf16:
// the operations, 0.021 ms at the bf16 tensor-core peak (the bytes take
// 0.017 ms); in f32 the operations, 0.31 ms at the CUDA cores' peak.
//
// f32 (the parity runs against the CPU): six launches on the CUDA cores
// (--fmad=false, fmaf where a product is meant to be fused), each T_ij
// formed with the same bits by the rows' and the columns' kernels:
//   ssd_bwd_states (head, chunk, batch): a_cum of the chunk (one thread, in
//       order, as the forward), the chunk's own state sum_j w_j xd_j B_j^T
//       and its own state gradient sum_i exp(a_cum_i) dy_i C_i^T;
//   ssd_bwd_carry (8 parts of the state, batch x head): S_c over the
//       chunks, G_c over them in reverse from d_state, and the parts of
//       <G_c, S_c>, each in a fixed order;
//   ssd_bwd_rows (row tile, chunk, batch x head): per 64-row tile i, the column
//       tiles j <= i: C B^T and dy xd^T of the tile pair, M = L o (dy
//       xd^T), dC += M B, the row sums of M o (C B^T); then the
//       off-diagonal term;
//   ssd_bwd_cols (column tile, chunk, batch x head): per 64-row tile j, the row
//       tiles i >= j: dB += M^T C, dxd += (L o C B^T)^T dy, the column sums
//       of T; then the state terms, dx, x . dxd and dy . x;
//   ssd_bwd_final (chunk, batch x head): d a_cum, its reverse sum, ddt and
//       the chunk's parts of dA and dD, in f64 (d a_cum nearly cancels
//       over the rows), rounded to f32 once;
//   ssd_bwd_reduce: dB and dC summed over the heads, dA and dD over (batch,
//       chunk), each in a fixed order.
// A [q, q] f32 tile does not fit shared memory at q = 256, so the chunk is
// worked through in 64-row tiles, as the f32 forward does: 256 threads,
// each owning a 4 x 4 block of a tile pair and a 4 x 8 block of a [64, N]
// result, read from shared-memory tiles padded by one word.  Rows past S
// (a ragged last chunk) read as dt = 0, x = B = C = dy = 0.  x, B and C
// are read at the forward's strides (column views of the conv output at
// any element offset, last dim contiguous); dy, dx, dB and dC are
// contiguous.  The per-head dB and dC go through the caller's workspace.
//
// bf16 (training): six launches, every product on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulators), 64-row tiles
// brought in by cp.async at the forward's copy widths, P and N
// zero-padded to 16.  x, B, C and dy are exact bf16 operands; every f32
// operand (x w dt and dy exp(a_cum) in the states, M = L o (P dt), L o
// C B^T, S_c, G_c) is split into three bf16 parts against the exact
// side, as in the forward (tests/test_torch_precision.py emulates it):
//   ssd_bwd_tc_states (head, chunk, batch): a_cum in the forward's order
//       and bits, then the chunk's own state (c < nc - 1) and own state
//       gradient (c > 0), the forward's ssd_kernel_states for each;
//   ssd_bwd_tc_carry (p n / 1024, head, batch): S_c and G_c over the
//       chunks, 4 elements a thread, each nonzero one out in three bf16
//       parts, <G_c, S_c> from the parts (they hold S_c exactly);
//   ssd_bwd_tc_cols (column tile x group of hg heads, chunk, batch): per
//       row tile i >= j, C B^T once for the group, then per head P = x_j
//       dy_i^T, M^T = L o (P dt_j), T = M^T o C B^T in f64 (its column
//       sums in registers, its row sums over the tile to a workspace: T is
//       formed once, here), dxd += (L o C B^T)^T dy_i; M^T summed over the
//       group's heads goes out in f32; then gb = G_c B_j, dx, x .
//       dxd, dy . x.  The column tile that walks the most row tiles starts
//       first;
//   ssd_bwd_tc_sums (tile x side x group of hc heads, chunk, batch): dC_t
//       = sum_j M_tj B_j and dB_t = sum_i M^T_ti C_i, M summed over the hc
//       heads first (B and C are shared by all heads: one product a tile
//       pair, not one a head), each head's exp(a_cum_t) dy_t S_c and w_t
//       dt_t x_t G_c summed into them in registers in order; ranked so that
//       the blocks with the most products start first;
//   ssd_bwd_tc_final (chunk, batch x head): d a_cum from the row sums over
//       the column tiles in order and the rest, then as ssd_bwd_final;
//   ssd_bwd_reduce: dB and dC summed over the groups of hc heads in order.
// hg is 2 and hc 8 where their grids still fill the card twice over
// (mamba2-370m's training shape), else fewer (tc::shape_of): small shapes
// run more, shorter blocks.  Rows at an odd element offset allow no
// cp.async; the kernels built for them (ODD) copy those 8 elements a
// thread at once, and the others carry no scalar path.
// Against the f32 design's cost: its products ran as fmaf loops (6.6
// TFLOP/s); it formed C B^T once a head (64 times a (batch, chunk) where
// once does) and dy xd^T and T in both tile kernels; its per-head dB and
// dC (67 MB each) went through the workspace; its 8-warp column blocks
// (134.7 KB of shared memory) ran one to an SM, the longest last; its
// states ran on the CUDA cores and its carry waited on dependent loads.
// Here B and C enter one product a group of heads (M summed over the
// group first), dy x^T and T are formed once, dB and dC go through the
// workspace once per 8 heads, every block fits two to an SM, and the
// carry moves each element once.  At the training shape that takes
// 0.52 ms, 4 % of the bound (tools/ssd_bwd_ab.py): the sums kernel's
// per-head S_c and G_c loads and the columns kernel's latency (8 warps
// an SM) bound it now.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tiles.cuh"
#include "ssd_tiles.cuh"

namespace {

constexpr int TR = 64;         // rows of a tile (of i or of j)
constexpr int PMAX = 64;       // largest head dim
constexpr int NMAX = 128;      // largest state dim
constexpr int NT = 256;        // threads: 16 x 16, thread (ty, tx)
constexpr int LN = NMAX + 1;   // padded row of the [*, N] tiles
constexpr int LP = PMAX + 1;   // padded row of the [*, P] and [*, 64] tiles
constexpr int CB = 8;          // carry blocks per (batch, head)
constexpr int CT = PMAX * NMAX / (CB * NT);  // state elements a carry thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void put(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void put(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

using repro_torch::Strides;

struct Dims {
  int b, s, h, p, n, q, nc;
  __host__ __device__ long long sp() const {
    return static_cast<long long>(nc) * q;
  }
};

// the f32 workspace, carved from the caller's buffer
struct Work {
  float* acum;   // [b, h, sp] a_cum, chunk by chunk
  float* S;      // [b, h, nc, p, n] the state entering each chunk
  float* G;      // [b, h, nc, p, n] the gradient of the state leaving it
  float* gs;     // [b, h, nc, CB] <G_c, S_c> in CB parts
  double* drow;  // [b, h, sp] row sums of T, plus the off-diagonal term
  double* dcol;  // [b, h, sp] column sums of T
  float* sterm;  // [b, h, sp] w_j xd_j . (G_c B_j)
  float* xdxd;   // [b, h, sp] x_j . dxd_j
  float* dyx;    // [b, h, sp] dy_j . x_j
  float* dBp;    // [h, b, sp, n] dB of each head
  float* dCp;    // [h, b, sp, n] dC of each head
  float* dAp;    // [b, h, nc] dA of each chunk
  float* dDp;    // [b, h, nc] dD of each chunk
};

// rows [0, TR) of a matrix (row r at base + r * stride, ncols columns)
// into dst[r * ld + k] as f32, times s1[r] (and then s2[r]) where given;
// rows >= nvalid become 0
template <typename T>
__device__ void load_rows(float* dst, int ld, const T* base, long long stride,
                          int ncols, int nvalid, const float* s1 = nullptr,
                          const float* s2 = nullptr) {
  for (int e = threadIdx.x; e < TR * ncols; e += NT) {
    const int r = e / ncols, k = e % ncols;
    float v = 0.f;
    if (r < nvalid) {
      v = to_f32(base[r * stride + k]);
      if (s1) v = v * s1[r];
      if (s2) v = v * s2[r];
    }
    dst[r * ld + k] = v;
  }
}

// the sum over the 16 lanes of a half warp (the threads of one ty), in a
// fixed order
template <typename F>
__device__ __forceinline__ F half_warp_sum(F v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a_cum of chunk c (one thread, in order), the chunk's own state
// sum_j w_j xd_j B_j^T into S and its own state gradient
// sum_i exp(a_cum_i) dy_i C_i^T into G
template <typename T>
__global__ void __launch_bounds__(NT)
    ssd_bwd_states(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, const T* __restrict__ dy, Work w,
                   Dims d, Strides st) {
  extern __shared__ float sm[];
  float* dts = sm;              // [q] dt of the chunk
  float* ac = dts + d.q;        // [q] a_cum of the chunk
  float* scl = ac + d.q;        // [q] each row's decay
  float* Xs = scl + d.q;        // [TR][LP] x dt w or dy exp(a_cum)
  float* Ns = Xs + TR * LP;     // [TR][LN] B or C
  const int hh = blockIdx.x, c = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c0 = c * d.q, nv = min(d.q, d.s - c0);
  const long long bh = static_cast<long long>(bb) * d.h + hh;
  const float* dtb = dt + bb * st.db + hh * st.dh;
  for (int i = tid; i < d.q; i += NT)
    dts[i] = i < nv ? dtb[(c0 + i) * st.ds] : 0.f;
  __syncthreads();
  if (tid == 0) {
    const float a_h = A[hh];
    float run = 0.f;
    for (int i = 0; i < d.q; ++i) {
      run += a_h * dts[i];
      ac[i] = run;
    }
  }
  __syncthreads();
  for (int i = tid; i < d.q; i += NT) w.acum[bh * d.sp() + c0 + i] = ac[i];
  const float a_last = ac[d.q - 1];
  const T* xb = x + bb * st.xb + hh * st.xh;
  const long long dys = static_cast<long long>(d.h) * d.p;
  const T* dyb = dy + (static_cast<long long>(bb) * d.s * d.h + hh) * d.p;
  const long long pn = static_cast<long long>(d.p) * d.n;

  for (int pass = 0; pass < 2; ++pass) {
    for (int i = tid; i < d.q; i += NT)
      scl[i] = pass == 0 ? expf(a_last - ac[i]) : expf(ac[i]);
    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[r][k] = 0.f;
    for (int j0 = 0; j0 < nv; j0 += TR) {
      __syncthreads();  // scl written; the last tile's reads done
      if (pass == 0) {
        load_rows(Xs, LP, xb + (c0 + j0) * st.xs, st.xs, d.p, nv - j0,
                  dts + j0, scl + j0);
        load_rows(Ns, LN, Bm + bb * st.bb + (c0 + j0) * st.bs, st.bs, d.n,
                  nv - j0);
      } else {
        load_rows(Xs, LP, dyb + (c0 + j0) * dys, dys, d.p, nv - j0,
                  scl + j0);
        load_rows(Ns, LN, Cm + bb * st.cb + (c0 + j0) * st.cs, st.cs, d.n,
                  nv - j0);
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < TR; ++j) {
        float a[4], v[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = Xs[j * LP + ty * 4 + r];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = Ns[j * LN + tx + 16 * k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[r][k] = fmaf(a[r], v[k], acc[r][k]);
      }
    }
    float* out = (pass == 0 ? w.S : w.G) + (bh * d.nc + c) * pn;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int pp = ty * 4 + r;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int nn = tx + 16 * k;
        if (pp < d.p && nn < d.n) out[pp * d.n + nn] = acc[r][k];
      }
    }
    __syncthreads();  // scl is rewritten by the next pass
  }
}

// the sum of every thread's v over the block, as a tree in a fixed order,
// returned to every thread; red holds NT values
template <typename F>
__device__ F block_sum(F v, F* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int o = NT / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) red[threadIdx.x] += red[threadIdx.x + o];
    __syncthreads();
  }
  const F total = red[0];
  __syncthreads();
  return total;
}

// S_c over the chunks (S holds the chunks' own states on entry), G_c over
// them in reverse from d_state (G holds their own gradients on entry), and
// each block's part of <G_c, S_c>; CB blocks per (batch, head), each
// thread CT elements
__global__ void __launch_bounds__(NT)
    ssd_bwd_carry(const float* __restrict__ d_state, Work w, Dims d) {
  __shared__ float red[NT];
  const long long bh = blockIdx.y;
  const int pn = d.p * d.n, e0 = blockIdx.x * NT + threadIdx.x;
  float run[CT];
#pragma unroll
  for (int k = 0; k < CT; ++k) run[k] = 0.f;
  for (int c = 0; c < d.nc; ++c) {
    const float dec = expf(w.acum[bh * d.sp() + c * d.q + d.q - 1]);
    float* Sc = w.S + (bh * d.nc + c) * pn;
#pragma unroll
    for (int k = 0; k < CT; ++k) {
      const int e = e0 + k * CB * NT;
      if (e < pn) {
        const float own = Sc[e];
        Sc[e] = run[k];
        run[k] = run[k] * dec + own;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < CT; ++k) {
    const int e = e0 + k * CB * NT;
    run[k] = d_state && e < pn ? d_state[bh * pn + e] : 0.f;
  }
  for (int c = d.nc - 1; c >= 0; --c) {
    const float dec = expf(w.acum[bh * d.sp() + c * d.q + d.q - 1]);
    float* Gc = w.G + (bh * d.nc + c) * pn;
    const float* Sc = w.S + (bh * d.nc + c) * pn;
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < CT; ++k) {
      const int e = e0 + k * CB * NT;
      if (e < pn) {
        const float own = Gc[e];
        Gc[e] = run[k];
        dot = fmaf(run[k], Sc[e], dot);
        run[k] = own + dec * run[k];
      }
    }
    dot = block_sum(dot, red);
    if (threadIdx.x == 0) w.gs[(bh * d.nc + c) * CB + blockIdx.x] = dot;
  }
}

size_t rows_smem(int q) {
  return sizeof(float) * (2 * static_cast<size_t>(q) + 2 * TR * LN +
                          2 * TR * LP);
}

// one 64-row tile i of chunk c: dC_i of this head and the row side of
// d a_cum_i
template <typename T>
__global__ void __launch_bounds__(NT)
    ssd_bwd_rows(const T* __restrict__ x, const float* __restrict__ dt,
                 const T* __restrict__ Bm, const T* __restrict__ Cm,
                 const T* __restrict__ dy, Work w, Dims d, Strides st) {
  extern __shared__ float sm[];
  float* ac = sm;               // [q] a_cum of the chunk
  float* dts = ac + d.q;        // [q] dt of the chunk
  float* Cs = dts + d.q;        // [TR][LN] C of the row tile
  float* Bs = Cs + TR * LN;     // [TR][LN] B of a column tile, then S_c
  float* Ys = Bs + TR * LN;     // [TR][LP] dy of the row tile
  float* Xs = Ys + TR * LP;     // [TR][LP] xd of a column tile, then M
  const int it = blockIdx.x, c = blockIdx.y;
  const int bb = blockIdx.z / d.h, hh = blockIdx.z % d.h;
  const int c0 = c * d.q, nv = min(d.q, d.s - c0), i0 = it * TR;
  if (i0 >= nv) return;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long bh = static_cast<long long>(bb) * d.h + hh;
  const float* dtb = dt + bb * st.db + hh * st.dh;
  for (int i = tid; i < d.q; i += NT) {
    ac[i] = w.acum[bh * d.sp() + c0 + i];
    dts[i] = i < nv ? dtb[(c0 + i) * st.ds] : 0.f;
  }
  const T* xb = x + bb * st.xb + hh * st.xh;
  const long long dys = static_cast<long long>(d.h) * d.p;
  const T* dyb = dy + (static_cast<long long>(bb) * d.s * d.h + hh) * d.p;
  load_rows(Cs, LN, Cm + bb * st.cb + (c0 + i0) * st.cs, st.cs, d.n,
            nv - i0);
  load_rows(Ys, LP, dyb + (c0 + i0) * dys, dys, d.p, nv - i0);

  float acc[4][8];
  double rsum[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    rsum[r] = 0.0;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[r][k] = 0.f;
  }
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * TR;
    __syncthreads();  // dts loaded; the last tile's reads of Bs, Xs done
    load_rows(Bs, LN, Bm + bb * st.bb + (c0 + j0) * st.bs, st.bs, d.n,
              nv - j0);
    load_rows(Xs, LP, xb + (c0 + j0) * st.xs, st.xs, d.p, nv - j0,
              dts + j0);
    __syncthreads();
    // rows ty*4+r of the tile i against columns tx+16c of the tile j
    float cb[4][4], dx[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) cb[r][cc] = dx[r][cc] = 0.f;
#pragma unroll 4
    for (int k = 0; k < d.n; ++k) {
      float a[4], v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Cs[(ty * 4 + r) * LN + k];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) v[cc] = Bs[(tx + 16 * cc) * LN + k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) cb[r][cc] = fmaf(a[r], v[cc], cb[r][cc]);
    }
#pragma unroll 4
    for (int k = 0; k < d.p; ++k) {
      float a[4], v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Ys[(ty * 4 + r) * LP + k];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) v[cc] = Xs[(tx + 16 * cc) * LP + k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) dx[r][cc] = fmaf(a[r], v[cc], dx[r][cc]);
    }
    float m[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = j0 + tx + 16 * cc;
        m[r][cc] = (i < nv && j <= i) ? expf(ac[i] - ac[j]) * dx[r][cc] : 0.f;
        rsum[r] += static_cast<double>(m[r][cc]) * cb[r][cc];
      }
    }
    __syncthreads();  // every read of xd done: M takes its place
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        Xs[(ty * 4 + r) * LP + tx + 16 * cc] = m[r][cc];
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TR; ++j) {
      float a[4], v[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Xs[(ty * 4 + r) * LP + j];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = Bs[j * LN + tx + 16 * k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[r][k] = fmaf(a[r], v[k], acc[r][k]);
    }
  }

  // the off-diagonal term: u_i = S_c^T dy_i; dC_i += exp(a_cum_i) u_i and
  // d a_cum_i += exp(a_cum_i) u_i . C_i
  __syncthreads();
  const float* Sg = w.S + (bh * d.nc + c) * d.p * d.n;
  for (int e = tid; e < d.p * d.n; e += NT)
    Bs[(e / d.n) * LN + e % d.n] = Sg[e];
  __syncthreads();
  float u[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < 8; ++k) u[r][k] = 0.f;
#pragma unroll 4
  for (int pp = 0; pp < d.p; ++pp) {
    float a[4], v[8];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = Ys[(ty * 4 + r) * LP + pp];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = Bs[pp * LN + tx + 16 * k];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 8; ++k) u[r][k] = fmaf(a[r], v[k], u[r][k]);
  }
  float* dCp = w.dCp + (static_cast<long long>(hh) * d.b + bb) * d.sp() * d.n;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    const float ei = i < nv ? expf(ac[i]) : 0.f;
    float osum = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int nn = tx + 16 * k;
      if (nn < d.n) osum = fmaf(u[r][k], Cs[(ty * 4 + r) * LN + nn], osum);
      acc[r][k] = fmaf(ei, u[r][k], acc[r][k]);
    }
    const double rs = half_warp_sum(rsum[r]);
    const float os = half_warp_sum(osum);
    if (i >= nv) continue;
    if (tx == 0) w.drow[bh * d.sp() + c0 + i] = rs + ei * os;
    float* row = dCp + (c0 + i) * static_cast<long long>(d.n);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int nn = tx + 16 * k;
      if (nn < d.n) row[nn] = acc[r][k];
    }
  }
}

size_t cols_smem(int q) {
  return sizeof(float) * (2 * static_cast<size_t>(q) + 2 * TR * LN +
                          4 * TR * LP);
}

// one 64-row tile j of chunk c: dB_j of this head, dxd_j -> dx_j, the
// column side of d a_cum_j, the state term, x_j . dxd_j and dy_j . x_j
template <typename T>
__global__ void __launch_bounds__(NT)
    ssd_bwd_cols(const T* __restrict__ x, const float* __restrict__ dt,
                 const T* __restrict__ Bm, const T* __restrict__ Cm,
                 const float* __restrict__ D, const T* __restrict__ dy,
                 T* __restrict__ dxo, Work w, Dims d, Strides st) {
  extern __shared__ float sm[];
  float* ac = sm;               // [q] a_cum of the chunk
  float* dts = ac + d.q;        // [q] dt of the chunk
  float* Bs = dts + d.q;        // [TR][LN] B of the column tile
  float* Cs = Bs + TR * LN;     // [TR][LN] C of a row tile, then G_c
  float* Xs = Cs + TR * LN;     // [TR][LP] xd of the column tile
  float* Ys = Xs + TR * LP;     // [TR][LP] dy of a row tile
  float* P1 = Ys + TR * LP;     // [TR][LP] M^T: L_ij (dy_i . xd_j) at [j][i]
  float* P2 = P1 + TR * LP;     // [TR][LP] L_ij (C_i . B_j) at [j][i]
  const int jt = blockIdx.x, c = blockIdx.y;
  const int bb = blockIdx.z / d.h, hh = blockIdx.z % d.h;
  const int c0 = c * d.q, nv = min(d.q, d.s - c0), j0 = jt * TR;
  if (j0 >= nv) return;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long bh = static_cast<long long>(bb) * d.h + hh;
  const float* dtb = dt + bb * st.db + hh * st.dh;
  for (int i = tid; i < d.q; i += NT) {
    ac[i] = w.acum[bh * d.sp() + c0 + i];
    dts[i] = i < nv ? dtb[(c0 + i) * st.ds] : 0.f;
  }
  __syncthreads();
  const T* xb = x + bb * st.xb + hh * st.xh;
  const long long dys = static_cast<long long>(d.h) * d.p;
  const T* dyb = dy + (static_cast<long long>(bb) * d.s * d.h + hh) * d.p;
  load_rows(Bs, LN, Bm + bb * st.bb + (c0 + j0) * st.bs, st.bs, d.n,
            nv - j0);
  load_rows(Xs, LP, xb + (c0 + j0) * st.xs, st.xs, d.p, nv - j0, dts + j0);

  float db[4][8], dxd[4][4];
  double csum[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    csum[r] = 0.0;
#pragma unroll
    for (int k = 0; k < 8; ++k) db[r][k] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) dxd[r][k] = 0.f;
  }
  for (int i0 = j0; i0 < nv; i0 += TR) {
    __syncthreads();  // the last tile's reads of Cs, Ys, P1, P2 done
    load_rows(Cs, LN, Cm + bb * st.cb + (c0 + i0) * st.cs, st.cs, d.n,
              nv - i0);
    load_rows(Ys, LP, dyb + (c0 + i0) * dys, dys, d.p, nv - i0);
    __syncthreads();
    // rows ty*4+r of the tile j against columns tx+16c of the tile i, in
    // the same order of sums as ssd_bwd_rows
    float cb[4][4], dx[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) cb[r][cc] = dx[r][cc] = 0.f;
#pragma unroll 4
    for (int k = 0; k < d.n; ++k) {
      float a[4], v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Bs[(ty * 4 + r) * LN + k];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) v[cc] = Cs[(tx + 16 * cc) * LN + k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) cb[r][cc] = fmaf(v[cc], a[r], cb[r][cc]);
    }
#pragma unroll 4
    for (int k = 0; k < d.p; ++k) {
      float a[4], v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Xs[(ty * 4 + r) * LP + k];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) v[cc] = Ys[(tx + 16 * cc) * LP + k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) dx[r][cc] = fmaf(v[cc], a[r], dx[r][cc]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + ty * 4 + r;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int i = i0 + tx + 16 * cc;
        const float l = (i < nv && j <= i) ? expf(ac[i] - ac[j]) : 0.f;
        const float m = l * dx[r][cc];  // ssd_bwd_rows's M, bit for bit
        csum[r] += static_cast<double>(m) * cb[r][cc];
        P1[(ty * 4 + r) * LP + tx + 16 * cc] = m;
        P2[(ty * 4 + r) * LP + tx + 16 * cc] = l * cb[r][cc];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < TR; ++i) {
      float a1[4], a2[4], vc[8], vy[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a1[r] = P1[(ty * 4 + r) * LP + i];
        a2[r] = P2[(ty * 4 + r) * LP + i];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) vc[k] = Cs[i * LN + tx + 16 * k];
#pragma unroll
      for (int k = 0; k < 4; ++k) vy[k] = Ys[i * LP + tx + 16 * k];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int k = 0; k < 8; ++k) db[r][k] = fmaf(a1[r], vc[k], db[r][k]);
#pragma unroll
        for (int k = 0; k < 4; ++k) dxd[r][k] = fmaf(a2[r], vy[k], dxd[r][k]);
      }
    }
  }

  // the state terms: gb_j = G_c B_j, gx_j = G_c^T xd_j; dxd_j += w_j gb_j,
  // dB_j += w_j gx_j, sterm_j = w_j xd_j . gb_j
  __syncthreads();
  const float* Gg = w.G + (bh * d.nc + c) * d.p * d.n;
  for (int e = tid; e < d.p * d.n; e += NT)
    Cs[(e / d.n) * LN + e % d.n] = Gg[e];
  __syncthreads();
  float gb[4][4], gx[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) gb[r][k] = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) gx[r][k] = 0.f;
  }
#pragma unroll 4
  for (int nn = 0; nn < d.n; ++nn) {
    float a[4], v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = Bs[(ty * 4 + r) * LN + nn];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = Cs[(tx + 16 * k) * LN + nn];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) gb[r][k] = fmaf(v[k], a[r], gb[r][k]);
  }
#pragma unroll 4
  for (int pp = 0; pp < d.p; ++pp) {
    float a[4], v[8];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = Xs[(ty * 4 + r) * LP + pp];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = Cs[pp * LN + tx + 16 * k];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 8; ++k) gx[r][k] = fmaf(v[k], a[r], gx[r][k]);
  }
  const float a_last = ac[d.q - 1], d_h = D[hh];
  float* dBp = w.dBp + (static_cast<long long>(hh) * d.b + bb) * d.sp() * d.n;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + ty * 4 + r;
    const float wj = j < nv ? expf(a_last - ac[j]) : 0.f;
    const T* xrow = xb + (c0 + min(j, nv - 1)) * st.xs;
    const T* dyrow = dyb + (c0 + min(j, nv - 1)) * dys;
    float ss = 0.f, xs = 0.f, yx = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int pp = tx + 16 * k;
      dxd[r][k] = fmaf(wj, gb[r][k], dxd[r][k]);
      if (pp < d.p && j < nv) {
        const float xv = to_f32(xrow[pp]), yv = to_f32(dyrow[pp]);
        ss = fmaf(Xs[(ty * 4 + r) * LP + pp], gb[r][k], ss);
        xs = fmaf(xv, dxd[r][k], xs);
        yx = fmaf(yv, xv, yx);
        put(dxo + ((static_cast<long long>(bb) * d.s + c0 + j) * d.h + hh) *
                      d.p + pp,
            dts[j] * dxd[r][k] + d_h * yv);
      }
    }
    const double cs = half_warp_sum(csum[r]);
    ss = half_warp_sum(ss);
    xs = half_warp_sum(xs);
    yx = half_warp_sum(yx);
    if (j >= nv) continue;
    if (tx == 0) {
      const long long at = bh * d.sp() + c0 + j;
      w.dcol[at] = cs;
      w.sterm[at] = wj * ss;
      w.xdxd[at] = xs;
      w.dyx[at] = yx;
    }
    float* row = dBp + (c0 + j) * static_cast<long long>(d.n);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int nn = tx + 16 * k;
      if (nn < d.n) row[nn] = fmaf(wj, gx[r][k], db[r][k]);
    }
  }
}

// d a_cum of chunk c, its reverse cumulative sum da (one thread, in
// order), ddt = x . dxd + A da, and the chunk's parts of dA (sum dt da)
// and dD (sum dy . x), summed over the rows as trees in a fixed order.
// d a_cum is the difference of large sums that nearly cancel over the
// chunk's rows (each T_ij is added at i and taken at j), so it is
// assembled from the f64 row and column sums, summed and multiplied in
// f64, and rounded to f32 once
__global__ void __launch_bounds__(NT)
    ssd_bwd_final(const float* __restrict__ dt, const float* __restrict__ A,
                  float* __restrict__ ddt, Work w, Dims d, Strides st) {
  extern __shared__ double smd[];
  double* da = smd;             // [q] d a_cum, then da
  double* red = da + d.q;       // [NT] the tree sums
  const int c = blockIdx.x;
  const int bb = blockIdx.y / d.h, hh = blockIdx.y % d.h;
  const int c0 = c * d.q, nv = min(d.q, d.s - c0), tid = threadIdx.x;
  const long long bh = static_cast<long long>(bb) * d.h + hh;
  const long long at = bh * d.sp() + c0;
  const float* dtb = dt + bb * st.db + hh * st.dh;
  double part = 0.0;
  for (int i = tid; i < nv; i += NT) {
    const double sv = w.sterm[at + i];
    part += sv;
    da[i] = w.drow[at + i] - w.dcol[at + i] - sv;
  }
  const double sum_st = block_sum(part, red);
  if (tid == 0) {
    double gs = 0.0;
    for (int k = 0; k < CB; ++k) gs += w.gs[(bh * d.nc + c) * CB + k];
    const double a_last = w.acum[at + d.q - 1];
    da[nv - 1] += sum_st + exp(a_last) * gs;
    double run = 0.0;
    for (int i = nv - 1; i >= 0; --i) {
      run += da[i];
      da[i] = run;
    }
  }
  __syncthreads();
  const double a_h = A[hh];
  double pa = 0.0, pd = 0.0;
  for (int i = tid; i < nv; i += NT) {
    ddt[(static_cast<long long>(bb) * d.s + c0 + i) * d.h + hh] =
        static_cast<float>(w.xdxd[at + i] + a_h * da[i]);
    pa += dtb[(c0 + i) * st.ds] * da[i];
    pd += w.dyx[at + i];
  }
  const double dA = block_sum(pa, red);
  const double dD = block_sum(pd, red);
  if (tid == 0) {
    w.dAp[bh * d.nc + c] = static_cast<float>(dA);
    w.dDp[bh * d.nc + c] = static_cast<float>(dD);
  }
}

// dB and dC [b, s, n] summed over their nparts parts ([nparts, b, sp, n]:
// the heads, or groups of heads) in order; block 0 also sums dA and dD
// over (batch, chunk) in order
template <typename T>
__global__ void __launch_bounds__(NT)
    ssd_bwd_reduce(T* __restrict__ dB, T* __restrict__ dC,
                   float* __restrict__ dA, float* __restrict__ dD,
                   const float* __restrict__ dBp,
                   const float* __restrict__ dCp,
                   const float* __restrict__ dAp,
                   const float* __restrict__ dDp, int nparts, Dims d) {
  const long long total = static_cast<long long>(d.b) * d.s * d.n;
  const long long e = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (e < total) {
    const long long bb = e / (static_cast<long long>(d.s) * d.n);
    const long long rem = e % (static_cast<long long>(d.s) * d.n);
    const long long from = bb * d.sp() * d.n + rem;
    const long long head = static_cast<long long>(d.b) * d.sp() * d.n;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < nparts; ++k) {
      sb += dBp[k * head + from];
      sc += dCp[k * head + from];
    }
    put(dB + e, sb);
    put(dC + e, sc);
  }
  if (blockIdx.x == 0) {
    for (int hh = threadIdx.x; hh < d.h; hh += NT) {
      float sa = 0.f, sd = 0.f;
      for (int bb = 0; bb < d.b; ++bb)
        for (int c = 0; c < d.nc; ++c) {
          const long long at = (static_cast<long long>(bb) * d.h + hh) *
                               d.nc + c;
          sa += dAp[at];
          sd += dDp[at];
        }
      dA[hh] = sa;
      dD[hh] = sd;
    }
  }
}

// raise a kernel's dynamic shared-memory limit to `bytes` once; `allowed`
// records the limit the kernel holds, so each kernel has exactly one (a
// second record could set the limit below what the first believes)
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, const float* D, const void* dy,
           const float* d_state, void* dx, float* ddt, float* dA, void* dB,
           void* dC, float* dD, float* ws, const Dims& d,
           const long long* s10, cudaStream_t stream) {
  static size_t ok_states = 0, ok_rows = 0, ok_cols = 0, ok_final = 0;
  const size_t sm_states =
      sizeof(float) * (3 * static_cast<size_t>(d.q) + TR * LP + TR * LN);
  const size_t sm_rows = rows_smem(d.q), sm_cols = cols_smem(d.q);
  const size_t sm_final = sizeof(double) * (static_cast<size_t>(d.q) + NT);
  cudaError_t err;
  if ((err = allow_smem(ssd_bwd_states<T>, sm_states, &ok_states)) ||
      (err = allow_smem(ssd_bwd_rows<T>, sm_rows, &ok_rows)) ||
      (err = allow_smem(ssd_bwd_cols<T>, sm_cols, &ok_cols)) ||
      (err = allow_smem(ssd_bwd_final, sm_final, &ok_final)))
    return static_cast<int>(err);
  const long long bh = static_cast<long long>(d.b) * d.h;
  const long long sp = d.sp(), pn = static_cast<long long>(d.p) * d.n;
  Work w;
  w.drow = reinterpret_cast<double*>(ws);  // the caller's buffer is aligned
  w.dcol = w.drow + bh * sp;
  w.acum = reinterpret_cast<float*>(w.dcol + bh * sp);
  w.S = w.acum + bh * sp;
  w.G = w.S + bh * d.nc * pn;
  w.gs = w.G + bh * d.nc * pn;
  w.sterm = w.gs + bh * d.nc * CB;
  w.xdxd = w.sterm + bh * sp;
  w.dyx = w.xdxd + bh * sp;
  w.dBp = w.dyx + bh * sp;
  w.dCp = w.dBp + bh * sp * d.n;
  w.dAp = w.dCp + bh * sp * d.n;
  w.dDp = w.dAp + bh * d.nc;
  const Strides st{s10[0], s10[1], s10[2], s10[3], s10[4],
                   s10[5], s10[6], s10[7], s10[8], s10[9]};
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  const T* dyt = static_cast<const T*>(dy);
  const int tiles = (d.q + TR - 1) / TR;
  ssd_bwd_states<T><<<dim3(d.h, d.nc, d.b), NT, sm_states, stream>>>(
      xt, dt, A, Bt, Ct, dyt, w, d, st);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  ssd_bwd_carry<<<dim3(CB, static_cast<unsigned>(bh)), NT, 0, stream>>>(
      d_state, w, d);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  const dim3 tiled(tiles, d.nc, static_cast<unsigned>(bh));
  ssd_bwd_rows<T><<<tiled, NT, sm_rows, stream>>>(xt, dt, Bt, Ct, dyt, w, d,
                                                 st);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  ssd_bwd_cols<T><<<tiled, NT, sm_cols, stream>>>(xt, dt, Bt, Ct, D, dyt,
                                            static_cast<T*>(dx), w, d, st);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  ssd_bwd_final<<<dim3(d.nc, static_cast<unsigned>(bh)), NT, sm_final,
                  stream>>>(dt, A, ddt, w, d, st);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  const long long total = static_cast<long long>(d.b) * d.s * d.n;
  ssd_bwd_reduce<T><<<static_cast<unsigned>((total + NT - 1) / NT), NT, 0,
                      stream>>>(static_cast<T*>(dB), static_cast<T*>(dC), dA,
                                dD, w.dBp, w.dCp, w.dAp, w.dDp, d.h, d);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ bf16: the tensor cores

namespace tc {

using bf16 = __nv_bfloat16;
using repro_torch::align32;
using repro_torch::copy_tile;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;
using repro_torch::ldmatrix_x4;
using repro_torch::ldmatrix_x4_trans;
using repro_torch::mma_bf16;
using repro_torch::split3_bf16;
using repro_torch::vec_of;

constexpr int MT = 64;          // rows of a tile
constexpr int WT = 128;         // threads: 4 warps of 16 rows
constexpr int LDP = PMAX + 8;   // padded row of the [*, P] bf16 tiles
constexpr int LDN = NMAX + 8;   // padded row of the [*, N] bf16 tiles
constexpr int LDM = MT + 4;     // padded row of a [MT, MT] f32 tile of M
constexpr int HG = 2;           // most heads of a ssd_bwd_tc_cols block
constexpr int HC = 8;           // most heads of a ssd_bwd_tc_sums block
constexpr int FILL = 264;       // blocks that fill the card: 2 an SM
constexpr int NPART = 3;        // bf16 parts of a split f32 operand
constexpr int CE = 4;           // state elements per carry thread
constexpr int CW = 256;         // carry threads
// bytes of a ssd_bwd_tc_sums stage: an f32 tile of M^T, a tile of B or C
constexpr int USTAGE = sizeof(float) * MT * LDM + sizeof(bf16) * MT * LDN;
static_assert(2 * USTAGE >= sizeof(bf16) * (MT * LDP + NPART * PMAX * LDN),
              "a head's dy or x and S_c or G_c fit the ring");
static_assert(HG * MT <= WT && HC % HG == 0, "a thread a row of a group");

// elements per copy of a row of x, dy, B, C and of the split states
struct Vec {
  int x, y, b, c, s;
};

// sizes that follow from the dims
struct Shape {
  int ntq;     // 64-row tiles of a chunk
  int npairs;  // tile pairs (i, j), j <= i, of a chunk
  int hg;      // heads of a ssd_bwd_tc_cols block: 2, or 1
  int hc;      // heads of a ssd_bwd_tc_sums block: 8, 4, 2, or hg
  int ngroups; // groups of hg heads
  int nhc;     // groups of hc heads
  int cbc;     // carry blocks per (batch, head)
};

// the groups of heads: the most heads a block whose grid still fills the
// card, or else the fewest (small shapes: more blocks, shorter ones)
__host__ __device__ Shape shape_of(const Dims& d) {
  Shape sh;
  sh.ntq = (d.q + MT - 1) / MT;
  sh.npairs = sh.ntq * (sh.ntq + 1) / 2;
  const int tiles = sh.ntq * d.nc * d.b;
  sh.hg = tiles * ((d.h + HG - 1) / HG) >= FILL ? HG : 1;
  sh.hc = sh.hg;
  for (int c = HC; c > sh.hg; c /= 2)
    if (2 * tiles * ((d.h + c - 1) / c) >= FILL) {
      sh.hc = c;
      break;
    }
  sh.ngroups = (d.h + sh.hg - 1) / sh.hg;
  sh.nhc = (d.h + sh.hc - 1) / sh.hc;
  sh.cbc = (d.p * d.n + CW * CE - 1) / (CW * CE);
  return sh;
}

// the workspace, each region 32-byte aligned
struct Work {
  double* rowp;  // [b, h, nc, ntq, q] row sums of T over each column tile
  double* dcol;  // [b, h, sp] column sums of T
  float* acum;   // [b, h, sp] a_cum, chunk by chunk
  float* Sown;   // [b, h, nc, p n] each chunk's own state (c < nc - 1)
  float* Gown;   // [b, h, nc, p n] each chunk's own state gradient (c > 0)
  bf16* Sp;      // [b, h, nc, NPART, p n] S_c in bf16 parts (c > 0)
  bf16* Gp;      // [b, h, nc, NPART, p n] G_c in bf16 parts (where nonzero)
  float* gs;     // [b, h, nc, cbc] <G_c, S_c> in cbc parts
  float* doff;   // [b, h, sp] exp(a_cum_i) u_i . C_i (c > 0)
  float* sterm;  // [b, h, sp] w_j xd_j . (G_c B_j)
  float* xdxd;   // [b, h, sp] x_j . dxd_j
  float* dyx;    // [b, h, sp] dy_j . x_j
  float* Mp;     // [b, nc, ngroups, npairs, MT, MT] a group's M^T
  float* dBp;    // [nhc, b, sp, n] dB of each group of hc heads
  float* dCp;    // [nhc, b, sp, n] dC of each group of hc heads
  float* dAp;    // [b, h, nc] dA of each chunk
  float* dDp;    // [b, h, nc] dD of each chunk
};

// the workspace's regions, carved in order from ws
void carve(float* ws, const Dims& d, const Shape& sh, Work* w) {
  const long long bh = static_cast<long long>(d.b) * d.h, sp = d.sp();
  const long long pn = static_cast<long long>(d.p) * d.n;
  auto take = [&](long long floats) {
    float* at = align32(ws);
    ws = at + floats;
    return at;
  };
  w->rowp = reinterpret_cast<double*>(
      take(2 * bh * d.nc * sh.ntq * d.q));
  w->dcol = reinterpret_cast<double*>(take(2 * bh * sp));
  w->acum = take(bh * sp);
  w->Sown = take(bh * d.nc * pn);
  w->Gown = take(bh * d.nc * pn);
  w->Sp = reinterpret_cast<bf16*>(take(bh * d.nc * NPART * pn / 2 + 1));
  w->Gp = reinterpret_cast<bf16*>(take(bh * d.nc * NPART * pn / 2 + 1));
  w->gs = take(bh * d.nc * sh.cbc);
  w->doff = take(bh * sp);
  w->sterm = take(bh * sp);
  w->xdxd = take(bh * sp);
  w->dyx = take(bh * sp);
  w->Mp = take(static_cast<long long>(d.b) * d.nc * sh.ngroups * sh.npairs *
               MT * MT);
  w->dBp = take(static_cast<long long>(sh.nhc) * d.b * sp * d.n);
  w->dCp = take(static_cast<long long>(sh.nhc) * d.b * sp * d.n);
  w->dAp = take(bh * d.nc);
  w->dDp = take(bh * d.nc);
}

// the copy of a tile whose rows allow no cp.async (x, B or C at an odd
// element offset): 8 elements a thread at a time, every load issued
// before the stores, so that their latencies overlap
__device__ void copy_tile_scalar(bf16* dst, int ld, const bf16* src,
                                 long long stride, int nrows, int nvalid,
                                 int width, int ncols) {
  const int total = nrows * width;
  for (int e0 = threadIdx.x; e0 < total; e0 += 8 * WT) {
    bf16 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = e0 + k * WT, r = e / width, col = e % width;
      v[k] = e < total && r < nvalid && col < ncols ? src[r * stride + col]
                                                     : __float2bfloat16_rn(0.f);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = e0 + k * WT;
      if (e < total) dst[e / width * ld + e % width] = v[k];
    }
  }
}

// copy_tile by the block's WT threads; in the kernels built for rows at
// an odd offset (ODD), copy_tile_scalar where vec is 1.  The others carry
// no scalar path: it costs the main path registers
template <bool ODD>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long stride, int nrows,
                                          int nvalid, int width, int ncols,
                                          int vec) {
  if (ODD && vec == 1)
    copy_tile_scalar(dst, ld, src, stride, nrows, nvalid, width, ncols);
  else
    copy_tile<WT>(dst, ld, src, stride, nrows, nvalid, width, ncols, vec);
}

size_t states_smem(int q) {
  return sizeof(bf16) * (2 * MT * LDP + 2 * MT * LDN) +
         sizeof(float) * (2 * static_cast<size_t>(q) + MT);
}

// a_cum of chunk c (one thread, in order, the forward's bits), then on the
// tensor cores the chunk's own state sum_j (x_j w_j dt_j)^T B_j (c < nc -
// 1) and its own state gradient sum_i (dy_i exp(a_cum_i))^T C_i (c > 0):
// the forward's ssd_kernel_states, x or dy scaled in registers between
// its transposed ldmatrix and its split into three bf16 parts
template <bool ODD>
__global__ void __launch_bounds__(WT)
    ssd_bwd_tc_states(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const bf16* __restrict__ Bm,
                      const bf16* __restrict__ Cm,
                      const bf16* __restrict__ dy, Work w, Dims d,
                      Strides st, Vec vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Er = reinterpret_cast<bf16*>(smem_raw);  // [2][MT][LDP] x or dy
  bf16* Nr = Er + 2 * MT * LDP;                  // [2][MT][LDN] B or C
  float* dts = reinterpret_cast<float*>(Nr + 2 * MT * LDN);  // [q]
  float* ac = dts + d.q;                                     // [q]
  float* wts = ac + d.q;  // [MT] each row's scale in a tile

  const int hh = blockIdx.x, c = blockIdx.y, bb = blockIdx.z;
  const int c0 = c * d.q, nv = min(d.q, d.s - c0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wp = (d.p + 15) & ~15, wn = (d.n + 15) & ~15;
  const int ntiles = (nv + MT - 1) / MT;
  const long long bh = static_cast<long long>(bb) * d.h + hh;

  const float a_h = A[hh];
  const float* dtb = dt + bb * st.db + hh * st.dh + c0 * st.ds;
  for (int i = tid; i < d.q; i += WT) dts[i] = i < nv ? dtb[i * st.ds] : 0.f;
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int i = 0; i < d.q; ++i) {
      run += a_h * dts[i];
      ac[i] = run;
    }
  }
  __syncthreads();
  for (int i = tid; i < d.q; i += WT) w.acum[bh * d.sp() + c0 + i] = ac[i];
  const float a_last = ac[d.q - 1];

  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 0 ? c == d.nc - 1 : c == 0) continue;  // never read
    const bf16* eb =
        pass == 0 ? x + bb * st.xb + hh * st.xh + c0 * st.xs
                  : dy + (static_cast<long long>(bb) * d.s + c0) * d.h * d.p +
                        static_cast<long long>(hh) * d.p;
    const long long es =
        pass == 0 ? st.xs : static_cast<long long>(d.h) * d.p;
    const bf16* nbase = pass == 0 ? Bm + bb * st.bb + c0 * st.bs
                                  : Cm + bb * st.cb + c0 * st.cs;
    const long long ns = pass == 0 ? st.bs : st.cs;
    const int ev = pass == 0 ? vec.x : vec.y, nvv = pass == 0 ? vec.b : vec.c;
    auto load = [&](int jt) {
      const int j0 = jt * MT;
      load_tile<ODD>(Er + (jt & 1) * MT * LDP, LDP, eb + j0 * es, es, MT,
                     nv - j0, wp, d.p, ev);
      load_tile<ODD>(Nr + (jt & 1) * MT * LDN, LDN, nbase + j0 * ns, ns, MT,
                     nv - j0, wn, d.n, nvv);
    };
    load(0);
    cp_async_commit();
    float acc[NMAX / 8][4];
#pragma unroll
    for (int j = 0; j < NMAX / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int jt = 0; jt < ntiles; ++jt) {
      if (jt + 1 < ntiles) load(jt + 1);
      cp_async_commit();
      const int j0 = jt * MT;
      if (tid < MT) {
        const int j = j0 + tid;
        wts[tid] = j >= nv ? 0.f
                   : pass == 0 ? expf(a_last - ac[j]) * dts[j]
                               : expf(ac[j]);
      }
      cp_async_wait<1>();
      __syncthreads();
      const bf16* er = Er + (jt & 1) * MT * LDP;
      const bf16* nr = Nr + (jt & 1) * MT * LDN;
      if (warp * 16 < d.p) {
#pragma unroll
        for (int kk = 0; kk < MT / 16; ++kk) {
          uint32_t a[4], ah[4], am[4], al[4];
          ldmatrix_x4_trans(a, er + (kk * 16 + (lane / 16) * 8 + lane % 8) *
                                        LDP +
                                   warp * 16 + ((lane / 8) & 1) * 8);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = kk * 16 + 2 * t4 + (e / 2) * 8;
            const __nv_bfloat162 v =
                *reinterpret_cast<const __nv_bfloat162*>(&a[e]);
            split3_bf16(__low2float(v) * wts[j],
                        __high2float(v) * wts[j + 1], ah[e], am[e], al[e]);
          }
#pragma unroll
          for (int nb = 0; nb < NMAX / 16; ++nb) {
            if (nb * 16 >= wn) break;
            uint32_t b[4];
            ldmatrix_x4_trans(
                b, nr + (kk * 16 + ((lane / 8) & 1) * 8 + lane % 8) * LDN +
                       nb * 16 + (lane / 16) * 8);
            mma_bf16(acc[2 * nb], ah, b[0], b[1]);
            mma_bf16(acc[2 * nb + 1], ah, b[2], b[3]);
            mma_bf16(acc[2 * nb], am, b[0], b[1]);
            mma_bf16(acc[2 * nb + 1], am, b[2], b[3]);
            mma_bf16(acc[2 * nb], al, b[0], b[1]);
            mma_bf16(acc[2 * nb + 1], al, b[2], b[3]);
          }
        }
      }
      __syncthreads();  // this stage and wts are rewritten next
    }
    float* out = (pass == 0 ? w.Sown : w.Gown) +
                 (bh * d.nc + c) * static_cast<long long>(d.p) * d.n;
#pragma unroll
    for (int j = 0; j < NMAX / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = warp * 16 + g + 8 * (e / 2);
        const int col = j * 8 + 2 * t4 + (e & 1);
        if (row < d.p && col < d.n) out[row * d.n + col] = acc[j][e];
      }
  }
}

// the sum over the 4 lanes of one g (xor 1, 2), in a fixed order
template <typename F>
__device__ __forceinline__ F quad_sum(F v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// v as NPART bf16 parts at dst, dst + stride, ...
__device__ __forceinline__ void put_parts(bf16* dst, long long stride,
                                          float v) {
#pragma unroll
  for (int part = 0; part < NPART; ++part) {
    const bf16 b = __float2bfloat16_rn(v);
    dst[part * stride] = b;
    v -= __bfloat162float(b);
  }
}

// the sum of v over the CW threads, warps in order, to every thread; red
// holds CW / 32 values
__device__ float carry_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < CW / 32; ++k) total += red[k];
  __syncthreads();
  return total;
}

// S_c = exp(a_last,c-1) S_c-1 + own_c-1 from S_0 = 0 and, in reverse,
// G_c-1 = own_c + exp(a_last,c) G_c from d_state (or 0), CE elements a
// thread, CW apart; S_c (c > 0) and each nonzero G_c go out in NPART bf16
// parts; <G_c, S_c> from the parts, which hold S_c exactly
__global__ void __launch_bounds__(CW)
    ssd_bwd_tc_carry(const float* __restrict__ d_state, Work w, Dims d) {
  __shared__ float red[CW / 32];
  const long long pn = static_cast<long long>(d.p) * d.n;
  const long long bh = static_cast<long long>(blockIdx.z) * d.h + blockIdx.y;
  const int e0 = blockIdx.x * CW * CE + threadIdx.x;
  const float* a_last = w.acum + bh * d.sp() + d.q - 1;
  float run[CE];
#pragma unroll
  for (int k = 0; k < CE; ++k) run[k] = 0.f;
  for (int c = 0; c + 1 < d.nc; ++c) {
    const float* own = w.Sown + (bh * d.nc + c) * pn;
    bf16* out = w.Sp + (bh * d.nc + c + 1) * NPART * pn;
    const float dec = expf(a_last[static_cast<long long>(c) * d.q]);
#pragma unroll
    for (int k = 0; k < CE; ++k) {
      const int e = e0 + k * CW;
      if (e < pn) {
        run[k] = run[k] * dec + own[e];
        put_parts(out + e, pn, run[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < CE; ++k) {
    const int e = e0 + k * CW;
    run[k] = d_state && e < pn ? d_state[bh * pn + e] : 0.f;
  }
  for (int c = d.nc - 1; c >= 0; --c) {
    const bool nonzero = c < d.nc - 1 || d_state;
    float dot = 0.f;
    if (nonzero) {
      bf16* out = w.Gp + (bh * d.nc + c) * NPART * pn;
      const bf16* S = w.Sp + (bh * d.nc + c) * NPART * pn;
#pragma unroll
      for (int k = 0; k < CE; ++k) {
        const int e = e0 + k * CW;
        if (e < pn) {
          put_parts(out + e, pn, run[k]);
          if (c > 0) {
            const float s = (__bfloat162float(S[e]) +
                             __bfloat162float(S[pn + e])) +
                            __bfloat162float(S[2 * pn + e]);
            dot = fmaf(run[k], s, dot);
          }
        }
      }
    }
    if (nonzero && c > 0) dot = carry_sum(dot, red);
    if (threadIdx.x == 0) w.gs[(bh * d.nc + c) * gridDim.x + blockIdx.x] = dot;
    if (c > 0) {
      const float* own = w.Gown + (bh * d.nc + c) * pn;
      const float dec = expf(a_last[static_cast<long long>(c) * d.q]);
#pragma unroll
      for (int k = 0; k < CE; ++k) {
        const int e = e0 + k * CW;
        if (e < pn) run[k] = own[e] + dec * run[k];
      }
    }
  }
}

// C of a row tile and the HG heads' dy
template <int HG>
constexpr int STAGE = MT * LDN + HG * MT * LDP;

template <int HG>
size_t cols_smem() {
  return sizeof(bf16) * (MT * LDN + HG * MT * LDP + 2 * STAGE<HG>) +
         sizeof(float) * 6 * HG * MT + sizeof(double) * 4 * HG * MT;
}

// one 64-row tile j of chunk c for a group of HG heads, walking the row
// tiles i >= j in 16-column slabs: C B^T once for the group; per head P =
// x_j dy_i^T (exact bf16 products), M^T = L o (P dt_j), T = M^T o (C B^T)
// in f64 (its column sums in registers, its row sums over the tile to
// rowp: each T tile formed once), dxd_j += (L o C B^T)^T dy_i with L o C
// B^T in three bf16 parts; the sum of M^T over the group's heads goes out
// in f32 for ssd_bwd_tc_sums; then G_c's terms, dx_j, x_j . dxd_j, dy_j .
// x_j.  Warp w owns rows 16 w .. 16 w + 15 of the tile
template <int HG, bool ODD>
__global__ void __launch_bounds__(WT, 2)
    ssd_bwd_tc_cols(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                    const float* __restrict__ D, const bf16* __restrict__ dy,
                    bf16* __restrict__ dxo, Work w, Dims d, Strides st,
                    Vec vec, int with_ds) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Bj = reinterpret_cast<bf16*>(smem_raw);  // [MT][LDN] B of tile j
  bf16* Xj = Bj + MT * LDN;                      // [HG][MT][LDP] x of tile j
  bf16* ring = Xj + HG * MT * LDP;  // 2 stages of C [MT][LDN], dy [HG][MT][LDP]
  // after the walk the ring holds a head's G_c: [NPART][PMAX][LDN]
  float* acj = reinterpret_cast<float*>(ring + 2 * STAGE<HG>);  // [HG][MT]
  float* dtj = acj + HG * MT;                               // [HG][MT]
  float* aci = dtj + HG * MT;  // [2][HG][MT] a_cum of each stage's rows
  double* red = reinterpret_cast<double*>(aci + 2 * HG * MT);  // [4][HG][MT]

  const Shape sh = shape_of(d);
  const int group = blockIdx.x / sh.ntq, jt = blockIdx.x % sh.ntq;
  const int h0 = group * HG, nh = min(HG, d.h - h0);
  const int c = blockIdx.y, bb = blockIdx.z;
  const int c0 = c * d.q, nv = min(d.q, d.s - c0), j0 = jt * MT;
  if (j0 >= nv) return;
  const int ntile = (nv + MT - 1) / MT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wp = (d.p + 15) & ~15, wn = (d.n + 15) & ~15;
  const long long hp = static_cast<long long>(d.h) * d.p;
  const bf16* dyc = dy + (static_cast<long long>(bb) * d.s + c0) * hp;

  load_tile<ODD>(Bj, LDN, Bm + bb * st.bb + (c0 + j0) * st.bs, st.bs, MT,
                 nv - j0, wn, d.n, vec.b);
  for (int hj = 0; hj < nh; ++hj)
    load_tile<ODD>(Xj + hj * MT * LDP, LDP,
                   x + bb * st.xb + (h0 + hj) * st.xh + (c0 + j0) * st.xs,
                   st.xs, MT, nv - j0, wp, d.p, vec.x);
  // row r of a tile's head hj: thread hj MT + r loads its a_cum and dt
  const int hl = tid / MT, rl = tid % MT;
  const long long bhl = static_cast<long long>(bb) * d.h + h0 + hl;
  auto load = [&](int it) {
    bf16* stage = ring + ((it - jt) & 1) * STAGE<HG>;
    const int i0 = it * MT;
    load_tile<ODD>(stage, LDN, Cm + bb * st.cb + (c0 + i0) * st.cs, st.cs,
                   MT, nv - i0, wn, d.n, vec.c);
    for (int hj = 0; hj < nh; ++hj)
      load_tile<ODD>(stage + MT * LDN + hj * MT * LDP, LDP,
                     dyc + i0 * hp + (h0 + hj) * d.p, hp, MT, nv - i0, wp,
                     d.p, vec.y);
    if (tid < HG * MT)
      aci[((it - jt) & 1) * HG * MT + tid] =
          hl < nh && i0 + rl < nv ? w.acum[bhl * d.sp() + c0 + i0 + rl]
                                  : 0.f;
  };
  if (tid < HG * MT) {
    const bool ok = hl < nh && j0 + rl < nv;
    acj[tid] = ok ? w.acum[bhl * d.sp() + c0 + j0 + rl] : 0.f;
    dtj[tid] = ok ? dt[bb * st.db + (c0 + j0 + rl) * st.ds + (h0 + hl) * st.dh]
                  : 0.f;
  }
  load(jt);
  cp_async_commit();

  float dxd[HG][PMAX / 8][4];
  double csum[HG][2];
#pragma unroll
  for (int hj = 0; hj < HG; ++hj) {
    csum[hj][0] = csum[hj][1] = 0.0;
#pragma unroll
    for (int k = 0; k < PMAX / 8; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxd[hj][k][e] = 0.f;
  }
  const int jw = warp * 16;  // the warp's first row in the tile
  uint32_t xa[HG][PMAX / 16][4];  // x_j's A fragments, fixed over the walk

  for (int it = jt; it < ntile; ++it) {
    if (it + 1 < ntile) load(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == jt) {
#pragma unroll
      for (int hj = 0; hj < HG; ++hj)
#pragma unroll
        for (int kk = 0; kk < PMAX / 16; ++kk)
          if (kk * 16 < wp)
            ldmatrix_x4(xa[hj][kk], Xj + hj * MT * LDP +
                                        (jw + lane % 16) * LDP + kk * 16 +
                                        (lane / 16) * 8);
    }
    const bf16* Ci = ring + ((it - jt) & 1) * STAGE<HG>;
    const bf16* Yi = Ci + MT * LDN;
    const float* ai = aci + ((it - jt) & 1) * HG * MT;
    const int i0 = it * MT;
    float* Mt = w.Mp + (((static_cast<long long>(bb) * d.nc + c) *
                             sh.ngroups + group) * sh.npairs +
                        it * (it + 1) / 2 + jt) * MT * MT;
    // 16-column slabs ib of the tile pair; on the diagonal the slabs left
    // of the warp's rows are 0
#pragma unroll 1
    for (int ib = 0; ib < MT / 16; ++ib) {
      if (it == jt && ib < warp) {
#pragma unroll
        for (int hj = 0; hj < HG; ++hj)
          if (g % 2 == 0)
            red[(warp * HG + hj) * MT + ib * 16 + (g / 4) * 8 + 2 * t4 +
                (g / 2) % 2] = 0.0;
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            *reinterpret_cast<float2*>(Mt + (jw + g + 8 * r) * MT + ib * 16 +
                                       h2 * 8 + 2 * t4) =
                make_float2(0.f, 0.f);
        continue;
      }
      float cb[2][4] = {};  // C B^T at [j][i]
#pragma unroll
      for (int kk = 0; kk < NMAX / 16; ++kk) {
        if (kk * 16 >= wn) break;
        uint32_t af[4], b[4];
        ldmatrix_x4(af, Bj + (jw + lane % 16) * LDN + kk * 16 +
                            (lane / 16) * 8);
        ldmatrix_x4(b, Ci + (ib * 16 + (lane / 16) * 8 + lane % 8) * LDN +
                           kk * 16 + ((lane / 8) & 1) * 8);
        mma_bf16(cb[0], af, b[0], b[1]);
        mma_bf16(cb[1], af, b[2], b[3]);
      }
      float ms[2][4] = {};  // M^T summed over the group's heads
#pragma unroll
      for (int hj = 0; hj < HG; ++hj) {
        if (hj >= nh) break;
        const bf16* Yh = Yi + hj * MT * LDP;
        float pm[2][4] = {};  // P^T = x_j dy_i^T, then L o C B^T
#pragma unroll
        for (int kk = 0; kk < PMAX / 16; ++kk) {
          if (kk * 16 >= wp) break;
          uint32_t b[4];
          ldmatrix_x4(b, Yh + (ib * 16 + (lane / 16) * 8 + lane % 8) * LDP +
                             kk * 16 + ((lane / 8) & 1) * 8);
          mma_bf16(pm[0], xa[hj][kk], b[0], b[1]);
          mma_bf16(pm[1], xa[hj][kk], b[2], b[3]);
        }
        // M^T = L (P dt_j), T = M^T (C B^T) on and below the diagonal
        // (i >= j; select, never inf x 0); L o C B^T in place of P.  rs:
        // T over the thread's two rows, column 8 h2 + 2 t4 + e at 2 h2 + e
        double rs[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int jl = jw + g + 8 * r;
          const float aj = acj[hj * MT + jl], dj = dtj[hj * MT + jl];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int il = ib * 16 + h2 * 8 + 2 * t4 + e;
              const bool ok = i0 + il < nv && j0 + jl <= i0 + il;
              const float l = ok ? expf(ai[hj * MT + il] - aj) : 0.f;
              const float m = l * (pm[h2][2 * r + e] * dj);
              const float cbv = cb[h2][2 * r + e];
              const double t = static_cast<double>(m) * cbv;
              csum[hj][r] += t;
              rs[2 * h2 + e] = r == 0 ? t : rs[2 * h2 + e] + t;
              ms[h2][2 * r + e] += m;
              pm[h2][2 * r + e] = l * cbv;
            }
        }
        // rs over the 8 lanes of this t4: xor 16 keeps two of four, xor 8
        // one, xor 4 adds; lanes of even g hold column 8 (g / 4) + 2 t4 +
        // (g / 2) % 2
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const bool up = g & 4;
          const double mine = up ? rs[k + 2] : rs[k];
          const double give = up ? rs[k] : rs[k + 2];
          rs[k] = mine + __shfl_xor_sync(0xffffffffu, give, 16);
        }
        {
          const bool up = g & 2;
          const double mine = up ? rs[1] : rs[0];
          const double give = up ? rs[0] : rs[1];
          rs[0] = mine + __shfl_xor_sync(0xffffffffu, give, 8);
        }
        const double other = __shfl_xor_sync(0xffffffffu, rs[0], 4);
        if (g % 2 == 0)
          red[(warp * HG + hj) * MT + ib * 16 + (g / 4) * 8 + 2 * t4 +
              (g / 2) % 2] = rs[0] + other;
        // dxd_j += (L o C B^T)^T dy_i: the slab is one k-step, its A
        // operand the fragments in three bf16 parts
        uint32_t ap[NPART][4];
        split3_bf16(pm[0][0], pm[0][1], ap[0][0], ap[1][0], ap[2][0]);
        split3_bf16(pm[0][2], pm[0][3], ap[0][1], ap[1][1], ap[2][1]);
        split3_bf16(pm[1][0], pm[1][1], ap[0][2], ap[1][2], ap[2][2]);
        split3_bf16(pm[1][2], pm[1][3], ap[0][3], ap[1][3], ap[2][3]);
#pragma unroll
        for (int pb = 0; pb < PMAX / 16; ++pb) {
          if (pb * 16 >= wp) break;
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, Yh + (ib * 16 + ((lane / 8) & 1) * 8 + lane % 8) * LDP +
                     pb * 16 + (lane / 16) * 8);
#pragma unroll
          for (int part = 0; part < NPART; ++part) {
            mma_bf16(dxd[hj][2 * pb], ap[part], b[0], b[1]);
            mma_bf16(dxd[hj][2 * pb + 1], ap[part], b[2], b[3]);
          }
        }
      }
      // the group's M^T, [j][i] in f32
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          *reinterpret_cast<float2*>(Mt + (jw + g + 8 * r) * MT + ib * 16 +
                                     h2 * 8 + 2 * t4) =
              make_float2(ms[h2][2 * r], ms[h2][2 * r + 1]);
    }
    __syncthreads();  // red written
    if (hl < nh && i0 + rl < nv) {
      const double* rv = red + hl * MT + rl;
      const double sum = ((rv[0] + rv[HG * MT]) + rv[2 * HG * MT]) +
                         rv[3 * HG * MT];
      w.rowp[((bhl * d.nc + c) * sh.ntq + jt) * d.q + i0 + rl] = sum;
    }
    __syncthreads();  // this stage and red are rewritten next
  }

  // G_c's terms where G_c is nonzero: gb_j = G_c B_j (G_c in three bf16
  // parts, one head at a time in the ring); dxd_j += w_j gb_j and sterm_j
  // = w_j xd_j . gb_j
  const long long pn = static_cast<long long>(d.p) * d.n;
  float sterm[HG][2];
#pragma unroll
  for (int hj = 0; hj < HG; ++hj) sterm[hj][0] = sterm[hj][1] = 0.f;
  if (c < d.nc - 1 || with_ds) {
#pragma unroll
    for (int hj = 0; hj < HG; ++hj) {
      if (hj >= nh) break;
      const long long bhc =
          (static_cast<long long>(bb) * d.h + h0 + hj) * d.nc + c;
      for (int part = 0; part < NPART; ++part)
        load_tile<ODD>(ring + part * PMAX * LDN, LDN,
                       w.Gp + (bhc * NPART + part) * pn, d.n, wp, d.p, wn,
                       d.n, vec.s);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      float gb[PMAX / 8][4];
#pragma unroll
      for (int k = 0; k < PMAX / 8; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) gb[k][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NMAX / 16; ++kk) {
        if (kk * 16 >= wn) break;
        uint32_t af[4];
        ldmatrix_x4(af, Bj + (jw + lane % 16) * LDN + kk * 16 +
                            (lane / 16) * 8);
#pragma unroll
        for (int pb = 0; pb < PMAX / 16; ++pb) {
          if (pb * 16 >= wp) break;
          const int at = (pb * 16 + (lane / 16) * 8 + lane % 8) * LDN +
                         kk * 16 + ((lane / 8) & 1) * 8;
#pragma unroll
          for (int part = 0; part < NPART; ++part) {
            uint32_t b[4];
            ldmatrix_x4(b, ring + part * PMAX * LDN + at);
            mma_bf16(gb[2 * pb], af, b[0], b[1]);
            mma_bf16(gb[2 * pb + 1], af, b[2], b[3]);
          }
        }
      }
      const float a_last = w.acum[(bhc / d.nc) * d.sp() + c0 + d.q - 1];
      const bf16* Xh = Xj + hj * MT * LDP;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int jl = jw + g + 8 * r;
        const float wj =
            j0 + jl < nv ? expf(a_last - acj[hj * MT + jl]) : 0.f;
        const float dj = dtj[hj * MT + jl];
        float ss = 0.f;
#pragma unroll
        for (int k = 0; k < PMAX / 8; ++k)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int pp = k * 8 + 2 * t4 + e;
            float& v = dxd[hj][k][2 * r + e];
            v = fmaf(wj, gb[k][2 * r + e], v);
            if (pp < d.p)
              ss = fmaf(__bfloat162float(Xh[jl * LDP + pp]) * dj,
                        gb[k][2 * r + e], ss);
          }
        sterm[hj][r] = wj * quad_sum(ss);
      }
      __syncthreads();  // the ring holds the next head's G_c next
    }
  }

  // dx = dt dxd + D dy; x . dxd, dy . x, the column sums of T, sterm
#pragma unroll
  for (int hj = 0; hj < HG; ++hj) {
    if (hj >= nh) break;
    const int hh = h0 + hj;
    const long long bh = static_cast<long long>(bb) * d.h + hh;
    const float d_h = D[hh];
    const bf16* Xh = Xj + hj * MT * LDP;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int jl = jw + g + 8 * r, j = j0 + jl;
      const bool ok = j < nv;
      const float dj = dtj[hj * MT + jl];
      const bf16* dyrow = dyc + (ok ? j : 0) * hp + hh * d.p;
      bf16* dxrow = dxo + (static_cast<long long>(bb) * d.s + c0 + j) * hp +
                    hh * d.p;
      float xs = 0.f, yx = 0.f;
#pragma unroll
      for (int k = 0; k < PMAX / 8; ++k)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pp = k * 8 + 2 * t4 + e;
          if (ok && pp < d.p) {
            const float v = dxd[hj][k][2 * r + e];
            const float xv = __bfloat162float(Xh[jl * LDP + pp]);
            const float yv = __bfloat162float(dyrow[pp]);
            xs = fmaf(xv, v, xs);
            yx = fmaf(yv, xv, yx);
            dxrow[pp] = __float2bfloat16_rn(dj * v + d_h * yv);
          }
        }
      const double cs = quad_sum(csum[hj][r]);
      xs = quad_sum(xs);
      yx = quad_sum(yx);
      if (ok && t4 == 0) {
        const long long at = bh * d.sp() + c0 + j;
        w.dcol[at] = cs;
        w.sterm[at] = sterm[hj][r];
        w.xdxd[at] = xs;
        w.dyx[at] = yx;
      }
    }
  }
}

size_t sums_smem() { return sizeof(bf16) * MT * LDN + 2 * USTAGE; }

// the products with the sum of M^T over heads, for one 64-row tile t of
// chunk c and a group of HC heads, its groups' M^T added in f32 first (in
// order; B and C are shared by all heads): side 0, dC_t = sum_j M_tj B_j
// over the column tiles j <= t, then each head's exp(a_cum_t) dy_t S_c (c
// > 0) and its part of d a_cum_t, exp(a_cum_t) u_t . C_t; side 1, dB_t =
// sum_i M^T_ti C_i over the row tiles i >= t, then each head's w_t dt_t
// x_t G_c (where G_c is nonzero).  M^T in f32 (written by
// ssd_bwd_tc_cols) split into three bf16 parts as its A fragments are
// formed, S_c and G_c in three parts, against exact bf16 B, C, dy and x;
// the heads summed in registers in order, the group's sum to dBp or dCp.
// Ranked so that the blocks with the most products start first
template <bool ODD>
__global__ void __launch_bounds__(WT, 2)
    ssd_bwd_tc_sums(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                    const bf16* __restrict__ dy, Work w, Dims d, Strides st,
                    Vec vec, int with_ds) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ct = reinterpret_cast<bf16*>(smem_raw);  // [MT][LDN] C of tile t
  // 2 stages of M^T [MT][LDM] (f32) and B or C [MT][LDN] (bf16), USTAGE
  // bytes each; then a head's dy or x [MT][LDP] and S_c or G_c
  // [NPART][PMAX][LDN]
  unsigned char* ring = smem_raw + sizeof(bf16) * MT * LDN;

  const Shape sh = shape_of(d);
  const int per = 2 * sh.ntq;
  const int hc = blockIdx.x / per, rank = blockIdx.x % per;
  const int side = rank & 1;  // ranks 2k, 2k + 1 make ntq - k products
  const int t = side ? rank / 2 : sh.ntq - 1 - rank / 2;
  const int hh0 = hc * sh.hc, nhh = min(sh.hc, d.h - hh0);
  const int gfirst = hh0 / sh.hg;
  const int ngrp = (hh0 + nhh - 1) / sh.hg - gfirst + 1;
  const int c = blockIdx.y, bb = blockIdx.z;
  const int c0 = c * d.q, nv = min(d.q, d.s - c0), t0 = t * MT;
  if (t0 >= nv) return;
  const int ntile = (nv + MT - 1) / MT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wp = (d.p + 15) & ~15, wn = (d.n + 15) & ~15;
  const int jw = warp * 16;
  const long long hp = static_cast<long long>(d.h) * d.p;
  const long long pn = static_cast<long long>(d.p) * d.n;
  const int nother = side ? ntile - t : t + 1, ofirst = side ? t : 0;
  // unit u: the other tile ofirst + u / ngrp, the group gfirst + u % ngrp;
  // a tile's last unit also brings its B or C
  const int nunits = ngrp * nother;

  if (side == 0)
    load_tile<ODD>(Ct, LDN, Cm + bb * st.cb + (c0 + t0) * st.cs, st.cs, MT,
                   nv - t0, wn, d.n, vec.c);
  auto load = [&](int u) {
    const int o = ofirst + u / ngrp, grp = gfirst + u % ngrp;
    const int pair = side ? o * (o + 1) / 2 + t : t * (t + 1) / 2 + o;
    float* Mf = reinterpret_cast<float*>(ring + (u & 1) * USTAGE);
    const float* Mt = w.Mp + (((static_cast<long long>(bb) * d.nc + c) *
                                   sh.ngroups + grp) * sh.npairs + pair) *
                                 MT * MT;
    for (int e = tid; e < MT * MT / 4; e += WT) {
      const int r = e / (MT / 4), c4 = e % (MT / 4) * 4;
      repro_torch::cp_async16(Mf + r * LDM + c4, Mt + r * MT + c4, true);
    }
    if (u % ngrp != ngrp - 1) return;
    bf16* Nt = reinterpret_cast<bf16*>(Mf + MT * LDM);
    const int o0 = o * MT;
    if (side)
      load_tile<ODD>(Nt, LDN, Cm + bb * st.cb + (c0 + o0) * st.cs, st.cs, MT,
                     nv - o0, wn, d.n, vec.c);
    else
      load_tile<ODD>(Nt, LDN, Bm + bb * st.bb + (c0 + o0) * st.bs, st.bs, MT,
                     nv - o0, wn, d.n, vec.b);
  };
  load(0);
  cp_async_commit();

  float acc[NMAX / 8][4];
#pragma unroll
  for (int k = 0; k < NMAX / 8; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[k][e] = 0.f;
  // the warp's A fragments of M (rows t, k the other tile) in f32, summed
  // over the block's groups in order: side 1 M^T as stored, side 0 M, the
  // stored tile transposed
  float af[MT / 16][4][2];
  for (int u = 0; u < nunits; ++u) {
    if (u + 1 < nunits) load(u + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Mf =
        reinterpret_cast<const float*>(ring + (u & 1) * USTAGE);
    const bool diag = ofirst + u / ngrp == t;
#pragma unroll
    for (int kk = 0; kk < MT / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = jw + g + 8 * (e & 1);
        const int k = kk * 16 + 2 * t4 + 8 * (e >> 1);
        const float v0 = side ? Mf[row * LDM + k] : Mf[k * LDM + row];
        const float v1 =
            side ? Mf[row * LDM + k + 1] : Mf[(k + 1) * LDM + row];
        af[kk][e][0] = u % ngrp ? af[kk][e][0] + v0 : v0;
        af[kk][e][1] = u % ngrp ? af[kk][e][1] + v1 : v1;
      }
    if (u % ngrp == ngrp - 1) {
      const bf16* Nt = reinterpret_cast<const bf16*>(Mf + MT * LDM);
#pragma unroll
      for (int kk = 0; kk < MT / 16; ++kk) {
        // on the diagonal tile, M is 0 where the column passes the row
        if (diag && (side ? kk < warp : kk > warp)) continue;
        uint32_t a[NPART][4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split3_bf16(af[kk][e][0], af[kk][e][1], a[0][e], a[1][e],
                      a[2][e]);
#pragma unroll
        for (int nb = 0; nb < NMAX / 16; ++nb) {
          if (nb * 16 >= wn) break;
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, Nt + (kk * 16 + ((lane / 8) & 1) * 8 + lane % 8) * LDN +
                     nb * 16 + (lane / 16) * 8);
#pragma unroll
          for (int part = 0; part < NPART; ++part) {
            mma_bf16(acc[2 * nb], a[part], b[0], b[1]);
            mma_bf16(acc[2 * nb + 1], a[part], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is reloaded two units on
  }

  // each head's state term: side 0 u = dy_t S_c (S_c is 0 in chunk 0),
  // side 1 v = x_t G_c (G_c is 0 in the last chunk without d_state)
  if (side == 0 ? c > 0 : c < d.nc - 1 || with_ds) {
    bf16* E = reinterpret_cast<bf16*>(ring);  // [MT][LDP] dy or x
    bf16* Z = E + MT * LDP;  // [NPART][PMAX][LDN] S_c or G_c
    for (int hk = 0; hk < nhh; ++hk) {
      const int hh = hh0 + hk;
      const long long bh = static_cast<long long>(bb) * d.h + hh;
      if (side)
        load_tile<ODD>(E, LDP, x + bb * st.xb + hh * st.xh + (c0 + t0) * st.xs,
                       st.xs, MT, nv - t0, wp, d.p, vec.x);
      else
        load_tile<ODD>(E, LDP,
                       dy + (static_cast<long long>(bb) * d.s + c0 + t0) * hp +
                           hh * d.p,
                       hp, MT, nv - t0, wp, d.p, vec.y);
      const bf16* zs = (side ? w.Gp : w.Sp) + (bh * d.nc + c) * NPART * pn;
      for (int part = 0; part < NPART; ++part)
        load_tile<ODD>(Z + part * PMAX * LDN, LDN, zs + part * pn, d.n, wp,
                       d.p, wn, d.n, vec.s);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      float u[NMAX / 8][4];
#pragma unroll
      for (int k = 0; k < NMAX / 8; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) u[k][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < PMAX / 16; ++kk) {
        if (kk * 16 >= wp) break;
        uint32_t a[4];
        ldmatrix_x4(a, E + (jw + lane % 16) * LDP + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int nb = 0; nb < NMAX / 16; ++nb) {
          if (nb * 16 >= wn) break;
          const int at = (kk * 16 + ((lane / 8) & 1) * 8 + lane % 8) * LDN +
                         nb * 16 + (lane / 16) * 8;
#pragma unroll
          for (int part = 0; part < NPART; ++part) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, Z + part * PMAX * LDN + at);
            mma_bf16(u[2 * nb], a, b[0], b[1]);
            mma_bf16(u[2 * nb + 1], a, b[2], b[3]);
          }
        }
      }
      const float* ac = w.acum + bh * d.sp() + c0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int il = jw + g + 8 * r, i = t0 + il;
        const bool ok = i < nv;
        const float sc =
            !ok ? 0.f
            : side ? expf(ac[d.q - 1] - ac[i]) *
                         dt[bb * st.db + (c0 + i) * st.ds + hh * st.dh]
                   : expf(ac[i]);
        float os = 0.f;
#pragma unroll
        for (int k = 0; k < NMAX / 8; ++k)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = u[k][2 * r + e];
            acc[k][2 * r + e] = fmaf(sc, v, acc[k][2 * r + e]);
            const int nn = k * 8 + 2 * t4 + e;
            if (side == 0 && nn < d.n)
              os = fmaf(v, __bfloat162float(Ct[il * LDN + nn]), os);
          }
        if (side == 0) {
          os = quad_sum(os);
          if (ok && t4 == 0) w.doff[bh * d.sp() + c0 + i] = sc * os;
        }
      }
      __syncthreads();  // the ring holds the next head's tiles next
    }
  }

  float* out = (side ? w.dBp : w.dCp) +
               ((static_cast<long long>(hc) * d.b + bb) * d.sp() + c0 + t0) *
                   d.n;
#pragma unroll
  for (int k = 0; k < NMAX / 8; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = jw + g + 8 * (e / 2), col = k * 8 + 2 * t4 + (e & 1);
      if (t0 + row < nv && col < d.n) out[row * d.n + col] = acc[k][e];
    }
}

// d a_cum of chunk c: the row sums of T over the column tiles in order,
// plus the off-diagonal term (c > 0), minus the column sums and the state
// terms; its reverse sum, ddt and the chunk's parts of dA and dD, as
// ssd_bwd_final, in f64 and rounded to f32 once
__global__ void __launch_bounds__(NT)
    ssd_bwd_tc_final(const float* __restrict__ dt,
                     const float* __restrict__ A, float* __restrict__ ddt,
                     Work w, Dims d, Strides st) {
  extern __shared__ double smd[];
  double* da = smd;             // [q] d a_cum, then da
  double* red = da + d.q;       // [NT] the tree sums
  const Shape sh = shape_of(d);
  const int c = blockIdx.x;
  const int bb = blockIdx.y / d.h, hh = blockIdx.y % d.h;
  const int c0 = c * d.q, nv = min(d.q, d.s - c0), tid = threadIdx.x;
  const long long bh = static_cast<long long>(bb) * d.h + hh;
  const long long at = bh * d.sp() + c0;
  const double* rowp = w.rowp + (bh * d.nc + c) * sh.ntq * d.q;
  const float* dtb = dt + bb * st.db + hh * st.dh;
  double part = 0.0;
  for (int i = tid; i < nv; i += NT) {
    double rows = 0.0;
    for (int jt = 0; jt <= i / MT; ++jt) rows += rowp[jt * d.q + i];
    const double sv = w.sterm[at + i];
    part += sv;
    da[i] = rows + (c > 0 ? w.doff[at + i] : 0.f) - w.dcol[at + i] - sv;
  }
  const double sum_st = block_sum(part, red);
  if (tid == 0) {
    double gs = 0.0;
    for (int k = 0; k < sh.cbc; ++k) gs += w.gs[(bh * d.nc + c) * sh.cbc + k];
    const double a_last = w.acum[at + d.q - 1];
    da[nv - 1] += sum_st + exp(a_last) * gs;
    double run = 0.0;
    for (int i = nv - 1; i >= 0; --i) {
      run += da[i];
      da[i] = run;
    }
  }
  __syncthreads();
  const double a_h = A[hh];
  double pa = 0.0, pd = 0.0;
  for (int i = tid; i < nv; i += NT) {
    ddt[(static_cast<long long>(bb) * d.s + c0 + i) * d.h + hh] =
        static_cast<float>(w.xdxd[at + i] + a_h * da[i]);
    pa += dtb[(c0 + i) * st.ds] * da[i];
    pd += w.dyx[at + i];
  }
  const double dA = block_sum(pa, red);
  const double dD = block_sum(pd, red);
  if (tid == 0) {
    w.dAp[bh * d.nc + c] = static_cast<float>(dA);
    w.dDp[bh * d.nc + c] = static_cast<float>(dD);
  }
}

// the six launches, with the kernels built for rows at an odd offset or
// not (ODD); each build keeps the shared-memory limits of its own kernels
// (sm_final: the final kernel's, which both builds launch, set by the
// caller)
template <bool ODD>
int run(const bf16* x, const float* dt, const float* A, const bf16* B,
        const bf16* C, const float* D, const bf16* dy, const float* d_state,
        bf16* dx, float* ddt, float* dA, bf16* dB, bf16* dC, float* dD,
        const Work& w, const Dims& d, const Shape& sh, const Strides& st,
        const Vec& vec, size_t sm_final, cudaStream_t stream) {
  static size_t ok_states = 0, ok_cols1 = 0, ok_cols2 = 0, ok_sums = 0;
  const size_t sm_states = states_smem(d.q), sm_sums = sums_smem();
  cudaError_t err;
  if ((err = allow_smem(ssd_bwd_tc_states<ODD>, sm_states, &ok_states)) ||
      (err = allow_smem(ssd_bwd_tc_cols<1, ODD>, cols_smem<1>(),
                        &ok_cols1)) ||
      (err = allow_smem(ssd_bwd_tc_cols<HG, ODD>, cols_smem<HG>(),
                        &ok_cols2)) ||
      (err = allow_smem(ssd_bwd_tc_sums<ODD>, sm_sums, &ok_sums)))
    return static_cast<int>(err);
  const int with_ds = d_state != nullptr;
  ssd_bwd_tc_states<ODD><<<dim3(d.h, d.nc, d.b), WT, sm_states, stream>>>(
      x, dt, A, B, C, dy, w, d, st, vec);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  ssd_bwd_tc_carry<<<dim3(sh.cbc, d.h, d.b), CW, 0, stream>>>(d_state, w,
                                                              d);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  const dim3 cols(sh.ntq * sh.ngroups, d.nc, d.b);
  if (sh.hg == HG)
    ssd_bwd_tc_cols<HG, ODD><<<cols, WT, cols_smem<HG>(), stream>>>(
        x, dt, B, C, D, dy, dx, w, d, st, vec, with_ds);
  else
    ssd_bwd_tc_cols<1, ODD><<<cols, WT, cols_smem<1>(), stream>>>(
        x, dt, B, C, D, dy, dx, w, d, st, vec, with_ds);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  ssd_bwd_tc_sums<ODD><<<dim3(2 * sh.ntq * sh.nhc, d.nc, d.b), WT, sm_sums,
                         stream>>>(x, dt, B, C, dy, w, d, st, vec, with_ds);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  ssd_bwd_tc_final<<<dim3(d.nc, static_cast<unsigned>(d.b) * d.h), NT,
                      sm_final, stream>>>(dt, A, ddt, w, d, st);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  const long long total = static_cast<long long>(d.b) * d.s * d.n;
  ssd_bwd_reduce<bf16><<<static_cast<unsigned>((total + NT - 1) / NT), NT,
                         0, stream>>>(dB, dC, dA, dD, w.dBp, w.dCp, w.dAp,
                                      w.dDp, sh.nhc, d);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, const float* D, const void* dy,
           const float* d_state, void* dx, float* ddt, float* dA, void* dB,
           void* dC, float* dD, float* ws, const Dims& d,
           const long long* s10, cudaStream_t stream) {
  static size_t ok_final = 0;
  const size_t sm_final = sizeof(double) * (static_cast<size_t>(d.q) + NT);
  if (const cudaError_t err =
          allow_smem(ssd_bwd_tc_final, sm_final, &ok_final))
    return static_cast<int>(err);
  const Shape sh = shape_of(d);
  Work w;
  carve(ws, d, sh, &w);
  const Strides st{s10[0], s10[1], s10[2], s10[3], s10[4],
                   s10[5], s10[6], s10[7], s10[8], s10[9]};
  const long long dys[2] = {static_cast<long long>(d.h) * d.p, d.p};
  const long long row = d.n;
  const Vec vec{vec_of(x, s10, 3, d.p), vec_of(dy, dys, 2, d.p),
                vec_of(B, s10 + 6, 2, d.n), vec_of(C, s10 + 8, 2, d.n),
                vec_of(w.Sp, &row, 1, d.n)};
  const bool odd = vec.x == 1 || vec.y == 1 || vec.b == 1 || vec.c == 1 ||
                   vec.s == 1;
  auto go = odd ? run<true> : run<false>;
  return go(static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(B),
            static_cast<const bf16*>(C), D, static_cast<const bf16*>(dy),
            d_state, static_cast<bf16*>(dx), ddt, dA, static_cast<bf16*>(dB),
            static_cast<bf16*>(dC), dD, w, d, sh, st, vec, sm_final, stream);
}

}  // namespace tc

}  // namespace

// x [b, s, h, p], B and C [b, s, n] in f32 (bf16 == 0) or bf16 (bf16 == 1)
// with the element strides of x's (batch, seq, head) dims, dt's (batch,
// seq, head) dims, B's and C's (batch, seq) dims in st[10] (last dims
// contiguous); dt [b, s, h], A [h] and D [h] in f32; dy [b, s, h, p]
// contiguous in x's type; d_state [b, h, p, n] f32 contiguous, or null
// (zeros).  Writes dx [b, s, h, p], dB and dC [b, s, n] (contiguous, x's
// type), ddt [b, s, h], dA and dD [h] (contiguous, f32).  p <= 64, n <=
// 128, 1 <= q.  `work`, 8-byte aligned, holds in f32 b h (nc (2 p n + 10)
// + 8 nc q) + 2 h b nc q n floats; in bf16, with t = ceil(q / 64), sp = nc
// q, and hg and hc the heads of a column and of a sums block (tc::
// shape_of), 2 b h nc t q + 3 b h sp + 2 b h nc p n + 2 (3 b h nc p n / 2
// + 1) + b h nc ceil(p n / 1024) + 4 b h sp + b nc ceil(h / hg) t (t + 1)
// / 2 64 64 + 2 ceil(h / hc) b sp n + 2 b h nc + 136 floats (nc = ceil(s
// / q); ops.py's _backward_work).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int ssd_scan_bwd(const void* x, const float* dt, const float* A,
                            const void* B, const void* C, const float* D,
                            const void* dy, const float* d_state, void* dx,
                            float* ddt, float* dA, void* dB, void* dC,
                            float* dD, float* work, int b, int s, int h, int p,
                            int n, int q, const long long* st, int bf16,
                            void* stream) {
  if (b < 1 || s < 1 || h < 1 || p < 1 || p > PMAX || n < 1 || n > NMAX ||
      q < 1 || static_cast<long long>(b) * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{b, s, h, p, n, q, (s + q - 1) / q};
  if (d.nc > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (bf16)
    return tc::launch(x, dt, A, B, C, D, dy, d_state, dx, ddt, dA, dB, dC,
                      dD, work, d, st, cs);
  return launch<float>(x, dt, A, B, C, D, dy, d_state, dx, ddt, dA, dB, dC,
                       dD, work, d, st, cs);
}
