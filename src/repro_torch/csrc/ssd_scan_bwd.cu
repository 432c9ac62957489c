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
// Six launches on the CUDA cores in f32 (--fmad=false, fmaf where a
// product is meant to be fused; the sums of d a_cum in f64), no atomics:
// two calls give equal bits.  d a_cum nearly cancels: each T_ij is added
// at i and taken at j, and over a chunk whose a_cum reaches thousands the
// row and column sums dwarf their difference.  Both kernels form each
// T_ij with the same bits and add it up in f64 (a product of two floats
// is exact there), so the pairs inside any suffix of the chunk cancel
// exactly in the reverse sum (summed in f32, their rounding alone moves
// an f32 model's A_log gradient ~1e-4 of its largest value).
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
// contiguous.
//
// Bound on the H100: at mamba2-370m's training shape (8, 512, 32, 64,
// 128), chunk 256, the work is 20.6 GFLOP (the causal pairs' dot products
// and sums, the state products) against 56 MB read and written in bf16:
// the operations, 0.021 ms at the bf16 tensor-core peak (the bytes take
// 0.017 ms); in f32 the operations, 0.31 ms at the CUDA cores' peak.  This
// first design runs every product on the CUDA cores in f32, and puts the
// per-head dB and dC (67 MB each at that shape) through an f32 workspace
// the caller gives; the tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void put(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

struct Strides {
  long long xb, xs, xh;  // x [b, s, h, p], the last dim contiguous
  long long db, ds, dh;  // dt [b, s, h]
  long long bb, bs;      // B [b, s, n], the last dim contiguous
  long long cb, cs;      // C [b, s, n], the last dim contiguous
};

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

// dB and dC [b, s, n] summed over the heads in order; block 0 also sums
// dA and dD over (batch, chunk) in order
template <typename T>
__global__ void __launch_bounds__(NT)
    ssd_bwd_reduce(T* __restrict__ dB, T* __restrict__ dC,
                   float* __restrict__ dA, float* __restrict__ dD, Work w,
                   Dims d) {
  const long long total = static_cast<long long>(d.b) * d.s * d.n;
  const long long e = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (e < total) {
    const long long bb = e / (static_cast<long long>(d.s) * d.n);
    const long long rem = e % (static_cast<long long>(d.s) * d.n);
    const long long from = bb * d.sp() * d.n + rem;
    const long long head = static_cast<long long>(d.b) * d.sp() * d.n;
    float sb = 0.f, sc = 0.f;
    for (int hh = 0; hh < d.h; ++hh) {
      sb += w.dBp[hh * head + from];
      sc += w.dCp[hh * head + from];
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
          sa += w.dAp[at];
          sd += w.dDp[at];
        }
      dA[hh] = sa;
      dD[hh] = sd;
    }
  }
}

// raise a kernel's dynamic shared-memory limit to `bytes` once
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
                stream>>>(static_cast<T*>(dB), static_cast<T*>(dC), dA, dD,
                          w, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [b, s, h, p], B and C [b, s, n] in f32 (bf16 == 0) or bf16 (bf16 == 1)
// with the element strides of x's (batch, seq, head) dims, dt's (batch,
// seq, head) dims, B's and C's (batch, seq) dims in st[10] (last dims
// contiguous); dt [b, s, h], A [h] and D [h] in f32; dy [b, s, h, p]
// contiguous in x's type; d_state [b, h, p, n] f32 contiguous, or null
// (zeros).  Writes dx [b, s, h, p], dB and dC [b, s, n] (contiguous, x's
// type), ddt [b, s, h], dA and dD [h] (contiguous, f32).  p <= 64, n <=
// 128, 1 <= q.  `work`, 8-byte aligned, holds b h (nc (2 p n + 10) + 8 nc
// q) + 2 h b nc q n floats, nc = ceil(s / q).  Launches on `stream` and returns
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
    return launch<__nv_bfloat16>(x, dt, A, B, C, D, dy, d_state, dx, ddt, dA,
                                 dB, dC, dD, work, d, st, cs);
  return launch<float>(x, dt, A, B, C, D, dy, d_state, dx, ddt, dA, dB, dC,
                       dD, work, d, st, cs);
}
