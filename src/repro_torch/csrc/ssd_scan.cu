// Mamba-2 SSD (state-space duality) chunked scan, prefill, from a zero
// state, with the final state written out.
//
// Replaces the TPU kernel repro/kernels/ssd_scan/ssd_scan.py::ssd_pallas
// (_ssd_kernel), whose grid walked the chunks of one (batch, head) in
// order and carried the [P, N] state in VMEM scratch; it returned the
// final state by recomputing the whole scan on the XLA path.
//
// Per chunk of q rows (the caller's chunk, 256 for mamba2-370m), with
// xd = x * dt and a_cum the cumulative sum of A * dt over the whole chunk:
//   y[i]  = sum_{j <= i} exp(a_cum_i - a_cum_j) (C_i . B_j) xd[j]
//         + exp(a_cum_i) C_i . S^T + D x[i]
//   S'    = exp(a_cum_last) S + sum_j exp(a_cum_last - a_cum_j) xd[j] B_j^T
// Every decay is the difference of two chunk-wide sums, as in the JAX
// formula: the sums are not restarted per tile.  They are taken in order
// by one thread, in f32, so that a_cum_i - a_cum_j carries the rounding of
// the steps j+1..i only.  Above the diagonal the difference is positive
// and its exp may overflow: the kernels select 0 there, never inf x 0.
// Rows past S (a ragged last chunk) read as dt = 0, x = B = C = 0: decay 1
// and no input, as the plain version pads.
//
// Bound on the H100: bytes (x, y, B, C, dt and the final state: 43.7 MB at
// mamba2-370m's batch of 8 x 500 tokens, 13 us) over operations (~5 GFLOP,
// 5 us at the bf16 tensor-core peak).
//
// bf16 (the serving path): three kernels, the chunk-parallel dataflow of
// the Mamba-2 paper (arXiv:2405.21060, section 6), every product on the
// tensor cores (mma.sync m16n8k16, bf16 operands, f32 accumulators) and
// every tile brought in by cp.async:
//   ssd_kernel_states  (head, chunk, batch): a_cum of the chunk, and the
//       chunk's own state from zero, sum_j (w_j dt_j x_j)^T B_j with
//       w_j = exp(a_last - a_cum_j), x scaled in registers between its
//       transposed ldmatrix and the product; 64-row tiles of x and B
//       double-buffered;
//   ssd_kernel_carry   (p n / 1024, head, batch): S_c = exp(a_last,c-1)
//       S_c-1 + local_c-1 over the chunks in f32, 4 elements a thread;
//       S_c goes out split into three bf16 parts, the last sum as the
//       final state;
//   ssd_kernel_out     (64-row tile x group of 2 heads, chunk, batch):
//       C S_c^T times exp(a_cum_i), then the diagonal blocks: C B^T once
//       for both heads of the block (B and C are shared by all heads),
//       G' = (C B^T) exp(a_cum_i - a_cum_j) dt_j on the fragments, G' x;
//       y = that + D x, written once.  The last row tiles, which see the
//       most columns, start first.
// Only x, B and C are bf16.  C B^T multiplies exact bf16 operands.  Every
// other product folds its f32 factors into one operand (x w dt against
// B; G' against x; S against C) and splits it into three bf16 parts, hi +
// mid + lo, three products against the exact bf16 side: the 24 bits of
// the f32 operand, so each term rounds as an f32 product would.  Two
// parts (~16 bits) miss the bar of one bf16 ulp plus twice the f32
// formula's own error against f64 wherever that error is small (the JAX
// tests' decays and chunks of 8 or 16 rows; tests/test_torch_precision.py
// emulates both).  P and N are zero-padded to the mma tiles
// (16) in shared memory; rows that are not 16-byte aligned (a column
// view of the conv output at an odd offset) are copied 8, 4 or 2 bytes at
// a time, or element by element.  The workspace (a_cum, the chunk states
// and the split entering states) comes from the caller.
//
// f32 (the parity runs against the CPU): ssd_kernel, one thread block
// per (batch, head) that loops over the chunks itself with the state in
// shared memory (f32), on the CUDA cores.  A [q, q] f32 decay matrix does
// not fit shared memory at q = 256, so the chunk is worked through in
// 64-row tiles: for each row tile, the column tiles at or below the
// diagonal build L o (C B^T) one 64 x 64 tile at a time.  256 threads,
// each owning a 4 x 4 block of the score tile and of the output tile, or
// a 4 x 8 block of the state, read from shared-memory tiles padded by one
// word (no bank conflicts).  One block per (batch, head) and ~132 KB of
// shared memory per block: one block per SM.  Explicit fmaf keeps the
// products fused under the build's --fmad=false; the plain products
// (A * dt, x * dt) stay rounded as the plain version rounds them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tiles.cuh"
#include "ssd_tiles.cuh"

namespace {

constexpr int TR = 64;          // rows of a tile (of i or of j)
constexpr int PMAX = 64;        // largest head dim
constexpr int NMAX = 128;       // largest state dim
constexpr int NT = 256;         // threads: 16 x 16, thread (ty, tx)
constexpr int LN = NMAX + 1;    // padded row of the [*, N] tiles
constexpr int LP = PMAX + 1;    // padded row of the [*, P] and G tiles

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }

using repro_torch::Strides;

size_t smem_bytes(int q) {
  return sizeof(float) *
         (static_cast<size_t>(PMAX + 2 * TR) * LN + 2 * TR * LP + 2 * q +
          TR);
}

// rows [0, TR) of an [*, n] matrix (row r at base + r * stride) into
// dst[r * LN + k] as f32; rows >= nvalid become 0
template <typename T>
__device__ void load_n(float* dst, const T* base, long long stride, int n,
                       int nvalid) {
  for (int e = threadIdx.x; e < TR * n; e += NT) {
    const int r = e / n, k = e % n;
    dst[r * LN + k] = r < nvalid ? to_f32(base[r * stride + k]) : 0.f;
  }
}

// rows [0, TR) of x (row r at base + r * stride, p columns) into
// dst[r * LP + k] as x * scale[r] in f32; rows >= nvalid become 0
template <typename T>
__device__ void load_x(float* dst, const T* base, long long stride, int p,
                       int nvalid, const float* scale) {
  for (int e = threadIdx.x; e < TR * p; e += NT) {
    const int r = e / p, k = e % p;
    dst[r * LP + k] =
        r < nvalid ? to_f32(base[r * stride + k]) * scale[r] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ D,
               T* __restrict__ y, float* __restrict__ state, int s_len,
               int heads, int p, int n, int q, Strides st) {
  extern __shared__ float smem[];
  float* S = smem;                // [PMAX][LN] the state, S[p][n]
  float* Cs = S + PMAX * LN;      // [TR][LN] C of the row tile
  float* Bs = Cs + TR * LN;       // [TR][LN] B of the column tile
  float* Xs = Bs + TR * LN;       // [TR][LP] x * dt (* decay) of a tile
  float* Gs = Xs + TR * LP;       // [TR][LP] L o (C B^T) of a tile pair
  float* dts = Gs + TR * LP;      // [q] dt of the chunk
  float* acum = dts + q;          // [q] a_cum of the chunk
  float* wts = acum + q;          // [TR] exp(a_last - a_cum_j) of a tile

  const int hh = blockIdx.x, bb = blockIdx.y, tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float a_h = A[hh], d_h = D[hh];
  const T* xb = x + bb * st.xb + hh * st.xh;
  const float* dtb = dt + bb * st.db + hh * st.dh;
  const T* bbase = Bm + bb * st.bb;
  const T* cbase = Cm + bb * st.cb;

  for (int e = tid; e < PMAX * LN; e += NT) S[e] = 0.f;

  for (int c0 = 0; c0 < s_len; c0 += q) {
    const int nv = min(q, s_len - c0);  // rows of this chunk inside S
    for (int i = tid; i < q; i += NT)
      dts[i] = i < nv ? dtb[(c0 + i) * st.ds] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < q; ++i) {
        run += a_h * dts[i];
        acum[i] = run;
      }
    }
    __syncthreads();
    const float a_last = acum[q - 1];
    const int ntiles = (nv + TR - 1) / TR;

    for (int it = 0; it < ntiles; ++it) {
      const int i0 = it * TR;
      load_n(Cs, cbase + (c0 + i0) * st.cs, st.cs, n, nv - i0);
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TR;
        load_n(Bs, bbase + (c0 + j0) * st.bs, st.bs, n, nv - j0);
        load_x(Xs, xb + (c0 + j0) * st.xs, st.xs, p, nv - j0, dts + j0);
        __syncthreads();
        // scores of rows ty*4+r against columns tx+16c, times the decay
        float sc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          float a[4], b[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = Cs[(ty * 4 + r) * LN + k];
#pragma unroll
          for (int c = 0; c < 4; ++c) b[c] = Bs[(tx + 16 * c) * LN + k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) sc[r][c] = fmaf(a[r], b[c], sc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty * 4 + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            // above the diagonal the difference is positive and its exp
            // may overflow: select, never multiply by a 0 mask
            Gs[(ty * 4 + r) * LP + tx + 16 * c] =
                (i < nv && j <= i) ? sc[r][c] * expf(acum[i] - acum[j])
                                   : 0.f;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < TR; ++j) {
          float g[4], v[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) g[r] = Gs[(ty * 4 + r) * LP + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) v[c] = Xs[j * LP + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][c] = fmaf(g[r], v[c], acc[r][c]);
        }
        __syncthreads();  // Bs, Xs and Gs are reloaded next
      }

      // the state entering the chunk (zero in the first chunk)
      if (c0 > 0) {
        float off[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) off[r][c] = 0.f;
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          float a[4], b[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = Cs[(ty * 4 + r) * LN + k];
#pragma unroll
          for (int c = 0; c < 4; ++c) b[c] = S[(tx + 16 * c) * LN + k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              off[r][c] = fmaf(a[r], b[c], off[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty * 4 + r;
          const float decay = i < nv ? expf(acum[i]) : 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += decay * off[r][c];
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        if (i >= nv) continue;
        const T* xrow = xb + (c0 + i) * st.xs;
        T* yrow = y + ((static_cast<long long>(bb) * s_len + c0 + i) * heads +
                       hh) * p;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tx + 16 * c;
          if (col < p) store(yrow + col, acc[r][c] + to_f32(xrow[col]) * d_h);
        }
      }
      __syncthreads();  // Cs is reloaded next
    }

    // S' = exp(a_last) S + sum_j exp(a_last - a_cum_j) xd[j] B_j^T, the
    // thread owning rows ty*4+r of P and columns tx+16c of N
    float upd[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) upd[r][c] = 0.f;
    for (int jt = 0; jt < ntiles; ++jt) {
      const int j0 = jt * TR;
      for (int j = tid; j < TR; j += NT)
        wts[j] = j0 + j < nv ? expf(a_last - acum[j0 + j]) : 0.f;
      load_n(Bs, bbase + (c0 + j0) * st.bs, st.bs, n, nv - j0);
      load_x(Xs, xb + (c0 + j0) * st.xs, st.xs, p, nv - j0, dts + j0);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < TR; ++j) {
        const float w = wts[j];
        float a[4], b[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = Xs[j * LP + ty * 4 + r] * w;
#pragma unroll
        for (int c = 0; c < 8; ++c) b[c] = Bs[j * LN + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) upd[r][c] = fmaf(a[r], b[c], upd[r][c]);
      }
      __syncthreads();  // Bs and Xs are reloaded next
    }
    const float chunk_decay = expf(a_last);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float* cell = S + (ty * 4 + r) * LN + tx + 16 * c;
        *cell = *cell * chunk_decay + upd[r][c];
      }
    __syncthreads();
  }

  float* out = state + static_cast<long long>(bb * heads + hh) * p * n;
  for (int e = tid; e < p * n; e += NT) out[e] = S[(e / n) * LN + e % n];
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, const float* D, void* y, float* state, int b, int s,
           int h, int p, int n, int q, const long long* st,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(q);
  static size_t allowed = 0;  // the kernel's shared-memory limit so far
  if (smem > allowed) {
    const cudaError_t attr = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    allowed = smem;
  }
  const Strides strides{st[0], st[1], st[2], st[3], st[4],
                        st[5], st[6], st[7], st[8], st[9]};
  ssd_kernel<T><<<dim3(h, b), NT, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), D, static_cast<T*>(y), state, s, h, p, n, q,
      strides);
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
constexpr int HG = 2;           // heads per output block
constexpr int STAGE = MT * LDN + HG * MT * LDP;  // B and HG x tiles
constexpr int CT = 4;           // state elements per carry thread
constexpr int NPART = 3;        // bf16 parts of a split f32 operand

// elements per copy of a row of x, B, C and of the split states: 8, 4 or
// 2 (cp.async of 16, 8 or 4 bytes), or 1 (plain loads)
struct Vec {
  int x, b, c, s;
};

// the workspace: a_cum [b, h, nc, q] and the chunk states [b, h, nc, p n]
// in f32, then the state entering each chunk [b, h, nc, NPART, p n] as
// bf16 parts, each region 32-byte aligned
struct Work {
  float* acum;
  float* local;
  bf16* enter;
};

size_t states_smem(int q) {
  return sizeof(bf16) * (2 * MT * LDP + 2 * MT * LDN) +
         sizeof(float) * (2 * q + MT);
}
size_t out_smem(int q) {
  return sizeof(bf16) * (MT * LDN + 2 * STAGE) + sizeof(float) * 2 * HG * q;
}

__global__ void __launch_bounds__(WT)
    ssd_kernel_states(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const bf16* __restrict__ Bm, Work work, int s_len,
                      int heads, int p, int n, int q, int nchunks, Strides st,
                      Vec vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xr = reinterpret_cast<bf16*>(smem_raw);  // [2][MT][LDP] x
  bf16* Br = Xr + 2 * MT * LDP;                  // [2][MT][LDN] B
  float* dts = reinterpret_cast<float*>(Br + 2 * MT * LDN);  // [q]
  float* acum = dts + q;                                     // [q]
  float* wts = acum + q;  // [MT] exp(a_last - a_cum_j) dt_j of a tile

  const int hh = blockIdx.x, ch = blockIdx.y, bb = blockIdx.z;
  const int c0 = ch * q, nv = min(q, s_len - c0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wp = (p + 15) & ~15, wn = (n + 15) & ~15;  // padded widths
  const bf16* xb = x + bb * st.xb + hh * st.xh + c0 * st.xs;
  const bf16* bbase = Bm + bb * st.bb + c0 * st.bs;
  const int ntiles = (nv + MT - 1) / MT;
  auto load = [&](int jt) {
    const int j0 = jt * MT;
    copy_tile<WT>(Xr + (jt & 1) * MT * LDP, LDP, xb + j0 * st.xs, st.xs,
                  MT, nv - j0, wp, p, vec.x);
    copy_tile<WT>(Br + (jt & 1) * MT * LDN, LDN, bbase + j0 * st.bs, st.bs,
                  MT, nv - j0, wn, n, vec.b);
  };
  load(0);
  cp_async_commit();

  const float a_h = A[hh];
  const float* dtb = dt + bb * st.db + hh * st.dh + c0 * st.ds;
  for (int i = tid; i < q; i += WT) dts[i] = i < nv ? dtb[i * st.ds] : 0.f;
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int i = 0; i < q; ++i) {
      run += a_h * dts[i];
      acum[i] = run;
    }
  }
  __syncthreads();
  const long long bhc = (static_cast<long long>(bb) * heads + hh) * nchunks +
                        ch;
  for (int i = tid; i < q; i += WT) work.acum[bhc * q + i] = acum[i];
  const float a_last = acum[q - 1];

  // the warp's 16 rows of P against all of N: (x w dt)^T B, the A operand
  // x^T read transposed from the tile and scaled in registers
  float acc[NMAX / 8][4];
#pragma unroll
  for (int j = 0; j < NMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int jt = 0; jt < ntiles; ++jt) {
    if (jt + 1 < ntiles) load(jt + 1);
    cp_async_commit();
    const int j0 = jt * MT;
    if (tid < MT)
      wts[tid] = j0 + tid < nv ? expf(a_last - acum[j0 + tid]) * dts[j0 + tid]
                               : 0.f;
    cp_async_wait<1>();
    __syncthreads();
    const bf16* xr = Xr + (jt & 1) * MT * LDP;
    const bf16* br = Br + (jt & 1) * MT * LDN;
    if (warp * 16 < p) {
#pragma unroll
      for (int kk = 0; kk < MT / 16; ++kk) {
        uint32_t a[4], ah[4], am[4], al[4];
        ldmatrix_x4_trans(a, xr + (kk * 16 + (lane / 16) * 8 + lane % 8) * LDP +
                                 warp * 16 + ((lane / 8) & 1) * 8);
        // a[0], a[1]: tile rows kk 16 + 2 t4 (+1); a[2], a[3]: 8 further
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = kk * 16 + 2 * t4 + (e / 2) * 8;
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&a[e]);
          split3_bf16(__low2float(v) * wts[j], __high2float(v) * wts[j + 1],
                      ah[e], am[e], al[e]);
        }
#pragma unroll
        for (int nb = 0; nb < NMAX / 16; ++nb) {
          if (nb * 16 >= wn) break;
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, br + (kk * 16 + ((lane / 8) & 1) * 8 + lane % 8) * LDN +
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

  float* out = work.local + bhc * p * n;
#pragma unroll
  for (int j = 0; j < NMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = warp * 16 + g + 8 * (e / 2);
      const int col = j * 8 + 2 * t4 + (e & 1);
      if (row < p && col < n) out[row * n + col] = acc[j][e];
    }
}

// S_c = exp(a_last,c-1) S_c-1 + local_c-1 from S_0 = 0, CT elements a
// thread; S_c of c >= 1 goes out split into NPART bf16 parts for the
// output pass, the last sum as the final state
__global__ void __launch_bounds__(256)
    ssd_kernel_carry(Work work, float* __restrict__ final_state, int heads,
                     int pn, int q, int nchunks) {
  const int e0 = (blockIdx.x * 256 + threadIdx.x) * CT;
  if (e0 >= pn) return;
  const long long bh =
      static_cast<long long>(blockIdx.z) * heads + blockIdx.y;
  const float* local = work.local + bh * nchunks * pn + e0;
  bf16* enter = work.enter + bh * nchunks * NPART * pn + e0;
  const float* a_last = work.acum + bh * nchunks * q + q - 1;
  float S[CT];
#pragma unroll
  for (int u = 0; u < CT; ++u) S[u] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    const long long at = c * static_cast<long long>(pn);
    float L[CT];
#pragma unroll
    for (int u = 0; u < CT; ++u) L[u] = e0 + u < pn ? local[at + u] : 0.f;
    const float decay = expf(a_last[c * static_cast<long long>(q)]);
#pragma unroll
    for (int u = 0; u < CT; ++u) {
      if (c > 0 && e0 + u < pn) {
        float rest = S[u];
#pragma unroll
        for (int part = 0; part < NPART; ++part) {
          const bf16 v = __float2bfloat16_rn(rest);
          enter[NPART * at + part * pn + u] = v;
          rest -= __bfloat162float(v);
        }
      }
      S[u] = S[u] * decay + L[u];
    }
  }
#pragma unroll
  for (int u = 0; u < CT; ++u)
    if (e0 + u < pn) final_state[bh * pn + e0 + u] = S[u];
}

__global__ void __launch_bounds__(WT)
    ssd_kernel_out(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                   const float* __restrict__ D, Work work,
                   bf16* __restrict__ y, int s_len, int heads, int p, int n,
                   int q, int nchunks, Strides st, Vec vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);  // [MT][LDN] C of the tile
  bf16* ring = Cs + MT * LDN;  // 2 stages of B [MT][LDN], x [HG][MT][LDP]
  // before the ring runs it holds a head's entering state: [NPART][PMAX][LDN]
  float* acum = reinterpret_cast<float*>(ring + 2 * STAGE);  // [HG][q]
  float* dts = acum + HG * q;                                // [HG][q]

  const int ngroups = (heads + HG - 1) / HG, nrt = (q + MT - 1) / MT;
  const int rt = nrt - 1 - static_cast<int>(blockIdx.x) / ngroups;
  const int h0 = (blockIdx.x % ngroups) * HG, nh = min(HG, heads - h0);
  const int ch = blockIdx.y, bb = blockIdx.z;
  const int c0 = ch * q, nv = min(q, s_len - c0);
  const int i0 = rt * MT;  // the tile's first row in the chunk
  if (i0 >= nv) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wi = i0 + warp * 16;  // the warp's first row
  const int wp = (p + 15) & ~15, wn = (n + 15) & ~15;

  copy_tile<WT>(Cs, LDN, Cm + bb * st.cb + (c0 + i0) * st.cs, st.cs, MT,
                nv - i0, wn, n, vec.c);
  cp_async_commit();
  for (int e = tid; e < HG * q; e += WT) {
    const int hj = e / q, i = e % q;
    const bool ok = hj < nh;
    const long long bhc =
        (static_cast<long long>(bb) * heads + h0 + hj) * nchunks + ch;
    acum[e] = ok ? work.acum[bhc * q + i] : 0.f;
    dts[e] = ok && i < nv ? dt[bb * st.db + (c0 + i) * st.ds +
                               (h0 + hj) * st.dh]
                          : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  uint32_t cf[NMAX / 16][4];  // C of the warp's 16 rows, the A operand
#pragma unroll
  for (int kk = 0; kk < NMAX / 16; ++kk)
    if (kk * 16 < wn)
      ldmatrix_x4(cf[kk], Cs + (warp * 16 + lane % 16) * LDN + kk * 16 +
                              (lane / 16) * 8);

  float acc[HG][PMAX / 8][4];
#pragma unroll
  for (int hj = 0; hj < HG; ++hj)
#pragma unroll
    for (int j = 0; j < PMAX / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[hj][j][e] = 0.f;

  // the entering state's term, exp(a_cum_i) C_i . S^T (none in chunk 0),
  // S in NPART bf16 parts, one head at a time
  if (ch > 0) {
#pragma unroll
    for (int hj = 0; hj < HG; ++hj) {
      if (hj >= nh) break;
      const long long bhc =
          (static_cast<long long>(bb) * heads + h0 + hj) * nchunks + ch;
      for (int part = 0; part < NPART; ++part)
        copy_tile<WT>(ring + part * PMAX * LDN, LDN,
                      work.enter + (NPART * bhc + part) * p * n, n, wp, p,
                      wn, n, vec.s);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < NMAX / 16; ++kk) {
        if (kk * 16 >= wn) break;
#pragma unroll
        for (int pb = 0; pb < PMAX / 16; ++pb) {
          if (pb * 16 >= wp) break;
          const int at = (pb * 16 + (lane / 16) * 8 + lane % 8) * LDN +
                         kk * 16 + ((lane / 8) & 1) * 8;
#pragma unroll
          for (int part = 0; part < NPART; ++part) {
            uint32_t b[4];
            ldmatrix_x4(b, ring + part * PMAX * LDN + at);
            mma_bf16(acc[hj][2 * pb], cf[kk], b[0], b[1]);
            mma_bf16(acc[hj][2 * pb + 1], cf[kk], b[2], b[3]);
          }
        }
      }
      float d[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = wi + g + 8 * r;
        d[r] = i < nv ? expf(acum[hj * q + i]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < PMAX / 8; ++j) {
        acc[hj][j][0] *= d[0];
        acc[hj][j][1] *= d[0];
        acc[hj][j][2] *= d[1];
        acc[hj][j][3] *= d[1];
      }
      __syncthreads();  // the next head's state, or the ring, comes next
    }
  }

  const bf16* xg = x + bb * st.xb + c0 * st.xs + h0 * st.xh;
  const bf16* bg = Bm + bb * st.bb + c0 * st.bs;
  auto load = [&](int jt) {
    bf16* stage = ring + (jt & 1) * STAGE;
    const int j0 = jt * MT;
    copy_tile<WT>(stage, LDN, bg + j0 * st.bs, st.bs, MT, nv - j0, wn, n,
                  vec.b);
    for (int hj = 0; hj < nh; ++hj)
      copy_tile<WT>(stage + MT * LDN + hj * MT * LDP, LDP,
                    xg + hj * st.xh + j0 * st.xs, st.xs, MT, nv - j0, wp, p,
                    vec.x);
  };
  load(0);
  cp_async_commit();
  for (int jt = 0; jt <= rt; ++jt) {
    if (jt < rt) load(jt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Bt = ring + (jt & 1) * STAGE;
    const bf16* Xt = Bt + MT * LDN;
    const int j0 = jt * MT;
    // 16-column steps the warp needs: all of a tile below the diagonal,
    // up to its own rows on it
    const int nk = wi >= nv ? 0 : jt < rt ? MT / 16 : warp + 1;

    // C B^T of the warp's rows and the tile's columns, once for the heads
    float cb[MT / 8][4];
#pragma unroll
    for (int j = 0; j < MT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cb[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NMAX / 16; ++kk) {
      if (kk * 16 >= wn) break;
#pragma unroll
      for (int jb = 0; jb < MT / 16; ++jb) {
        if (jb >= nk) break;
        uint32_t b[4];
        ldmatrix_x4(b, Bt + (jb * 16 + (lane / 16) * 8 + lane % 8) * LDN +
                           kk * 16 + ((lane / 8) & 1) * 8);
        mma_bf16(cb[2 * jb], cf[kk], b[0], b[1]);
        mma_bf16(cb[2 * jb + 1], cf[kk], b[2], b[3]);
      }
    }

    // per head: G' = (C B^T) exp(a_cum_i - a_cum_j) dt_j on and below the
    // diagonal, 0 above (select, never inf x 0); y += G' x
#pragma unroll
    for (int hj = 0; hj < HG; ++hj) {
      if (hj >= nh) break;
      const float* ac = acum + hj * q;
      const float* dd = dts + hj * q;
#pragma unroll
      for (int jb = 0; jb < MT / 16; ++jb) {
        if (jb >= nk) break;
        float gv[2][4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = wi + g + 8 * (e / 2);
            const int j = j0 + jb * 16 + h2 * 8 + 2 * t4 + (e & 1);
            gv[h2][e] = j <= i && i < nv
                            ? cb[2 * jb + h2][e] * expf(ac[i] - ac[j]) * dd[j]
                            : 0.f;
          }
        uint32_t gp[NPART][4];  // G' as NPART bf16 A fragments
        split3_bf16(gv[0][0], gv[0][1], gp[0][0], gp[1][0], gp[2][0]);
        split3_bf16(gv[0][2], gv[0][3], gp[0][1], gp[1][1], gp[2][1]);
        split3_bf16(gv[1][0], gv[1][1], gp[0][2], gp[1][2], gp[2][2]);
        split3_bf16(gv[1][2], gv[1][3], gp[0][3], gp[1][3], gp[2][3]);
#pragma unroll
        for (int pb = 0; pb < PMAX / 16; ++pb) {
          if (pb * 16 >= wp) break;
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, Xt + hj * MT * LDP +
                     (jb * 16 + ((lane / 8) & 1) * 8 + lane % 8) * LDP +
                     pb * 16 + (lane / 16) * 8);
#pragma unroll
          for (int part = 0; part < NPART; ++part) {
            mma_bf16(acc[hj][2 * pb], gp[part], b[0], b[1]);
            mma_bf16(acc[hj][2 * pb + 1], gp[part], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is reloaded two tiles on
  }

  // y = the sums + D x, x from the last (diagonal) tile, staged in the
  // other stage as [MT][LDY] rows of the group's heads side by side, then
  // written once, row by row: the group's heads are contiguous in y
  constexpr int LDY = HG * PMAX + 8;
  bf16* Ys = ring + ((rt + 1) & 1) * STAGE;
  const bf16* Xd = ring + (rt & 1) * STAGE + MT * LDN;
#pragma unroll
  for (int hj = 0; hj < HG; ++hj) {
    if (hj >= nh) break;
    const float d_h = D[h0 + hj];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int il = warp * 16 + g + 8 * r;  // the row in the tile
#pragma unroll
      for (int j = 0; j < PMAX / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * 8 + 2 * t4 + e;
          if (col < p)
            Ys[il * LDY + hj * p + col] = __float2bfloat16_rn(
                acc[hj][j][2 * r + e] +
                to_f32(Xd[hj * MT * LDP + il * LDP + col]) * d_h);
        }
    }
  }
  __syncthreads();
  const int rows = min(MT, nv - i0), width = nh * p;
  bf16* y0 = y + ((static_cast<long long>(bb) * s_len + c0 + i0) * heads +
                  h0) * p;
  const long long ystride = static_cast<long long>(heads) * p;
  if (width % 8 == 0 && ystride % 8 == 0 && h0 * p % 8 == 0) {
    for (int e = tid; e < rows * (width / 8); e += WT) {
      const int r = e / (width / 8), c = e % (width / 8) * 8;
      *reinterpret_cast<uint4*>(y0 + r * ystride + c) =
          *reinterpret_cast<const uint4*>(Ys + r * LDY + c);
    }
  } else {
    for (int e = tid; e < rows * width; e += WT) {
      const int r = e / width, c = e % width;
      y0[r * ystride + c] = Ys[r * LDY + c];
    }
  }
}

int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, const float* D, void* y, float* state, float* ws,
           int b, int s, int h, int p, int n, int q, const long long* st,
           cudaStream_t stream) {
  static size_t allowed_states = 0, allowed_out = 0;  // smem limits so far
  const size_t smem_a = states_smem(q), smem_c = out_smem(q);
  if (smem_a > allowed_states) {
    const cudaError_t attr = cudaFuncSetAttribute(
        ssd_kernel_states, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_a));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    allowed_states = smem_a;
  }
  if (smem_c > allowed_out) {
    const cudaError_t attr = cudaFuncSetAttribute(
        ssd_kernel_out, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_c));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    allowed_out = smem_c;
  }
  const int nc = (s + q - 1) / q;
  const long long bhc = static_cast<long long>(b) * h * nc;
  Work work;
  work.acum = align32(ws);
  work.local = align32(work.acum + bhc * q);
  work.enter = reinterpret_cast<bf16*>(align32(work.local + bhc * p * n));
  const Strides strides{st[0], st[1], st[2], st[3], st[4],
                        st[5], st[6], st[7], st[8], st[9]};
  const long long row = n;
  const Vec vec{vec_of(x, st, 3, p), vec_of(B, st + 6, 2, n),
                vec_of(C, st + 8, 2, n), vec_of(work.enter, &row, 1, n)};
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* Bb = static_cast<const bf16*>(B);
  ssd_kernel_states<<<dim3(h, nc, b), WT, smem_a, stream>>>(
      xb, dt, A, Bb, work, s, h, p, n, q, nc, strides, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = 256 * CT;
  ssd_kernel_carry<<<dim3((p * n + per_block - 1) / per_block, h, b), 256,
                     0, stream>>>(work, state, h, p * n, q, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = ((q + MT - 1) / MT) * ((h + HG - 1) / HG);
  ssd_kernel_out<<<dim3(blocks, nc, b), WT, smem_c, stream>>>(
      xb, dt, Bb, static_cast<const bf16*>(C), D, work,
      static_cast<bf16*>(y), s, h, p, n, q, nc, strides, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// x [b, s, h, p], B and C [b, s, n] in f32 (bf16 == 0) or bf16 (bf16 == 1)
// with the element strides of x's (batch, seq, head) dims, dt's (batch,
// seq, head) dims, B's and C's (batch, seq) dims in st[10] (last dims
// contiguous); dt [b, s, h], A [h] and D [h] in f32.  Writes y [b, s, h, p]
// (contiguous, x's type) and the final state [b, h, p, n] (contiguous,
// f32).  p <= 64, n <= 128, 1 <= q.  bf16 needs the f32 workspace `work`
// of b h ceil(s / q) (q + 3 p n) + 24 floats (f32 ignores it).  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int ssd_scan(const void* x, const float* dt, const float* A,
                        const void* B, const void* C, const float* D, void* y,
                        float* state, float* work, int b, int s, int h, int p,
                        int n, int q, const long long* st, int bf16,
                        void* stream) {
  if (p < 1 || p > PMAX || n < 1 || n > NMAX || q < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (bf16)
    return tc::launch(x, dt, A, B, C, D, y, state, work, b, s, h, p, n, q, st,
                      cs);
  return launch<float>(x, dt, A, B, C, D, y, state, b, s, h, p, n, q, st,
                       cs);
}
