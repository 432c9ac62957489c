// Mamba-2 SSD (state-space duality) chunked scan, prefill, from a zero
// state, with the final state written out.
//
// Replaces the TPU kernel repro/kernels/ssd_scan/ssd_scan.py::ssd_pallas
// (_ssd_kernel), whose grid walked the chunks of one (batch, head) in
// order and carried the [P, N] state in VMEM scratch; it returned the
// final state by recomputing the whole scan on the XLA path.  Here one
// thread block owns one (batch, head), loops over the chunks itself with
// the state in shared memory (f32), and writes the final state.
//
// Per chunk of q rows (the caller's chunk, 256 for mamba2-370m), with
// xd = x * dt and a_cum the cumulative sum of A * dt over the whole chunk:
//   y[i]  = sum_{j <= i} exp(a_cum_i - a_cum_j) (C_i . B_j) xd[j]
//         + exp(a_cum_i) C_i . S^T + D x[i]
//   S'    = exp(a_cum_last) S + sum_j exp(a_cum_last - a_cum_j) xd[j] B_j^T
// A [q, q] f32 decay matrix does not fit shared memory at q = 256, so the
// chunk is worked through in 64-row tiles: for each row tile, the column
// tiles at or below the diagonal build L o (C B^T) one 64 x 64 tile at a
// time.  a_cum of the whole chunk stays in shared memory, and every decay
// is the difference of two of those chunk-wide sums, as in the JAX
// formula: the sums are not restarted per tile.  They are taken in order
// by one thread, in f32, so that a_cum_i - a_cum_j carries the rounding of
// the steps j+1..i only.  Rows past S (a ragged last chunk) read as
// dt = 0, x = B = C = 0: decay 1 and no input, as the plain version pads.
//
// Bound on the H100: bytes (x, y, B, C, dt and the final state: 43.7 MB at
// mamba2-370m's batch of 8 x 500 tokens, 13 us) over operations (~5 GFLOP,
// 5 us at the bf16 tensor-core peak).  This first kernel computes in f32
// on the CUDA cores: 256 threads, each owning a 4 x 4 block of the score
// tile and of the output tile, or a 4 x 8 block of the state, read from
// shared-memory tiles padded by one word (no bank conflicts).  One block
// per (batch, head) and ~132 KB of shared memory per block: one block per
// SM.  Explicit fmaf keeps the products fused under the build's
// --fmad=false; the plain products (A * dt, x * dt) stay rounded as the
// plain version rounds them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

struct Strides {
  long long xb, xs, xh;  // x [b, s, h, p], the last dim contiguous
  long long db, ds, dh;  // dt [b, s, h]
  long long bb, bs;      // B [b, s, n], the last dim contiguous
  long long cb, cs;      // C [b, s, n], the last dim contiguous
};

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

}  // namespace

// x [b, s, h, p], B and C [b, s, n] in f32 (bf16 == 0) or bf16 (bf16 == 1)
// with the element strides of x's (batch, seq, head) dims, dt's (batch,
// seq, head) dims, B's and C's (batch, seq) dims in st[10] (last dims
// contiguous); dt [b, s, h], A [h] and D [h] in f32.  Writes y [b, s, h, p]
// (contiguous, x's type) and the final state [b, h, p, n] (contiguous,
// f32).  p <= 64, n <= 128, 1 <= q.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int ssd_scan(const void* x, const float* dt, const float* A,
                        const void* B, const void* C, const float* D, void* y,
                        float* state, int b, int s, int h, int p, int n,
                        int q, const long long* st, int bf16, void* stream) {
  if (p < 1 || p > PMAX || n < 1 || n > NMAX || q < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, A, B, C, D, y, state, b, s, h, p, n,
                                 q, st, cs);
  return launch<float>(x, dt, A, B, C, D, y, state, b, s, h, p, n, q, st,
                       cs);
}
