// Causal GQA flash attention (prefill) with an optional sliding window and
// tanh softcap.
//
// Replaces the TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention
// (_flash_kernel), whose grid walked the K blocks of one (batch, head,
// Q block) in order and carried the online-softmax state (max, denom, acc)
// in VMEM scratch.  Here one thread block owns one (batch, head, 64-row Q
// tile) and loops over the 64-column K/V tiles itself, carrying the state
// in registers; tiles that the causal or window mask excludes entirely are
// never loaded.  Head h reads KV head h / (H / KV).  The kernel masks a
// ragged S and T itself (the Pallas kernel asserted S % 128 == 0): rows
// past S are not written, columns past T are masked and their K/V rows
// zero-filled.
//
// Bound on the H100: operations.  Per (row, visible column) the function
// does 4 * D flops against 2 * D * sizeof(T) / 64 bytes of K/V per row of
// a 64-row tile, far above the card's 295 flops per byte in bf16.  This
// first kernel computes in f32 on the CUDA cores (no mma.sync or wgmma):
// 256 threads, each owning a 4-row x 4-column block of the score tile and
// a 4-row x D/16 block of the output, read from shared-memory tiles padded
// by one word so that neither product has bank conflicts.  Explicit fmaf
// keeps the products fused under the build's --fmad=false.
#include "attention_tiles.cuh"

namespace {

using repro_torch::NEG_INF;

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // key columns per tile
constexpr int NT = 256;  // threads: 16 x 16, thread (ty, tx)

struct Strides {
  long long b, h, s;  // elements; the last dim is contiguous
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int group,
                 int s_len, int t_len, Strides sq, Strides sk, Strides sv,
                 Strides so, float scale, int window, float cap) {
  constexpr int LQ = D + 1;   // padded row of the Q and K tiles
  constexpr int LP = BK + 1;  // padded row of the probability tile
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][LQ]
  float* Ks = Qs + BQ * LQ;    // [BK][LQ]
  float* Vs = Ks + BK * LQ;    // [BK][D]
  float* Ps = Vs + BK * D;     // [BQ][LP]

  const int row0 = blockIdx.x * BQ, hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / group;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* kb = k + bb * sk.b + kvh * sk.h;
  const T* vb = v + bb * sv.b + kvh * sv.h;

  repro_torch::load_rows<T, D>(Qs, LQ, q + bb * sq.b + hh * sq.h + row0 * sq.s,
                               sq.s, BQ, min(BQ, s_len - row0));

  float acc[4][DJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // the columns any row of this tile can see: causal stops at the tile's
  // last row, the window starts after row0 - window
  const int col_end = min(t_len, row0 + BQ);
  const int col_begin = window > 0 ? max(0, row0 - window + 1) : 0;
  for (int col0 = (col_begin / BK) * BK; col0 < col_end; col0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    const int nvalid = min(BK, t_len - col0);
    repro_torch::load_rows<T, D>(Ks, LQ, kb + col0 * sk.s, sk.s, BK, nvalid);
    repro_torch::load_rows<T, D>(Vs, D, vb + col0 * sv.s, sv.s, BK, nvalid);
    __syncthreads();

    // scores of rows ty*4+i against columns tx+16*j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * LQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * LQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
    }

    // mask, then the online softmax update of each row; a row's 64
    // columns live in the 16 lanes of one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + tx + 16 * j;
        bool ok = col < t_len && col <= row;
        if (window > 0) ok = ok && col > row - window;
        const float x = repro_torch::apply_softcap(sc[i][j] * scale, cap);
        sc[i][j] = ok ? x : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty * 4 + i) * LP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V for rows ty*4+i and output columns tx+16*j
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], w[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * LP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) w[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= s_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + bb * so.b + hh * so.h + row * so.s;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      out[tx + 16 * j] = repro_torch::from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int kv, int s, int t, const long long* st, float scale,
           int window, float cap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((s + BQ - 1) / BQ, h, b);
  flash_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), h / kv, s, t,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, scale,
      window, cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* o,
             int b, int h, int kv, int s, int t, const long long* st,
             float scale, int window, float cap, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, h, kv, s, t, st, scale, window,
                           cap, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, h, kv, s, t, st, scale, window,
                           cap, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, h, kv, s, t, st, scale, window,
                            cap, stream);
    case 256:  // 213,760 B of shared memory: one block per SM
      return launch<T, 256>(q, k, v, o, b, h, kv, s, t, st, scale, window,
                            cap, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [b, h, s, d], k and v [b, kv, t, d], o [b, h, s, d] on the device, in
// f32 (bf16 == 0) or bf16 (bf16 == 1), with the element strides of the
// batch, head and sequence dims in st[12] (q, k, v, o; the last dim is
// contiguous, rows 16-byte aligned).  window <= 0: none; cap <= 0: none.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int b, int h, int kv, int s, int t,
                               int d, const long long* st, float scale,
                               int window, float cap, int bf16,
                               void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(d, q, k, v, o, b, h, kv, s, t, st, scale,
                                   window, cap, cs);
  return dispatch<float>(d, q, k, v, o, b, h, kv, s, t, st, scale, window,
                         cap, cs);
}
