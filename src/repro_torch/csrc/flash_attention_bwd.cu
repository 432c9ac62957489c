// Backward of the GQA flash attention (csrc/flash_attention.cu): dQ, dK
// and dV of O = softmax(mask(softcap(scale Q K^T))) V, causal or not, with
// an optional sliding window and tanh softcap, for every layout and
// option the forward takes.
//
// Replaces no TPU kernel of its own: the TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention has no
// gradient, and the JAX package trains through XLA einsums.  It is the
// gradient of the port's flash kernel, so that training runs through the
// same kernel as serving.
//
// Two launches, both on the CUDA cores with every intermediate in f32
// (the inputs read as f32, f32 or bf16; the gradients written in the
// inputs' dtype):
//
//   flash_bwd_dq_kernel, one block per (batch, head, 64-row Q tile): a
//   first pass over the K/V tiles the forward visits recomputes each row's
//   max m, its sum l of exp(s - m) and Delta = sum_j P_ij dP_ij (dP = dO
//   V^T), online as the forward carries its state; a second pass forms
//   P = exp(s - m) / l and dS = P (dP - Delta) and sums dQ = scale dS K.
//   It writes m, l and Delta of every row to a scratch for the second
//   launch.  Delta is taken from P and dP, not from the forward's output:
//   the gradient then does not carry the rounding of a bf16 O, and the
//   forward kernel needs no extra output.
//
//   flash_bwd_dkv_kernel, one block per (batch, KV head, key tile): loops
//   over the G query heads of its KV head and over the Q tiles that see
//   the key tile, and sums dV = P^T dO and dK = scale dS^T Q in registers.
//   The G heads' sums land in one block, so the result needs no atomics
//   and is the same on every run.
//
// With a softcap, s = cap tanh(x / cap) of x = scale q.k, and dS is
// multiplied by ds/dx = 1 - tanh^2(x / cap).  The mask is the forward's:
// causal by index (also when S != T), the window keeping j > i - window,
// columns past T masked; a row that sees no column (no path makes one)
// gets no gradient, where the plain version spreads it over every column.
//
// Bound on the H100: operations, 2.5 times the forward's (5 products of
// the forward's size, of which this design runs 9: the dQ kernel's first
// pass recomputes S and dP, its second S, dP and dS K; the dK/dV kernel S,
// dP, P^T dO and dS^T Q).  This first design runs them on the CUDA cores
// from f32 shared-memory tiles padded by one word (no bank conflicts in
// either product), in the layout of the forward's f32 kernel: 256 threads,
// each a 4-row block of the score tile; explicit fmaf keeps the products
// fused under the build's --fmad=false.  Each tile's share of a gradient
// is summed apart and then added to the running sum, so the rounding of a
// sum over thousands of rows grows with its tiles.  D = 256 takes
// 32-column key tiles and up to 214,272 B of dynamic shared memory.
#include "attention_tiles.cuh"

namespace {

using repro_torch::NEG_INF;

constexpr int BQ = 64;   // query rows per tile
constexpr int NT = 256;  // threads: 16 x 16, thread (ty, tx)

template <int D>
struct Bwd {
  static constexpr int BK = D == 256 ? 32 : 64;  // key columns per tile
  static constexpr int CJ = BK / 16;  // score columns per thread
  static constexpr int CI = BK / 16;  // key rows per thread in dK, dV
  static constexpr int DJ = D / 16;   // head-dim columns per thread
  static constexpr int LD = D + 1;    // padded row of a [., D] tile
  static constexpr int LP = BK + 1;   // padded row of a [BQ, BK] tile
  // dQ: Q, dO [BQ][LD], K, V [BK][LD], dS [BQ][LP]
  static constexpr size_t dq_smem =
      sizeof(float) * (2 * BQ * LD + 2 * BK * LD + BQ * LP);
  // dK, dV: the same and P [BQ][LP]
  static constexpr size_t dkv_smem = dq_smem + sizeof(float) * BQ * LP;
};

struct Strides {
  long long b, h, s;  // elements; the last dim is contiguous
};

template <bool CAUSAL>
__device__ __forceinline__ bool visible(int row, int col, int t_len,
                                        int window) {
  bool ok = col < t_len && (!CAUSAL || col <= row);
  if (window > 0) ok = ok && col > row - window;
  return ok;
}

// The score of a raw product x = q.k, as the forward forms it (scale,
// then the softcap); *dcap takes the softcap's derivative there.
__device__ __forceinline__ float score(float x, float scale, float cap,
                                       float* dcap) {
  const float z = x * scale;
  if (cap > 0.f) {
    const float t = tanhf(z / cap);
    *dcap = 1.f - t * t;
    return t * cap;
  }
  *dcap = 1.f;
  return z;
}

// out[i][j] = sum_d A[ty*4+i][d] B[tx+16j][d] over f32 tiles of row
// length LD, summed over d in order.
template <int D, int CJ>
__device__ __forceinline__ void products(const float* A, const float* B,
                                         float (&out)[4][CJ], int ty,
                                         int tx) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) out[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[CJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * LD + d];
#pragma unroll
    for (int j = 0; j < CJ; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) out[i][j] = fmaf(a[i], b[j], out[i][j]);
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        T* __restrict__ dq, float* __restrict__ stats,
                        int heads, int group, int s_len, int t_len,
                        Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdq, float scale, int window, float cap) {
  using P = Bwd<D>;
  constexpr int BK = P::BK, CJ = P::CJ, DJ = P::DJ, LD = P::LD, LP = P::LP;
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][LD]
  float* dOs = Qs + BQ * LD;   // [BQ][LD]
  float* Ks = dOs + BQ * LD;   // [BK][LD]
  float* Vs = Ks + BK * LD;    // [BK][LD]
  float* dSs = Vs + BK * LD;   // [BQ][LP]

  const int row0 = blockIdx.x * BQ, hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / group;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nrows = min(BQ, s_len - row0);
  const T* kb = k + bb * sk.b + kvh * sk.h;
  const T* vb = v + bb * sv.b + kvh * sv.h;
  repro_torch::load_rows<T, D>(Qs, LD, q + bb * sq.b + hh * sq.h +
                               row0 * sq.s, sq.s, BQ, nrows);
  repro_torch::load_rows<T, D>(dOs, LD, dout + bb * sdo.b + hh * sdo.h +
                               row0 * sdo.s, sdo.s, BQ, nrows);

  // the forward's key tiles: causal stops at the tile's last row, the
  // window starts after row0 - window
  const int col_end = CAUSAL ? min(t_len, row0 + BQ) : t_len;
  const int col_begin = window > 0 ? max(0, row0 - window + 1) : 0;
  const int first = (col_begin / BK) * BK;

  // pass 1: m, l and l * Delta of each row, online over the key tiles
  float m[4], l[4], pd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    pd[i] = 0.f;
  }
  for (int col0 = first; col0 < col_end; col0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    const int nvalid = min(BK, t_len - col0);
    repro_torch::load_rows<T, D>(Ks, LD, kb + col0 * sk.s, sk.s, BK, nvalid);
    repro_torch::load_rows<T, D>(Vs, LD, vb + col0 * sv.s, sv.s, BK, nvalid);
    __syncthreads();
    float sc[4][CJ], dp[4][CJ];
    products<D, CJ>(Qs, Ks, sc, ty, tx);
    products<D, CJ>(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        float dc;
        const float x = score(sc[i][j], scale, cap, &dc);
        sc[i][j] = visible<CAUSAL>(row, col0 + tx + 16 * j, t_len, window)
                       ? x : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      // a row's columns live in the 16 lanes of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f, sdp = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sum += p;
        sdp = fmaf(p, dp[i][j], sdp);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
        sdp += __shfl_xor_sync(0xffffffffu, sdp, off);
      }
      l[i] = l[i] * alpha + sum;
      pd[i] = pd[i] * alpha + sdp;
      m[i] = m_new;
    }
  }

  const size_t n_rows = static_cast<size_t>(gridDim.z) * heads * s_len;
  float delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    delta[i] = pd[i] / l[i];
    const int row = row0 + ty * 4 + i;
    if (tx == 0 && row < s_len) {
      const size_t at = (static_cast<size_t>(bb) * heads + hh) * s_len + row;
      stats[at] = m[i];
      stats[n_rows + at] = l[i];
      stats[2 * n_rows + at] = delta[i];
    }
  }

  // pass 2: dS = P (dP - Delta) ds/dx, and dQ += dS K over the same tiles
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  for (int col0 = first; col0 < col_end; col0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    const int nvalid = min(BK, t_len - col0);
    repro_torch::load_rows<T, D>(Ks, LD, kb + col0 * sk.s, sk.s, BK, nvalid);
    repro_torch::load_rows<T, D>(Vs, LD, vb + col0 * sv.s, sv.s, BK, nvalid);
    __syncthreads();
    float sc[4][CJ], dp[4][CJ];
    products<D, CJ>(Qs, Ks, sc, ty, tx);
    products<D, CJ>(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = col0 + tx + 16 * j;
        float dc;
        const float x = score(sc[i][j], scale, cap, &dc);
        const float p = visible<CAUSAL>(row, col, t_len, window)
                            ? expf(x - m[i]) / l[i] : 0.f;
        dSs[(ty * 4 + i) * LP + tx + 16 * j] = p * (dp[i][j] - delta[i]) * dc;
      }
    }
    __syncthreads();
    // the tile's share of dS K, summed apart and then added: the error of
    // a long sum grows with its tiles, not its columns
    float part[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) part[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float a[4], w[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dSs[(ty * 4 + i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) w[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j)
          part[i][j] = fmaf(a[i], w[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] += part[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= s_len) continue;
    T* out = dq + bb * sdq.b + hh * sdq.h + row * sdq.s;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      out[tx + 16 * j] = repro_torch::from_f32<T>(acc[i][j] * scale);
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         T* __restrict__ dk, T* __restrict__ dv,
                         const float* __restrict__ stats, int heads,
                         int group, int s_len, int t_len, Strides sq,
                         Strides sk, Strides sv, Strides sdo, Strides sdk,
                         Strides sdv, float scale, int window, float cap) {
  using P = Bwd<D>;
  constexpr int BK = P::BK, CJ = P::CJ, CI = P::CI, DJ = P::DJ,
                LD = P::LD, LP = P::LP;
  extern __shared__ float smem[];
  float* Ks = smem;            // [BK][LD]
  float* Vs = Ks + BK * LD;    // [BK][LD]
  float* Qs = Vs + BK * LD;    // [BQ][LD]
  float* dOs = Qs + BQ * LD;   // [BQ][LD]
  float* Ps = dOs + BQ * LD;   // [BQ][LP]
  float* dSs = Ps + BQ * LP;   // [BQ][LP]

  const int col0 = blockIdx.x * BK, kvh = blockIdx.y, bb = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nvalid = min(BK, t_len - col0);
  repro_torch::load_rows<T, D>(Ks, LD, k + bb * sk.b + kvh * sk.h +
                               col0 * sk.s, sk.s, BK, nvalid);
  repro_torch::load_rows<T, D>(Vs, LD, v + bb * sv.b + kvh * sv.h +
                               col0 * sv.s, sv.s, BK, nvalid);

  // the query rows that see a column of this tile: causal from row col0,
  // a window up to row col0 + nvalid - 2 + window
  const int row_begin = CAUSAL ? col0 : 0;
  const int row_end =
      window > 0 ? min(s_len, col0 + nvalid - 1 + window) : s_len;
  const size_t n_rows = static_cast<size_t>(gridDim.z) * heads * s_len;

  float dka[CI][DJ], dva[CI][DJ];
#pragma unroll
  for (int i = 0; i < CI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dka[i][j] = 0.f;
      dva[i][j] = 0.f;
    }
  for (int g = 0; g < group; ++g) {
    const int hh = kvh * group + g;
    const size_t base = (static_cast<size_t>(bb) * heads + hh) * s_len;
    for (int row0 = (row_begin / BQ) * BQ; row0 < row_end; row0 += BQ) {
      const int nrows = min(BQ, s_len - row0);
      __syncthreads();  // the previous tile's readers are done
      repro_torch::load_rows<T, D>(Qs, LD, q + bb * sq.b + hh * sq.h +
                                   row0 * sq.s, sq.s, BQ, nrows);
      repro_torch::load_rows<T, D>(dOs, LD, dout + bb * sdo.b + hh * sdo.h +
                                   row0 * sdo.s, sdo.s, BQ, nrows);
      __syncthreads();
      float sc[4][CJ], dp[4][CJ];
      products<D, CJ>(Qs, Ks, sc, ty, tx);
      products<D, CJ>(dOs, Vs, dp, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + ty * 4 + i;
        const bool live = row < s_len;
        const float mi = live ? stats[base + row] : 0.f;
        const float li = live ? stats[n_rows + base + row] : 1.f;
        const float di = live ? stats[2 * n_rows + base + row] : 0.f;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int col = col0 + tx + 16 * j;
          float dc;
          const float x = score(sc[i][j], scale, cap, &dc);
          const float p =
              live && visible<CAUSAL>(row, col, t_len, window)
                  ? expf(x - mi) / li : 0.f;
          Ps[(ty * 4 + i) * LP + tx + 16 * j] = p;
          dSs[(ty * 4 + i) * LP + tx + 16 * j] = p * (dp[i][j] - di) * dc;
        }
      }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q for key rows ty*CI+i and head-dim
      // columns tx+16j, the tile's share summed apart and then added
      float tk[CI][DJ], tv[CI][DJ];
#pragma unroll
      for (int i = 0; i < CI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          tk[i][j] = 0.f;
          tv[i][j] = 0.f;
        }
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pa[CI], sa[CI], o[DJ], x[DJ];
#pragma unroll
        for (int i = 0; i < CI; ++i) {
          pa[i] = Ps[r * LP + ty * CI + i];
          sa[i] = dSs[r * LP + ty * CI + i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          o[j] = dOs[r * LD + tx + 16 * j];
          x[j] = Qs[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < CI; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            tv[i][j] = fmaf(pa[i], o[j], tv[i][j]);
            tk[i][j] = fmaf(sa[i], x[j], tk[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < CI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dka[i][j] += tk[i][j];
          dva[i][j] += tv[i][j];
        }
    }
  }

#pragma unroll
  for (int i = 0; i < CI; ++i) {
    const int col = col0 + ty * CI + i;
    if (col >= t_len) continue;
    T* ko = dk + bb * sdk.b + kvh * sdk.h + col * sdk.s;
    T* vo = dv + bb * sdv.b + kvh * sdv.h + col * sdv.s;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      ko[tx + 16 * j] = repro_torch::from_f32<T>(dka[i][j] * scale);
      vo[tx + 16 * j] = repro_torch::from_f32<T>(dva[i][j]);
    }
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, float* stats, int b, int h, int kv,
           int s, int t, const long long* st, float scale, bool causal,
           int window, float cap, cudaStream_t stream) {
  using P = Bwd<D>;
  static const cudaError_t attr[4] = {
      allow_smem(flash_bwd_dq_kernel<T, D, false>, P::dq_smem),
      allow_smem(flash_bwd_dq_kernel<T, D, true>, P::dq_smem),
      allow_smem(flash_bwd_dkv_kernel<T, D, false>, P::dkv_smem),
      allow_smem(flash_bwd_dkv_kernel<T, D, true>, P::dkv_smem)};
  for (const cudaError_t e : attr)
    if (e != cudaSuccess) return static_cast<int>(e);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, sdo{st[9], st[10], st[11]},
      sdq{st[12], st[13], st[14]}, sdk{st[15], st[16], st[17]},
      sdv{st[18], st[19], st[20]};
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const auto dq_kernel = causal ? flash_bwd_dq_kernel<T, D, true>
                                : flash_bwd_dq_kernel<T, D, false>;
  dq_kernel<<<dim3((s + BQ - 1) / BQ, h, b), NT, P::dq_smem, stream>>>(
      qt, kt, vt, dot, static_cast<T*>(dq), stats, h, h / kv, s, t, sq, sk,
      sv, sdo, sdq, scale, window, cap);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto dkv_kernel = causal ? flash_bwd_dkv_kernel<T, D, true>
                                 : flash_bwd_dkv_kernel<T, D, false>;
  dkv_kernel<<<dim3((t + P::BK - 1) / P::BK, kv, b), NT, P::dkv_smem,
               stream>>>(qt, kt, vt, dot, static_cast<T*>(dk),
                         static_cast<T*>(dv), stats, h, h / kv, s, t, sq, sk,
                         sv, sdo, sdk, sdv, scale, window, cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v,
             const void* dout, void* dq, void* dk, void* dv, float* stats,
             int b, int h, int kv, int s, int t, const long long* st,
             float scale, bool causal, int window, float cap,
             cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, dout, dq, dk, dv, stats, b, h, kv, s, t,
                           st, scale, causal, window, cap, stream);
    case 64:
      return launch<T, 64>(q, k, v, dout, dq, dk, dv, stats, b, h, kv, s, t,
                           st, scale, causal, window, cap, stream);
    case 128:
      return launch<T, 128>(q, k, v, dout, dq, dk, dv, stats, b, h, kv, s,
                            t, st, scale, causal, window, cap, stream);
    case 256:
      return launch<T, 256>(q, k, v, dout, dq, dk, dv, stats, b, h, kv, s,
                            t, st, scale, causal, window, cap, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, dout, dq [b, h, s, d] and k, v, dk, dv [b, kv, t, d] on the device,
// in f32 (bf16 == 0) or bf16 (bf16 == 1), with the element strides of the
// batch, head and sequence dims in st[21] (q, k, v, dout, dq, dk, dv; the
// last dim is contiguous, rows 16-byte aligned); stats an f32 scratch of
// 3 * b * h * s.  causal, window and cap as the forward takes them.
// Launches both kernels on `stream` and returns cudaGetLastError() (0 =
// launched).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout, void* dq,
                                   void* dk, void* dv, void* stats, int b,
                                   int h, int kv, int s, int t, int d,
                                   const long long* st, float scale,
                                   int causal, int window, float cap,
                                   int bf16, void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  float* sf = static_cast<float*>(stats);
  if (bf16)
    return dispatch<__nv_bfloat16>(d, q, k, v, dout, dq, dk, dv, sf, b, h,
                                   kv, s, t, st, scale, causal != 0, window,
                                   cap, cs);
  return dispatch<float>(d, q, k, v, dout, dq, dk, dv, sf, b, h, kv, s, t,
                         st, scale, causal != 0, window, cap, cs);
}
