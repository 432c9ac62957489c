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
// Two launches, so that no gradient needs atomics and two calls give equal
// bits (every sum in a fixed order):
//
//   the dQ kernel, for each (batch, head, 64-row Q tile): a first
//   pass over the K/V tiles the forward visits recomputes each row's max
//   m, its sum l of exp(s - m) and Delta = sum_j P_ij dP_ij (dP = dO V^T),
//   online as the forward carries its state; a second pass forms P =
//   exp(s - m) / l and dS = P (dP - Delta) and sums dQ = scale dS K.  It
//   writes each row's m, l (1 / l in bf16) and Delta to a scratch for the
//   second launch.  Delta is taken from P and dP in f32, not from the forward's
//   output: the gradient then does not carry the rounding of a bf16 O
//   (which would shift every dS of a row by ~2^-9 |Delta|), and the
//   forward kernel needs no extra output.
//
//   the dK/dV kernel, for each (batch, KV head, key tile):
//   loops over the G query heads of its KV head and over the Q tiles that
//   see the key tile, and sums dV = P^T dO and dK = scale dS^T Q in
//   registers.  The G heads' sums land in one block.
//
// With a softcap, s = cap tanh(x / cap) of x = scale q.k, and dS is
// multiplied by ds/dx = 1 - tanh^2(x / cap), from the tanh that formed
// the score.  The mask is the forward's: causal by index (also when
// S != T), the window keeping j > i - window, columns past T masked; a
// row that sees no column (no path makes one) gets no gradient, where the
// plain version spreads it over every column.
//
// Bound on the H100: operations, 2.5 times the forward's (5 products of
// the forward's size: S, dP, dV, dK, dQ).
//
// bf16 (training): flash_bwd_dq_wgmma and flash_bwd_dkv_wgmma, every
// product on the tensor cores with Hopper's warpgroup MMA (bf16 operands,
// f32 accumulators), tiles in the 128-byte-swizzled layout that wgmma
// reads, the streamed tiles double-buffered with cp.async (tile j + 1
// loads while tile j computes), as in the forward's flash_kernel_wgmma.
// S = Q K^T and dP = dO V^T read both operands from shared memory and are
// exact per product.  The softmax statistics run on the accumulator
// fragments in log2 units (exp2 by the SFU).  P and dS go from the
// fragments straight into the register A operand of the next product,
// split into three bf16 parts (hi + mid + lo, ~24 bits): their other
// operand (K, Q or dO) is exact in bf16, so each product rounds like an
// f32 one.  Two parts, as the forward takes for P V, leave an error of
// 3-28 times the f32 plain backward's own before the output's rounding
// (tests/test_torch_precision.py emulates both), where the bar allows 4.
// The dQ kernel reads K twice, K-major for S and MN-major for dS K; the
// dK/dV kernel computes S^T = K Q^T and dP^T = V dO^T, whose fragments
// are P^T's and dS^T's A operands, and reads Q and dO MN-major, with the
// rows' statistics a Q tile at a time.  Product passes of the forward's
// size: 15 (the dQ kernel S, dP, then S, dP and dS K in three parts; the
// dK/dV kernel S, dP and dV, dK in three parts each), where 5 are the
// minimum: the second S and dP buy the statistics without a pass that
// writes P (or an O the gradient would round through), and the split
// into two kernels buys determinism over atomics on dQ.  Up to D = 128 a
// dQ block holds two warpgroups sharing each K/V tile and a dK/dV block
// two 64-key tiles sharing each Q/dO tile; at D = 256 a dQ block is one
// warpgroup (its 64 x 256 f32 sum takes half its registers) over 32-key
// tiles, and both warpgroups of a dK/dV block share one 64-key tile, each
// summing half of the columns (a thread's dK and dV over all 256 would
// take 256 registers): the two compute the same S^T and dP^T, 10 product
// passes of that kernel where 8 would do.  The dK/dV kernel sums each
// (head, Q tile)'s products in a fresh accumulator and adds it to dK and
// dV on the CUDA cores (product3_add): its sums run over G x S rows.
// D = 32 is padded to 64 columns of zeros.  dQ blocks start with the last Q tiles, dK/dV blocks with the
// first key tiles (the most work under the causal mask).
//
// f32 (the parity runs against the CPU): flash_bwd_dq_kernel and
// flash_bwd_dkv_kernel on the CUDA cores with every intermediate in f32,
// from f32 shared-memory tiles padded by one word (no bank conflicts in
// either product), in the layout of the forward's f32 kernel: 256
// threads, each a 4-row block of the score tile; explicit fmaf keeps the
// products fused under the build's --fmad=false.  9 product passes: the
// dQ kernel's first pass S and dP, its second S, dP and dS K; the dK/dV
// kernel S, dP, P^T dO and dS^T Q.  Each tile's share of a gradient is
// summed apart and then added to the running sum, so the rounding of a
// sum over thousands of rows grows with its tiles.  D = 256 takes
// 32-column key tiles and up to 214,272 B of dynamic shared memory.
#include "attention_tiles.cuh"
#include "mma_tiles.cuh"

#include <type_traits>

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

// ------------------------------------------------ bf16: the tensor cores

using bf16 = __nv_bfloat16;

constexpr int MQ = 64;  // rows of a warpgroup's tile, 16 a warp
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct WgBwd {
  static constexpr int DP = D < 64 ? 64 : D;  // columns in shared memory
  static constexpr int TILE = MQ * DP * 2;    // bytes of a 64-row tile
  // dQ: warpgroups of a block, each its own 64 Q rows, sharing the K/V
  // tiles of BK keys, as in the forward
  static constexpr int NWG = D == 256 ? 1 : 2;
  static constexpr int BK = D == 256 ? 32 : 64;
  static constexpr int KV_TILE = BK * DP * 2;
  // Q and dO of each warpgroup, two stages of K and V, alignment
  static constexpr size_t dq_smem = 1024 + NWG * 2 * TILE + 4 * KV_TILE;
  // dK/dV: two warpgroups, sharing each Q/dO tile; up to D = 128 each
  // owns a 64-key tile and every column, at D = 256 both own one 64-key
  // tile and each half of the columns
  static constexpr int NKT = D == 256 ? 1 : 2;    // 64-key tiles a block
  static constexpr int DW = D == 256 ? 128 : DP;  // columns a warpgroup sums
  static constexpr int STATS = 3 * MQ * 4;  // m, 1 / l, Delta of 64 rows
  // the K and V tiles, two stages of Q, dO, then of the statistics
  static constexpr size_t dkv_smem =
      1024 + 2 * NKT * TILE + 2 * (2 * TILE + STATS);
};

// The score of a raw product x = q.k in log2 units, as the forward's
// tensor-core kernel forms it (scale, then the softcap when CAP); *dcap
// takes the softcap's derivative there.  CAP is a template argument, so
// that the elementwise loops without a softcap carry none of its work
// (a runtime test inside them cost the dK/dV kernel up to a fifth of its
// time).
template <bool CAP>
__device__ __forceinline__ float score_log2(float x, float scale,
                                            float scale_log2, float cap,
                                            float* dcap) {
  if (CAP) {
    const float t = tanhf(x * scale / cap);
    *dcap = 1.f - t * t;
    return t * cap * LOG2E;
  }
  *dcap = 1.f;
  return x * scale_log2;
}

// The byte offset of k-step ks (16 columns) of a K-major operand of
// `rows` rows: 32 bytes a step inside a 64-column atom, atoms rows * 128
// bytes apart.
__device__ __forceinline__ uint32_t kstep(int ks, int rows) {
  return (ks / 4) * rows * 128 + (ks % 4) * 32;
}

// o += A B over BQ / 16 k-steps, A the fragments of a [64, BQ] f32 tile
// split into three bf16 parts, B [BQ, N] MN-major at descriptor db (16
// rows of 128 bytes a k-step).
template <int N, int BQ>
__device__ __forceinline__ void product3(float (&o)[N / 2],
                                         const float (&a)[BQ / 2],
                                         uint64_t db) {
  uint32_t hi[BQ / 16][4], mid[BQ / 16][4], lo[BQ / 16][4];
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      repro_torch::split3_bf16(a[8 * kk + 2 * e], a[8 * kk + 2 * e + 1],
                               hi[kk][e], mid[kk][e], lo[kk][e]);
  repro_torch::fence_regs(o);
  repro_torch::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
    const uint64_t d = db + kk * 16 * 128 / 16;
    repro_torch::pv_wgmma<N>(o, hi[kk], d);
    repro_torch::pv_wgmma<N>(o, mid[kk], d);
    repro_torch::pv_wgmma<N>(o, lo[kk], d);
  }
  repro_torch::wgmma_commit();
  repro_torch::wgmma_wait<0>();
  repro_torch::fence_regs(o);
  repro_torch::fence_regs(hi);
  repro_torch::fence_regs(mid);
  repro_torch::fence_regs(lo);
}

// o += A B as product3 forms it, each 64-column block of the product
// summed in a fresh accumulator and then added to o on the CUDA cores
// (f32, round to nearest).  The tensor cores add each product into their
// accumulator with less than f32's rounding; summed there over a dK/dV
// block's G x S rows (recurrentgemma-2b's 10 heads of 4096 rows), the
// error drifts to ~30 times the f32 plain backward's, while a 64-row
// tile's twelve products stay within it.  One 64-column block at a time,
// so that the fresh sum takes 32 registers.
template <int N, int BQ>
__device__ __forceinline__ void product3_add(float (&o)[N / 2],
                                             const float (&a)[BQ / 2],
                                             uint64_t db) {
  uint32_t hi[BQ / 16][4], mid[BQ / 16][4], lo[BQ / 16][4];
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      repro_torch::split3_bf16(a[8 * kk + 2 * e], a[8 * kk + 2 * e + 1],
                               hi[kk][e], mid[kk][e], lo[kk][e]);
#pragma unroll
  for (int c = 0; c < N / 64; ++c) {
    float t[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) t[i] = 0.f;
    repro_torch::fence_regs(t);
    repro_torch::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      // 64-column panels of B lie BQ rows of 128 bytes apart
      const uint64_t d = db + (c * BQ * 128 + kk * 16 * 128) / 16;
      repro_torch::wgmma_rs_n64(t, hi[kk], d);
      repro_torch::wgmma_rs_n64(t, mid[kk], d);
      repro_torch::wgmma_rs_n64(t, lo[kk], d);
    }
    repro_torch::wgmma_commit();
    repro_torch::wgmma_wait<0>();
    repro_torch::fence_regs(t);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[32 * c + i] += t[i];
  }
  repro_torch::fence_regs(hi);
  repro_torch::fence_regs(mid);
  repro_torch::fence_regs(lo);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(128 * WgBwd<D>::NWG)
    flash_bwd_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout, bf16* __restrict__ dq,
                       float* __restrict__ stats, int heads, int group,
                       int s_len, int t_len, int s_pad, Strides sq,
                       Strides sk, Strides sv, Strides sdo, Strides sdq,
                       float scale, int window, float cap) {
  using W = WgBwd<D>;
  constexpr int BK = W::BK, DP = W::DP, NWG = W::NWG, NT = 128 * NWG;
  extern __shared__ unsigned char smem_raw[];
  // shared-memory addresses: Q and dO of each warpgroup, then K and V of
  // stage 0, then of stage 1
  const uint32_t raw = repro_torch::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t kv_base = base + NWG * 2 * W::TILE;
  auto k_stage = [&](int st) { return kv_base + 2 * st * W::KV_TILE; };
  auto v_stage = [&](int st) { return kv_base + (2 * st + 1) * W::KV_TILE; };

  // the last Q tiles see the most K tiles: they are scheduled first
  const int row0 = (gridDim.y - 1 - blockIdx.y) * MQ * NWG;
  const int hh = blockIdx.x % heads, bb = blockIdx.x / heads;
  const int wg = threadIdx.x / 128;  // the warpgroup
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wg_row0 = row0 + wg * MQ;    // the warpgroup's first row
  const int wrow = wg_row0 + warp * 16;  // the warp's first row
  const uint32_t q_addr = base + wg * 2 * W::TILE;
  const uint32_t do_addr = q_addr + W::TILE;
  const bf16* kb = k + bb * sk.b + (hh / group) * sk.h;
  const bf16* vb = v + bb * sv.b + (hh / group) * sv.h;

  // the forward's key tiles: causal stops at the block's last row, the
  // window starts after row0 - window; and those of the warpgroup's rows,
  // which compute only the tiles they see
  const int col_end = CAUSAL ? min(t_len, row0 + MQ * NWG) : t_len;
  const int col_begin = window > 0 ? max(0, row0 - window + 1) : 0;
  const int wg_end =
      wg_row0 >= s_len ? 0 : CAUSAL ? min(t_len, wg_row0 + MQ) : t_len;
  const int wg_begin = window > 0 ? max(0, wg_row0 - window + 1) : 0;
  const int first = (col_begin / BK) * BK;
  const int ntiles = max(0, (col_end - first + BK - 1) / BK);
  // iterations it and ntiles + it (passes 1 and 2) read tile it
  const repro_torch::TileCopy<D, BK, NT> copy_kv;
  auto load_kv = [&](int it) {
    const int col0 = first + (it < ntiles ? it : it - ntiles) * BK;
    copy_kv(k_stage(it & 1), kb + col0 * sk.s, sk.s, t_len - col0);
    copy_kv(v_stage(it & 1), vb + col0 * sv.s, sv.s, t_len - col0);
  };

  if constexpr (D < DP) {  // the pad columns stay 0 in every tile
    for (int i = threadIdx.x; i < (NWG * 2 * W::TILE + 4 * W::KV_TILE) / 16;
         i += NT)
      reinterpret_cast<uint4*>(smem_raw + (base - raw))[i] =
          make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  const repro_torch::TileCopy<D, MQ, NT> copy_rows;
  for (int w = 0; w < NWG; ++w) {  // rows past S: a valid address, zeros
    const int r = min(row0 + w * MQ, s_len - 1);
    copy_rows(base + 2 * w * W::TILE, q + bb * sq.b + hh * sq.h + r * sq.s,
              sq.s, s_len - row0 - w * MQ);
    copy_rows(base + (2 * w + 1) * W::TILE,
              dout + bb * sdo.b + hh * sdo.h + r * sdo.s, sdo.s,
              s_len - row0 - w * MQ);
  }
  if (ntiles > 0) load_kv(0);
  repro_torch::cp_async_commit();

  float acc[DP / 2];  // dQ: n-block j, element e at acc[4 j + e]
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  // each of the thread's two rows: the max (log2 units), the sums of p
  // and of p dP over the thread's columns, then 1 / l and Delta
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f};
  float inv_l[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  const float scale_log2 = scale * LOG2E;
  // wgmma descriptors: Q, dO and stage 0's K and V K-major (S, dP), and K
  // MN-major (dS K); a k-step adds its offset / 16 to the address field,
  // stage 1 its distance / 16
  const uint64_t q_desc = repro_torch::sw128_desc(q_addr, 16);
  const uint64_t do_desc = repro_torch::sw128_desc(do_addr, 16);
  const uint64_t k_desc = repro_torch::sw128_desc(k_stage(0), 16);
  const uint64_t v_desc = repro_torch::sw128_desc(v_stage(0), 16);
  const uint64_t kt_desc = repro_torch::sw128_desc(k_stage(0), BK * 128);
  constexpr int STAGE = 2 * W::KV_TILE / 16;

  for (int it = 0; it < 2 * ntiles; ++it) {
    if (it + 1 < 2 * ntiles) load_kv(it + 1);
    repro_torch::cp_async_commit();
    repro_torch::cp_async_wait<1>();  // tile it has landed
    repro_torch::fence_proxy_async();
    __syncthreads();
    const bool pass2 = it >= ntiles;
    if (it == ntiles) {  // pass 1 done: a row lives in the 4 lanes of a quad
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        pd[r] += __shfl_xor_sync(0xffffffffu, pd[r], 1);
        pd[r] += __shfl_xor_sync(0xffffffffu, pd[r], 2);
        inv_l[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
        delta[r] = pd[r] * inv_l[r];
      }
    }
    const int stage = (it & 1) * STAGE;
    const int col0 = first + (pass2 ? it - ntiles : it) * BK;
    if (col0 < wg_end && col0 + BK > wg_begin) {  // the warpgroup sees some
      // S = Q K^T and dP = dO V^T for its 64 rows and the tile's columns
      float sc[BK / 2], dp[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.f;
      repro_torch::fence_regs(sc);
      repro_torch::fence_regs(dp);
      repro_torch::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        repro_torch::qk_wgmma<BK>(sc, q_desc + kstep(ks, MQ) / 16,
                                  k_desc + stage + kstep(ks, BK) / 16,
                                  ks > 0);
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        repro_torch::qk_wgmma<BK>(dp, do_desc + kstep(ks, MQ) / 16,
                                  v_desc + stage + kstep(ks, BK) / 16,
                                  ks > 0);
      repro_torch::wgmma_commit();
      repro_torch::wgmma_wait<0>();
      repro_torch::fence_regs(sc);
      repro_torch::fence_regs(dp);

      // sc[4 j + e] is row wrow + g + 8 (e / 2), column
      // col0 + 8 j + 2 t4 + e % 2; the mask only where the tile crosses
      // the causal diagonal, T or the window for some row of the warp
      const bool masked = (CAUSAL && col0 + BK - 1 > wrow) ||
                          col0 + BK > t_len ||
                          (window > 0 && col0 <= wrow + 15 - window);
      auto seen = [&](int i) {
        return !masked ||
               visible<CAUSAL>(wrow + g + (i % 4 / 2) * 8,
                               col0 + i / 4 * 8 + 2 * t4 + (i & 1), t_len,
                               window);
      };
      // the elementwise passes, compiled with and without the softcap
      auto stats_pass = [&](auto capped) {  // the online statistics
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          float dc;
          const float x = score_log2<decltype(capped)::value>(
              sc[i], scale, scale_log2, cap, &dc);
          sc[i] = seen(i) ? x : NEG_INF;
          mx[i % 4 / 2] = fmaxf(mx[i % 4 / 2], sc[i]);
        }
        float alpha[2], sum[2] = {0.f, 0.f}, sdp[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          alpha[r] = repro_torch::exp2_approx(m[r] - m_new);
          m[r] = m_new;
        }
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const float p = repro_torch::exp2_approx(sc[i] - m[i % 4 / 2]);
          sum[i % 4 / 2] += p;
          sdp[i % 4 / 2] += p * dp[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = l[r] * alpha[r] + sum[r];
          pd[r] = pd[r] * alpha[r] + sdp[r];
        }
      };
      auto grad_pass = [&](auto capped) {  // dS = P (dP - Delta) ds/dx
        constexpr bool CAP = decltype(capped)::value;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int r = i % 4 / 2;
          float dc;
          const float x = score_log2<CAP>(sc[i], scale, scale_log2, cap, &dc);
          const float p =
              seen(i) ? repro_torch::exp2_approx(x - m[r]) * inv_l[r] : 0.f;
          dp[i] = p * (dp[i] - delta[r]);
          if (CAP) dp[i] *= dc;
        }
      };
      if (!pass2) {
        if (cap > 0.f)
          stats_pass(std::true_type{});
        else
          stats_pass(std::false_type{});
      } else {  // then dQ += dS K
        if (cap > 0.f)
          grad_pass(std::true_type{});
        else
          grad_pass(std::false_type{});
        product3<DP, BK>(acc, dp, kt_desc + stage);
      }
    }
    __syncthreads();  // this stage is reloaded two tiles on
  }
  repro_torch::cp_async_wait<0>();  // no copy outlives the block

  if (wg_row0 >= s_len) return;
  // the statistics of every row of the tile, those past S too (finite:
  // their Q and dO rows are zeros), for the dK/dV kernel
  float* sb = stats + static_cast<size_t>(bb * heads + hh) * 3 * s_pad;
  bf16* ob = dq + bb * sdq.b + hh * sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    if (t4 == 0) {
      sb[row] = m[r];
      sb[s_pad + row] = inv_l[r];
      sb[2 * s_pad + row] = delta[r];
    }
    if (row >= s_len) continue;
    bf16* out = ob + row * sdq.s + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(256)
    flash_bwd_dkv_wgmma(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout, bf16* __restrict__ dk,
                        bf16* __restrict__ dv,
                        const float* __restrict__ stats, int heads,
                        int group, int s_len, int t_len, int s_pad,
                        Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdk, Strides sdv, float scale, int window,
                        float cap) {
  using W = WgBwd<D>;
  constexpr int DP = W::DP, DW = W::DW, NKT = W::NKT, NT = 256;
  extern __shared__ unsigned char smem_raw[];
  // shared-memory addresses: the K tiles, the V tiles, then Q and dO of
  // stage 0, of stage 1, then the rows' statistics of each stage
  const uint32_t raw = repro_torch::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t rows_base = base + 2 * NKT * W::TILE;
  auto q_stage = [&](int st) { return rows_base + 2 * st * W::TILE; };
  auto do_stage = [&](int st) { return rows_base + (2 * st + 1) * W::TILE; };
  const uint32_t stats_base = rows_base + 4 * W::TILE;
  const float* stats_s =
      reinterpret_cast<const float*>(smem_raw + (stats_base - raw));

  // the first key tiles see the most Q tiles: they are scheduled first
  const int kv_heads = heads / group;
  const int key0 = blockIdx.y * MQ * NKT;
  const int kvh = blockIdx.x % kv_heads, bb = blockIdx.x / kv_heads;
  const int wg = threadIdx.x / 128;  // the warpgroup
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int kt = NKT == 2 ? wg : 0;    // the warpgroup's key tile
  const int oc = D == 256 ? wg * DW : 0;  // and its first column
  const int wkey0 = key0 + kt * MQ;    // its first key
  const int wkey = wkey0 + warp * 16;  // the warp's first key

  // the Q rows that see a key of the block: causal from row key0, a window
  // up to row key0 + nvalid - 2 + window; and those of the warpgroup's
  // keys, which compute only the Q tiles they see
  const int nvalid = min(MQ * NKT, t_len - key0);
  const int row_begin = CAUSAL ? key0 : 0;
  const int row_end =
      window > 0 ? min(s_len, key0 + nvalid - 1 + window) : s_len;
  const int wg_valid = min(MQ, t_len - wkey0);
  const int wg_begin = CAUSAL ? wkey0 : 0;
  const int wg_end = wg_valid <= 0 ? 0
                     : window > 0 ? min(s_len, wkey0 + wg_valid - 1 + window)
                                  : s_len;
  const int first = (row_begin / MQ) * MQ;
  const int nrt = max(0, (row_end - first + MQ - 1) / MQ);
  const int ntiles = group * nrt;  // (head of the group, Q tile), in order
  const repro_torch::TileCopy<D, MQ, NT> copy_rows;
  auto load_rows = [&](int it) {
    const int hh = kvh * group + it / nrt, row0 = first + it % nrt * MQ;
    const int st = it & 1;
    copy_rows(q_stage(st), q + bb * sq.b + hh * sq.h + row0 * sq.s, sq.s,
              s_len - row0);
    copy_rows(do_stage(st), dout + bb * sdo.b + hh * sdo.h + row0 * sdo.s,
              sdo.s, s_len - row0);
    if (threadIdx.x < 3 * MQ / 4) {  // m, 1 / l, Delta: 16-byte pieces
      const int part = threadIdx.x / (MQ / 4), piece = threadIdx.x % (MQ / 4);
      repro_torch::cp_async16(
          stats_base + (st * 3 + part) * MQ * 4 + piece * 16,
          stats + (static_cast<size_t>(bb * heads + hh) * 3 + part) * s_pad +
              row0 + piece * 4,
          true);
    }
  };

  if constexpr (D < DP) {  // the pad columns stay 0 in every tile
    for (int i = threadIdx.x; i < (2 * NKT + 4) * W::TILE / 16; i += NT)
      reinterpret_cast<uint4*>(smem_raw + (base - raw))[i] =
          make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  for (int t = 0; t < NKT; ++t) {  // keys past T: a valid address, zeros
    const int c = min(key0 + t * MQ, t_len - 1);
    copy_rows(base + t * W::TILE, k + bb * sk.b + kvh * sk.h + c * sk.s,
              sk.s, t_len - key0 - t * MQ);
    copy_rows(base + (NKT + t) * W::TILE,
              v + bb * sv.b + kvh * sv.h + c * sv.s, sv.s,
              t_len - key0 - t * MQ);
  }
  if (ntiles > 0) load_rows(0);
  repro_torch::cp_async_commit();

  // dK and dV of the warpgroup's 64 keys and DW columns: n-block j,
  // element e at [4 j + e]
  float dka[DW / 2], dva[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) dka[i] = dva[i] = 0.f;
  const float scale_log2 = scale * LOG2E;
  // wgmma descriptors: the warpgroup's K and V K-major (A of S^T and
  // dP^T); stage 0's Q and dO K-major (their B) and MN-major from column
  // oc (B of dK and dV); stage 1 adds its distance / 16
  const uint64_t k_desc = repro_torch::sw128_desc(base + kt * W::TILE, 16);
  const uint64_t v_desc =
      repro_torch::sw128_desc(base + (NKT + kt) * W::TILE, 16);
  const uint64_t q_desc = repro_torch::sw128_desc(q_stage(0), 16);
  const uint64_t do_desc = repro_torch::sw128_desc(do_stage(0), 16);
  const uint64_t qt_desc =
      repro_torch::sw128_desc(q_stage(0) + oc / 64 * MQ * 128, MQ * 128);
  const uint64_t dot_desc =
      repro_torch::sw128_desc(do_stage(0) + oc / 64 * MQ * 128, MQ * 128);
  constexpr int STAGE = 2 * W::TILE / 16;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_rows(it + 1);
    repro_torch::cp_async_commit();
    repro_torch::cp_async_wait<1>();  // tile it has landed
    repro_torch::fence_proxy_async();
    __syncthreads();
    const int st = it & 1, row0 = first + it % nrt * MQ;
    const int stage = st * STAGE;
    if (row0 < wg_end && row0 + MQ > wg_begin) {  // some key sees some row
      // S^T = K Q^T and dP^T = V dO^T for the 64 keys and the tile's rows
      float sc[MQ / 2], dp[MQ / 2];
#pragma unroll
      for (int i = 0; i < MQ / 2; ++i) sc[i] = dp[i] = 0.f;
      repro_torch::fence_regs(sc);
      repro_torch::fence_regs(dp);
      repro_torch::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        repro_torch::wgmma_ss_n64(sc, k_desc + kstep(ks, MQ) / 16,
                                  q_desc + stage + kstep(ks, MQ) / 16,
                                  ks > 0);
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        repro_torch::wgmma_ss_n64(dp, v_desc + kstep(ks, MQ) / 16,
                                  do_desc + stage + kstep(ks, MQ) / 16,
                                  ks > 0);
      repro_torch::wgmma_commit();
      repro_torch::wgmma_wait<0>();
      repro_torch::fence_regs(sc);
      repro_torch::fence_regs(dp);

      // P^T and dS^T: sc[4 j + e] is key wkey + g + 8 (e / 2), row
      // row0 + c with c = 8 j + 2 t4 + e % 2; the mask only where the tile
      // crosses the causal diagonal, T, S or the window for some key of
      // the warp
      const bool masked = (CAUSAL && wkey + 15 > row0) ||
                          wkey + 15 >= t_len || row0 + MQ > s_len ||
                          (window > 0 && wkey <= row0 + MQ - 1 - window);
      auto grads = [&](auto capped) {  // compiled with and without a softcap
        constexpr bool CAP = decltype(capped)::value;
        const float2* rs =
            reinterpret_cast<const float2*>(stats_s + st * 3 * MQ);
#pragma unroll
        for (int j = 0; j < MQ / 8; ++j) {
          // m, 1 / l and Delta of rows row0 + c and c + 1
          const int c = j * 8 + 2 * t4;
          const float2 mj = rs[c / 2], lj = rs[(MQ + c) / 2],
                       dj = rs[(2 * MQ + c) / 2];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e, row = row0 + c + (e & 1);
            const float mr = e & 1 ? mj.y : mj.x, lr = e & 1 ? lj.y : lj.x,
                        dr = e & 1 ? dj.y : dj.x;
            float dc;
            const float x =
                score_log2<CAP>(sc[i], scale, scale_log2, cap, &dc);
            const bool ok =
                !masked ||
                (row < s_len && visible<CAUSAL>(row, wkey + g + (e / 2) * 8,
                                                t_len, window));
            const float p =
                ok ? repro_torch::exp2_approx(x - mr) * lr : 0.f;
            sc[i] = p;
            dp[i] = p * (dp[i] - dr);
            if (CAP) dp[i] *= dc;
          }
        }
      };
      if (cap > 0.f)
        grads(std::true_type{});
      else
        grads(std::false_type{});
      product3_add<DW, MQ>(dva, sc, dot_desc + stage);  // dV += P^T dO
      product3_add<DW, MQ>(dka, dp, qt_desc + stage);   // dK += dS^T Q
    }
    __syncthreads();  // this stage is reloaded two tiles on
  }
  repro_torch::cp_async_wait<0>();  // no copy outlives the block

  // keys past T are not written; D = 32 writes its 32 columns
  constexpr int NC = D < DW ? D : DW;
  bf16* kout = dk + bb * sdk.b + kvh * sdk.h + oc;
  bf16* vout = dv + bb * sdv.b + kvh * sdv.h + oc;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = wkey + g + 8 * r;
    if (key >= t_len) continue;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(kout + key * sdk.s + j * 8 + 2 * t4) =
          __floats2bfloat162_rn(dka[4 * j + 2 * r] * scale,
                                dka[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vout + key * sdv.s + j * 8 + 2 * t4) =
          __floats2bfloat162_rn(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, void* dq, void* dk, void* dv,
                 float* stats, int b, int h, int kv, int s, int t,
                 const long long* st, float scale, bool causal, int window,
                 float cap, cudaStream_t stream) {
  using W = WgBwd<D>;
  static const cudaError_t attr[4] = {
      allow_smem(flash_bwd_dq_wgmma<D, false>, W::dq_smem),
      allow_smem(flash_bwd_dq_wgmma<D, true>, W::dq_smem),
      allow_smem(flash_bwd_dkv_wgmma<D, false>, W::dkv_smem),
      allow_smem(flash_bwd_dkv_wgmma<D, true>, W::dkv_smem)};
  for (const cudaError_t e : attr)
    if (e != cudaSuccess) return static_cast<int>(e);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, sdo{st[9], st[10], st[11]},
      sdq{st[12], st[13], st[14]}, sdk{st[15], st[16], st[17]},
      sdv{st[18], st[19], st[20]};
  const int s_pad = (s + MQ - 1) / MQ * MQ;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const auto dq_kernel = causal ? flash_bwd_dq_wgmma<D, true>
                                : flash_bwd_dq_wgmma<D, false>;
  constexpr int rows = MQ * W::NWG;
  dq_kernel<<<dim3(b * h, (s + rows - 1) / rows), 128 * W::NWG, W::dq_smem,
              stream>>>(qt, kt, vt, dot, static_cast<bf16*>(dq), stats, h,
                        h / kv, s, t, s_pad, sq, sk, sv, sdo, sdq, scale,
                        window, cap);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto dkv_kernel = causal ? flash_bwd_dkv_wgmma<D, true>
                                 : flash_bwd_dkv_wgmma<D, false>;
  constexpr int keys = MQ * W::NKT;
  dkv_kernel<<<dim3(b * kv, (t + keys - 1) / keys), 256, W::dkv_smem,
               stream>>>(qt, kt, vt, dot, static_cast<bf16*>(dk),
                         static_cast<bf16*>(dv), stats, h, h / kv, s, t,
                         s_pad, sq, sk, sv, sdo, sdk, sdv, scale, window,
                         cap);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_wgmma(int d, const void* q, const void* k, const void* v,
                   const void* dout, void* dq, void* dk, void* dv,
                   float* stats, int b, int h, int kv, int s, int t,
                   const long long* st, float scale, bool causal, int window,
                   float cap, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_wgmma<32>(q, k, v, dout, dq, dk, dv, stats, b, h, kv, s,
                              t, st, scale, causal, window, cap, stream);
    case 64:
      return launch_wgmma<64>(q, k, v, dout, dq, dk, dv, stats, b, h, kv, s,
                              t, st, scale, causal, window, cap, stream);
    case 128:
      return launch_wgmma<128>(q, k, v, dout, dq, dk, dv, stats, b, h, kv, s,
                               t, st, scale, causal, window, cap, stream);
    case 256:
      return launch_wgmma<256>(q, k, v, dout, dq, dk, dv, stats, b, h, kv, s,
                               t, st, scale, causal, window, cap, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, dout, dq [b, h, s, d] and k, v, dk, dv [b, kv, t, d] on the device,
// in f32 (bf16 == 0) or bf16 (bf16 == 1), with the element strides of the
// batch, head and sequence dims in st[21] (q, k, v, dout, dq, dk, dv; the
// last dim is contiguous, rows 16-byte aligned); stats an f32 scratch of
// 3 * b * h * s_pad, s_pad = s rounded up to a multiple of 64, 16-byte
// aligned.  causal, window and cap as the forward takes them.  Launches
// both kernels on `stream` and returns cudaGetLastError() (0 = launched).
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
    return dispatch_wgmma(d, q, k, v, dout, dq, dk, dv, sf, b, h, kv, s, t,
                          st, scale, causal != 0, window, cap, cs);
  return dispatch<float>(d, q, k, v, dout, dq, dk, dv, sf, b, h, kv, s, t,
                         st, scale, causal != 0, window, cap, cs);
}
