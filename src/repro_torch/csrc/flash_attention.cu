// GQA flash attention (prefill), causal or not, with an optional sliding
// window and tanh softcap.
//
// Replaces the TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention
// (_flash_kernel), whose grid walked the K blocks of one (batch, head,
// Q block) in order and carried the online-softmax state (max, denom, acc)
// in VMEM scratch.  Here one thread block owns one (batch, head, 64-row Q
// tile) and loops over the K/V tiles itself, carrying the state in
// registers; tiles that the causal or window mask excludes entirely are
// never loaded.  Causal, row i sees the columns j <= i (by index, with
// S != T too); not causal, every column j < T, a window still keeping
// only j > i - window (the Pallas kernel's `causal` flag).  Head h reads
// KV head h / (H / KV).  The kernels mask a ragged S and T themselves
// (the Pallas kernel asserted S % 128 == 0): rows past S are not written,
// columns past T are masked and their K/V rows zero-filled.
//
// Bound on the H100: operations.  Per (row, visible column) the function
// does 4 * D flops against 2 * D * sizeof(T) / 64 bytes of K/V per row of
// a 64-row tile, far above the card's 295 flops per byte in bf16.
//
// bf16 (the serving path): flash_kernel_wgmma, both products on the
// tensor cores with Hopper's warpgroup MMA (wgmma m64nNk16, bf16 operands,
// f32 accumulators).  A warpgroup (4 warps of 16 rows) owns a 64-row Q
// tile; a block holds two of them up to D = 128, sharing each K/V tile
// (one at D = 256, whose 128 output accumulators a thread fill half its
// registers).  Q, K and V live in shared memory in the 128-byte-swizzled
// layout that wgmma reads without bank conflicts; K/V tiles of 64
// columns (32 at D = 256) are double-buffered with cp.async: tile j + 1
// loads while tile j computes.  S = Q K^T reads both operands from shared
// memory and is exact per product (bf16 times bf16 fits f32).  The online
// softmax runs on the accumulator fragments in log2 units (exp2 by the
// SFU; quad shuffles for a row's max; the sum stays per thread until the
// end), and P goes from the score fragments straight into the register A
// operand of P V (V read transposed).  P is split into bf16 hi + lo and
// multiplied twice: V is exact in bf16, so P V keeps ~16 bits of each
// probability where one bf16 rounding keeps 8 and misses the
// 1e-4 + 2^-8 |want| bar against the f32 plain version.  What bounds it
// is the instructions around the products, not the tensor cores: each
// thread's copy offsets and the wgmma descriptors are worked out once,
// not per tile.  D = 32 is padded to 64 columns of zeros.  Blocks start
// with the last Q tiles (most K tiles under the causal mask).
//
// f32 (the parity runs against the CPU): flash_kernel, the CUDA cores.
// 256 threads, each owning a 4-row x 4-column block of the score tile and
// a 4-row x D/16 block of the output, read from shared-memory f32 tiles
// padded by one word so that neither product has bank conflicts.
// Explicit fmaf keeps the products fused under the build's --fmad=false.
#include "attention_tiles.cuh"
#include "mma_tiles.cuh"

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

template <typename T, int D, bool CAUSAL>
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
  const int col_end = CAUSAL ? min(t_len, row0 + BQ) : t_len;
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
        bool ok = col < t_len && (!CAUSAL || col <= row);
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

// Lets `kernel` take `bytes` of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The causal mask is a template argument: the unmasked kernel is compiled
// apart, and the causal one exactly as it was before it existed.
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int kv, int s, int t, const long long* st, float scale,
           bool causal, int window, float cap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static const cudaError_t attr[2] = {
      allow_smem(flash_kernel<T, D, false>, smem),
      allow_smem(flash_kernel<T, D, true>, smem)};
  if (attr[causal] != cudaSuccess) return static_cast<int>(attr[causal]);
  const auto kernel =
      causal ? flash_kernel<T, D, true> : flash_kernel<T, D, false>;
  const dim3 grid((s + BQ - 1) / BQ, h, b);
  kernel<<<grid, NT, smem, stream>>>(
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
             float scale, bool causal, int window, float cap,
             cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, h, kv, s, t, st, scale, causal,
                           window, cap, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, h, kv, s, t, st, scale, causal,
                           window, cap, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, h, kv, s, t, st, scale, causal,
                            window, cap, stream);
    case 256:  // 213,760 B of shared memory: one block per SM
      return launch<T, 256>(q, k, v, o, b, h, kv, s, t, st, scale, causal,
                            window, cap, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------ bf16: the tensor cores

constexpr int MQ = 64;  // query rows of a warpgroup, 16 a warp
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct WgTile {
  static constexpr int DP = D < 64 ? 64 : D;  // columns in shared memory
  static constexpr int BK = D == 256 ? 32 : 64;  // key columns per tile
  // warpgroups of a block, each with its own 64-row Q tile, sharing the
  // K/V tiles: two up to D = 128, one at D = 256 (the faster of one, two
  // and three on the H100)
  static constexpr int NWG = D == 256 ? 1 : 2;
  static constexpr int NT = 128 * NWG;  // threads
  static constexpr int Q_BYTES = MQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;  // one K or V tile
  // the Q tiles and two stages of K and V, and room to align them to 1024
  // bytes
  static constexpr size_t smem() {
    return 1024 + NWG * Q_BYTES + 4 * KV_BYTES;
  }
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(WgTile<D>::NT)
    flash_kernel_wgmma(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int heads, int group,
                       int s_len, int t_len, Strides sq, Strides sk,
                       Strides sv, Strides so, float scale, int window,
                       float cap) {
  using Tile = WgTile<D>;
  constexpr int BK = Tile::BK, DP = Tile::DP, NWG = Tile::NWG;
  extern __shared__ unsigned char smem_raw[];
  // shared-memory addresses: the Q tiles, then K and V of stage 0, then of
  // stage 1
  const uint32_t raw = repro_torch::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  auto k_stage = [&](int st) {
    return base + NWG * Tile::Q_BYTES + 2 * st * Tile::KV_BYTES;
  };
  auto v_stage = [&](int st) {
    return base + NWG * Tile::Q_BYTES + (2 * st + 1) * Tile::KV_BYTES;
  };

  // the last Q tiles see the most K tiles: they are scheduled first
  const int row0 = (gridDim.y - 1 - blockIdx.y) * MQ * NWG;
  const int hh = blockIdx.x % heads, bb = blockIdx.x / heads;
  const int wg = threadIdx.x / 128;  // the warpgroup
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wg_row0 = row0 + wg * MQ;    // the warpgroup's first row
  const int wrow = wg_row0 + warp * 16;  // the warp's first row
  const uint32_t q_addr = base + wg * Tile::Q_BYTES;
  const __nv_bfloat16* kb = k + bb * sk.b + (hh / group) * sk.h;
  const __nv_bfloat16* vb = v + bb * sv.b + (hh / group) * sv.h;

  // the columns any row of the block can see: causal stops at its last
  // row, the window starts after row0 - window; and those of the
  // warpgroup's rows, which compute only the tiles they see
  const int col_end = CAUSAL ? min(t_len, row0 + MQ * NWG) : t_len;
  const int col_begin = window > 0 ? max(0, row0 - window + 1) : 0;
  const int wg_end =
      wg_row0 >= s_len ? 0 : CAUSAL ? min(t_len, wg_row0 + MQ) : t_len;
  const int wg_begin = window > 0 ? max(0, wg_row0 - window + 1) : 0;
  const int first = (col_begin / BK) * BK;
  const int ntiles = (col_end - first + BK - 1) / BK;
  const repro_torch::TileCopy<D, BK, Tile::NT> copy_kv;
  auto load_kv = [&](int it) {
    const int col0 = first + it * BK;
    copy_kv(k_stage(it & 1), kb + col0 * sk.s, sk.s, t_len - col0);
    copy_kv(v_stage(it & 1), vb + col0 * sv.s, sv.s, t_len - col0);
  };

  if constexpr (D < DP) {  // the pad columns stay 0 in every tile
    for (int i = threadIdx.x;
         i < (NWG * Tile::Q_BYTES + 4 * Tile::KV_BYTES) / 16; i += Tile::NT)
      reinterpret_cast<uint4*>(smem_raw + (base - raw))[i] =
          make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  const repro_torch::TileCopy<D, MQ, Tile::NT> copy_q;
  for (int w = 0; w < NWG; ++w)  // rows past S: a valid address, zero-filled
    copy_q(base + w * Tile::Q_BYTES,
           q + bb * sq.b + hh * sq.h + min(row0 + w * MQ, s_len - 1) * sq.s,
           sq.s, s_len - row0 - w * MQ);
  load_kv(0);
  repro_torch::cp_async_commit();

  float acc[DP / 2];  // n-block j, element e at acc[4 j + e]
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // m in log2 units
  const float scale_log2 = scale * LOG2E;
  // wgmma descriptors of Q and of each stage's K and V; a k-step adds its
  // offset / 16 to the address field
  const uint64_t q_desc = repro_torch::sw128_desc(q_addr, 16);
  const uint64_t k_desc[2] = {repro_torch::sw128_desc(k_stage(0), 16),
                              repro_torch::sw128_desc(k_stage(1), 16)};
  const uint64_t v_desc[2] = {repro_torch::sw128_desc(v_stage(0), BK * 128),
                              repro_torch::sw128_desc(v_stage(1), BK * 128)};

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_kv(it + 1);
    repro_torch::cp_async_commit();
    repro_torch::cp_async_wait<1>();  // tile it has landed
    repro_torch::fence_proxy_async();
    __syncthreads();
    const uint64_t kd = k_desc[it & 1], vd = v_desc[it & 1];
    const int col0 = first + it * BK;
    if (col0 < wg_end && col0 + BK > wg_begin) {  // the warpgroup sees some
      // S = Q K^T for the warpgroup's 64 rows and the tile's BK columns
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      repro_torch::fence_regs(sc);
      repro_torch::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        repro_torch::qk_wgmma<BK>(
            sc, q_desc + ((ks / 4) * MQ * 128 + (ks % 4) * 32) / 16,
            kd + ((ks / 4) * BK * 128 + (ks % 4) * 32) / 16, ks > 0);
      }
      repro_torch::wgmma_commit();
      repro_torch::wgmma_wait<0>();
      repro_torch::fence_regs(sc);

      // scale (in log2 units: exp2 of the scaled score is exp of the
      // score), softcap and mask (only where the tile crosses the causal
      // diagonal, T or the window for some row of the warp); sc[4 j + e] is
      // row
      // wrow + g + 8 (e / 2), column col0 + 8 j + 2 t4 + e % 2
      if (cap > 0.f) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          sc[i] = repro_torch::apply_softcap(sc[i] * scale, cap) * LOG2E;
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] *= scale_log2;
      }
      if ((CAUSAL && col0 + BK - 1 > wrow) || col0 + BK > t_len ||
          (window > 0 && col0 <= wrow + 15 - window)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int row = wrow + g + (i % 4 / 2) * 8;
          const int col = col0 + i / 4 * 8 + 2 * t4 + (i & 1);
          bool ok = col < t_len && (!CAUSAL || col <= row);
          if (window > 0) ok = ok && col > row - window;
          if (!ok) sc[i] = NEG_INF;
        }
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mx[i % 4 / 2] = fmaxf(mx[i % 4 / 2], sc[i]);

      // online softmax: a row lives in the 4 lanes of a quad
      float alpha[2], sum[2] = {0.f, 0.f};
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
        sc[i] = p;
        sum[i % 4 / 2] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[i % 4 / 2];

      // acc += P V, P as bf16 hi + lo straight from the score fragments:
      // n-blocks 2 kk and 2 kk + 1 are the A fragment of k-step kk
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          repro_torch::split_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1],
                                  ph[kk][e], pl[kk][e]);
      repro_torch::fence_regs(acc);
      repro_torch::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        repro_torch::pv_wgmma<DP>(acc, ph[kk], vd + kk * 16 * 128 / 16);
        repro_torch::pv_wgmma<DP>(acc, pl[kk], vd + kk * 16 * 128 / 16);
      }
      repro_torch::wgmma_commit();
      repro_torch::wgmma_wait<0>();
      repro_torch::fence_regs(acc);
      repro_torch::fence_regs(ph);
      repro_torch::fence_regs(pl);
    }
    __syncthreads();  // this stage is reloaded two tiles on
  }

  __nv_bfloat16* ob = o + bb * so.b + hh * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = wrow + g + 8 * r;
    if (row >= s_len) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* out = ob + row * so.s + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int b,
                 int h, int kv, int s, int t, const long long* st,
                 float scale, bool causal, int window, float cap,
                 cudaStream_t stream) {
  constexpr size_t smem = WgTile<D>::smem();
  static const cudaError_t attr[2] = {
      allow_smem(flash_kernel_wgmma<D, false>, smem),
      allow_smem(flash_kernel_wgmma<D, true>, smem)};
  if (attr[causal] != cudaSuccess) return static_cast<int>(attr[causal]);
  const auto kernel =
      causal ? flash_kernel_wgmma<D, true> : flash_kernel_wgmma<D, false>;
  constexpr int rows = MQ * WgTile<D>::NWG;
  const dim3 grid(b * h, (s + rows - 1) / rows);
  using bf16 = __nv_bfloat16;
  kernel<<<grid, WgTile<D>::NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), h, h / kv, s, t,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, scale,
      window, cap);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_wgmma(int d, const void* q, const void* k, const void* v,
                   void* o, int b, int h, int kv, int s, int t,
                   const long long* st, float scale, bool causal,
                   int window, float cap, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_wgmma<32>(q, k, v, o, b, h, kv, s, t, st, scale, causal,
                              window, cap, stream);
    case 64:
      return launch_wgmma<64>(q, k, v, o, b, h, kv, s, t, st, scale, causal,
                              window, cap, stream);
    case 128:
      return launch_wgmma<128>(q, k, v, o, b, h, kv, s, t, st, scale, causal,
                               window, cap, stream);
    case 256:
      return launch_wgmma<256>(q, k, v, o, b, h, kv, s, t, st, scale, causal,
                               window, cap, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [b, h, s, d], k and v [b, kv, t, d], o [b, h, s, d] on the device, in
// f32 (bf16 == 0) or bf16 (bf16 == 1), with the element strides of the
// batch, head and sequence dims in st[12] (q, k, v, o; the last dim is
// contiguous, rows 16-byte aligned).  causal != 0: row i sees columns
// j <= i only; window <= 0: none; cap <= 0: none.  Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int b, int h, int kv, int s, int t,
                               int d, const long long* st, float scale,
                               int causal, int window, float cap, int bf16,
                               void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch_wgmma(d, q, k, v, o, b, h, kv, s, t, st, scale,
                          causal != 0, window, cap, cs);
  return dispatch<float>(d, q, k, v, o, b, h, kv, s, t, st, scale,
                         causal != 0, window, cap, cs);
}
