// Flash decode: one query token per row against its KV cache, GQA, per-row
// lengths, optional sliding window and tanh softcap.
//
// Replaces the TPU kernel
// repro/kernels/decode_attention/decode_attention.py::decode_attention
// (_decode_kernel), whose grid ran (batch, q head, K block) with the
// K-block axis in order, the online-softmax state in VMEM and the blocks
// past the length skipped.  Here one thread block owns one (batch, KV
// head, split of the cache) and serves all G = H / KV query heads of the
// group, so each K/V row is read from device memory once per group, not
// once per query head.  It walks only the valid columns [lo, len) of its
// split, where lo = len - window when windowed, so it reads nothing past
// lengths[b]; any T is allowed.
//
// Bound on the H100: bytes.  Each valid cache position costs
// 2 * D * sizeof(T) bytes of K/V for 4 * D * G flops, far below the
// card's 295 flops per byte.  Reading the cache fast needs many bytes in
// flight, and B * KV blocks (64 for llama3-8b at batch 8, 8 for
// recurrentgemma-2b) cannot fill 132 SMs, so the cache is split along T
// into gridDim.y pieces: each block leaves its partial (max, denom, acc)
// in a workspace and the last block of its (batch, KV head) to finish
// merges them, found with a threadfence and an atomic ticket (CUDA's
// threadFenceReduction sample), and sets the ticket back to 0, so the
// workspace is allocated once.  One launch, no second kernel.  The
// wrapper sizes the splits from the blocks per SM that
// decode_attention_blocks_per_sm reports for the (D, G, dtype) at hand.
//
// bf16 (the serving path): decode_kernel_mma, on the tensor cores.  The
// group's G <= 16 query heads are the 16 rows of mma.sync m16n8k16 (rows
// past G are zeros and never stored); wgmma's 64-row minimum would waste
// most of it.  Each warp is a decoder of its own: it takes 16 cache rows
// of every block tile (64 rows with 4 warps up to D = 128; 32 with 2 at
// D = 256, where two more warps join only the merges), copies them into
// its own 3-stage ring with cp.async (rows past the length zero-filled),
// so two tiles are in flight while one is computed, and keeps its own
// (max, denom, acc[16 x D]) in registers:
// S = Q K^T from ldmatrix fragments of Q and K (exact bf16 products, f32
// sums), the online softmax on the score fragments in log2 units (exp2 by
// the SFU), P V with the score fragments as the A operand and V read
// transposed by ldmatrix.trans.  P goes in as bf16 hi + lo: one bf16
// rounding of P misses the 1e-4 + 2^-8 |want| bar against the f32 plain
// version by 2-19x (tests/test_torch_precision.py), two parts keep ~16
// bits of each probability.  Only __syncwarp orders a warp's copies and
// reads; the block meets at one barrier after the loop, where the warps'
// states merge through shared memory.  K/V rows are padded by 16 bytes so
// that ldmatrix reads them without bank conflicts.  ~110 KB of shared
// memory a block: two blocks share an SM at every (D, G).  The splits'
// merge reads G * D floats of every split: the last block first works out
// each split's weight per head, then reads the partials 16 bytes and
// eight splits at a time, and the wrapper cuts the cache at D = 256 (G =
// 10: 10 KB of partials a split) into 64-row splits, not 32.
//
// Softmax statistics (a sequence-sharded cache merges its shards'
// outputs with them): with a stats pointer, a second instantiation of each
// kernel (STATS) also writes each (row, head)'s largest score and the sum
// of exp(score - that max) over its keys, where the single split writes
// its output or the last block its merge; the kernels without them are
// the ones they were.
//
// f32 (the parity runs against the CPU): decode_kernel, the CUDA cores,
// from 64-row K/V tiles in shared memory (16-byte loads, one-word padding
// against bank conflicts), 128 threads.  Its shared memory grows with D
// and G (144 KB at D = 256, G = 10: one block per SM).
#include <type_traits>

#include "attention_tiles.cuh"
#include "mma_tiles.cuh"

// What a launch needs besides the tensors and the splits, filled once per
// launch plan by the wrapper (kernels/decode_attention/ops.py, _Static);
// outside the unnamed namespace, so that the C entry point keeps external
// linkage.
struct DecodePlan {
  int b, h, kv, d;
  long long st[10];  // element strides: q (b, h), k (b, h, s), v (b, h, s),
                     // o (b, h); the last dims are contiguous
  float scale;
  int window;  // <= 0: none
  float cap;   // <= 0: none
  int bf16;
  float* part;         // the splits' partials and
  unsigned* tickets;   // tickets, b * kv zeros between launches
  cudaStream_t stream;
};

namespace {

using repro_torch::NEG_INF;

constexpr int BK = 64;    // cache rows per tile (f32)
constexpr int NT = 128;   // threads (f32)

template <int D, int G>
constexpr size_t smem_bytes() {
  return sizeof(float) * (G * D + BK * (D + 1) + BK * D + G * (BK + 1) + 3 * G);
}

// G = H / KV is a template parameter so that each thread's share of the
// group (its scores and its output columns) is a register array of exact
// size, with no predicated work for heads it does not have.
template <typename T, int D, int G, bool STATS>
__global__ void __launch_bounds__(NT) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ lengths,
    T* __restrict__ o, int n_kv, int t_len, long long q_b,
    long long q_h, long long k_b, long long k_h, long long k_s, long long v_b,
    long long v_h, long long v_s, long long o_b, long long o_h, float scale,
    int window, float cap, int chunk, float* __restrict__ part,
    unsigned* __restrict__ tickets, float* __restrict__ stats) {
  constexpr int LK = D + 1;
  constexpr int LP = BK + 1;
  constexpr int SG = NT / BK;  // threads per cache row in the score phase
  // PV phase: DW threads own distinct output columns, each DC of them
  // (d, d + DW, ...); VG threads share a column, each some of the heads
  constexpr int DW = D < NT ? D : NT;
  constexpr int DC = D / DW;
  constexpr int VG = NT / DW;
  constexpr int HS = (G + SG - 1) / SG;  // heads per thread, score phase
  constexpr int HV = (G + VG - 1) / VG;  // heads per thread, PV phase
  extern __shared__ float smem[];
  float* Qs = smem;             // [G][D]
  float* Ks = Qs + G * D;       // [BK][LK]
  float* Vs = Ks + BK * LK;     // [BK][D]
  float* Ps = Vs + BK * D;      // [G][LP]
  float* m_s = Ps + G * LP;     // [G] running max
  float* l_s = m_s + G;         // [G] running denom
  float* a_s = l_s + G;         // [G] this tile's rescale factor
  __shared__ bool last_block;

  const int bh = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int bb = bh / n_kv, kvh = bh % n_kv;
  const int tid = threadIdx.x;
  const int len = min(lengths[bb], t_len);
  const int lo = window > 0 ? max(0, lengths[bb] - window) : 0;
  const int c_begin = max(lo, split * chunk);
  const int c_end = min(len, (split + 1) * chunk);

  const T* qb = q + bb * q_b + (kvh * G) * q_h;
  for (int i = tid; i < G * D; i += NT)
    Qs[i] = repro_torch::to_f32(qb[(i / D) * q_h + i % D]);
  for (int g = tid; g < G; g += NT) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  // PV phase: thread owns output columns d + c * DW of heads g0, g0 + VG,
  // ...
  const int d = tid % DW, g0 = tid / DW;
  float acc[HV][DC];
#pragma unroll
  for (int i = 0; i < HV; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const T* kb = k + bb * k_b + kvh * k_h;
  const T* vb = v + bb * v_b + kvh * v_h;
  for (int c0 = c_begin; c0 < c_end; c0 += BK) {
    __syncthreads();  // previous tile's readers are done; Qs visible
    const int nvalid = min(BK, c_end - c0);
    repro_torch::load_rows<T, D>(Ks, LK, kb + c0 * k_s, k_s, BK, nvalid);
    repro_torch::load_rows<T, D>(Vs, D, vb + c0 * v_s, v_s, BK, nvalid);
    __syncthreads();

    // scores: thread owns cache row j of heads gs, gs + SG, ...
    {
      const int j = tid % BK, gs = tid / BK;
      float sc[HS];
#pragma unroll
      for (int i = 0; i < HS; ++i) sc[i] = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < D; ++dd) {
        const float kv = Ks[j * LK + dd];
#pragma unroll
        for (int i = 0; i < HS; ++i)
          if (gs + i * SG < G)
            sc[i] = fmaf(Qs[(gs + i * SG) * D + dd], kv, sc[i]);
      }
#pragma unroll
      for (int i = 0; i < HS; ++i) {
        const int g = gs + i * SG;
        if (g < G)
          Ps[g * LP + j] =
              j < nvalid ? repro_torch::apply_softcap(sc[i] * scale, cap)
                         : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax per head: warp w takes heads w, w + 4, ...
    const int warp = tid / 32, lane = tid % 32;
    for (int g = warp; g < G; g += NT / 32) {
      const float s0 = Ps[g * LP + lane], s1 = Ps[g * LP + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      Ps[g * LP + lane] = p0;
      Ps[g * LP + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < HV; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c)
        if (g0 + i * VG < G) acc[i][c] *= a_s[g0 + i * VG];
#pragma unroll 4
    for (int j = 0; j < nvalid; ++j) {
      float w[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) w[c] = Vs[j * D + d + c * DW];
#pragma unroll
      for (int i = 0; i < HV; ++i) {
        const int g = g0 + i * VG;
        if (g < G)
#pragma unroll
          for (int c = 0; c < DC; ++c)
            acc[i][c] = fmaf(Ps[g * LP + j], w[c], acc[i][c]);
      }
    }
  }
  __syncthreads();  // m_s / l_s final (also when no tile ran)

  T* ob = o + bb * o_b + (kvh * G) * o_h;
  if (nsplit == 1) {
#pragma unroll
    for (int i = 0; i < HV; ++i) {
      const int g = g0 + i * VG;
      if (g < G)
#pragma unroll
        for (int c = 0; c < DC; ++c)
          ob[g * o_h + d + c * DW] =
              repro_torch::from_f32<T>(acc[i][c] / fmaxf(l_s[g], 1e-30f));
    }
    if constexpr (STATS)
      for (int g = tid; g < G; g += NT) {
        stats[bh * G + g] = m_s[g];
        stats[(gridDim.x + bh) * G + g] = l_s[g];
      }
    return;
  }

  // partials: part[((bh * nsplit + split) * G + g) * (D + 2) + {0: m, 1: l,
  // 2..: acc}]
  const size_t row = D + 2;
  float* mine = part + (static_cast<size_t>(bh) * nsplit + split) * G * row;
#pragma unroll
  for (int i = 0; i < HV; ++i) {
    const int g = g0 + i * VG;
    if (g < G)
#pragma unroll
      for (int c = 0; c < DC; ++c) mine[g * row + 2 + d + c * DW] = acc[i][c];
  }
  for (int g = tid; g < G; g += NT) {
    mine[g * row] = m_s[g];
    mine[g * row + 1] = l_s[g];
  }
  __threadfence();  // the partials are visible device-wide before the ticket
  __syncthreads();
  if (tid == 0)
    last_block = atomicAdd(&tickets[bh], 1u) ==
                 static_cast<unsigned>(nsplit - 1);
  __syncthreads();
  if (!last_block) return;
  if (tid == 0) tickets[bh] = 0u;  // ready for the next launch

  const float* all = part + static_cast<size_t>(bh) * nsplit * G * row;
#pragma unroll
  for (int i = 0; i < HV; ++i) {
    const int g = g0 + i * VG;
    if (g >= G) continue;
    float mx = NEG_INF;
    for (int sp = 0; sp < nsplit; ++sp)
      mx = fmaxf(mx, __ldcg(all + (sp * G + g) * row));
    float den = 0.f, num[DC];
#pragma unroll
    for (int c = 0; c < DC; ++c) num[c] = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const float* pg = all + (sp * G + g) * row;
      const float w = expf(__ldcg(pg) - mx);
      den = fmaf(__ldcg(pg + 1), w, den);
#pragma unroll
      for (int c = 0; c < DC; ++c)
        num[c] = fmaf(__ldcg(pg + 2 + d + c * DW), w, num[c]);
    }
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[g * o_h + d + c * DW] =
          repro_torch::from_f32<T>(num[c] / fmaxf(den, 1e-30f));
    if constexpr (STATS)
      if (d == 0) {
        stats[bh * G + g] = mx;
        stats[(gridDim.x + bh) * G + g] = den;
      }
  }
}



// ------------------------------------------------------ bf16, tensor cores

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;  // the statistics' max leaves
                                             // log2 units
constexpr int MMA_STAGES = 3;  // ring depth of each warp's K/V tiles

// the tile geometry of decode_kernel_mma at head dim D
template <int D>
struct Mma {
  static constexpr int NW = D > 128 ? 2 : 4;  // warps that walk the cache
  static constexpr int NT = 128;  // threads: at D = 256 two warps only merge
  static constexpr int LD = D + 8;             // padded row, bf16 elements
  static constexpr int TILE = 16 * LD;         // 16 rows of K or of V
  // Q, then each warp's ring of K/V stage pairs
  static constexpr size_t ring_bytes = 2ull * NW * MMA_STAGES * 2 * TILE;
  static constexpr size_t smem = 2ull * TILE + ring_bytes;
};

template <int D, int G, bool STATS>
__global__ void __launch_bounds__(Mma<D>::NT) decode_kernel_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ o, int n_kv, int t_len, long long q_b,
    long long q_h, long long k_b, long long k_h, long long k_s, long long v_b,
    long long v_h, long long v_s, long long o_b, long long o_h, float scale,
    int window, float cap, int chunk, float* __restrict__ part,
    unsigned* __restrict__ tickets, float* __restrict__ stats) {
  using repro_torch::cp_async16;
  using repro_torch::exp2_approx;
  using repro_torch::ldmatrix_x4;
  using repro_torch::ldmatrix_x4_trans;
  using repro_torch::mma_bf16;
  using bf16 = __nv_bfloat16;
  constexpr int NW = Mma<D>::NW, NT = Mma<D>::NT, LD = Mma<D>::LD;
  constexpr int TILE = Mma<D>::TILE;
  constexpr int BKT = 16 * NW;  // cache rows of a block tile
  constexpr int CH = D / 8;     // 16-byte pieces of a row
  static_assert(G <= 16, "the group's heads are the 16 rows of the mma");
  static_assert(sizeof(float) * NW * G * (D + 2) <= Mma<D>::ring_bytes,
                "the warps' states fit where their rings were");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [16][LD]
  bf16* ring = Qs + TILE;  // [NW][MMA_STAGES][K, V][16][LD]
  float* fbuf = reinterpret_cast<float*>(ring);  // the ring, reused after
  __shared__ bool last_block;

  const int bh = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int bb = bh / n_kv, kvh = bh % n_kv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = min(lengths[bb], t_len);
  const int lo = window > 0 ? max(0, lengths[bb] - window) : 0;
  const int c_begin = max(lo, split * chunk);
  const int c_end = min(len, (split + 1) * chunk);
  const int n_tiles = c_end > c_begin ? (c_end - c_begin + BKT - 1) / BKT : 0;

  // the group's query rows; rows G..15 zero
  const bf16* qb = q + bb * q_b + (kvh * G) * q_h;
  for (int i = tid; i < 16 * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    cp_async16(Qs + r * LD + c, qb + (r < G ? r : 0) * q_h + c, r < G);
  }
  repro_torch::cp_async_commit();

  // this warp's 16 rows of block tile `tile` into ring stage `stage`;
  // rows past c_end zero-filled, nothing copied when none is valid (nor
  // by a warp that only merges)
  const bool walks = warp < NW;
  bf16* wring = ring + (walks ? warp : 0) * MMA_STAGES * 2 * TILE;
  const bf16* kb = k + bb * k_b + kvh * k_h;
  const bf16* vb = v + bb * v_b + kvh * v_h;
  auto load = [&](int tile, int stage) {
    const int r0 = c_begin + tile * BKT + 16 * warp;
    if (!walks || tile >= n_tiles || r0 >= c_end) return;
    bf16* ks = wring + stage * 2 * TILE;
#pragma unroll
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = r0 + r < c_end;
      const long long row = ok ? r0 + r : r0;
      cp_async16(ks + r * LD + c, kb + row * k_s + c, ok);
      cp_async16(ks + TILE + r * LD + c, vb + row * v_s + c, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    load(s, s);
    repro_torch::cp_async_commit();
  }
  repro_torch::cp_async_wait<MMA_STAGES - 1>();  // this thread's Q pieces
  __syncthreads();                               // everyone's

  // fragments: g = lane / 4 is a head row (g and g + 8), t = lane % 4
  const int t4 = lane % 4;
  const float scale_log2 = scale * LOG2E;
  float acc[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  for (int i = 0; i < (walks ? n_tiles : 0); ++i) {
    load(i + MMA_STAGES - 1, (i + MMA_STAGES - 1) % MMA_STAGES);
    repro_torch::cp_async_commit();
    repro_torch::cp_async_wait<MMA_STAGES - 1>();  // tile i's copies
    __syncwarp();
    const int r0 = c_begin + i * BKT + 16 * warp;
    if (r0 < c_end) {
      const bf16* ks = wring + (i % MMA_STAGES) * 2 * TILE;
      const bf16* vs = ks + TILE;
      // S = Q K^T over D: sc[nb] holds rows r0 + 8 nb + 2 t4 (+1) of
      // heads g (e = 0, 1) and g + 8 (e = 2, 3)
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], b[4];
        ldmatrix_x4(a, Qs + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
        ldmatrix_x4(b, ks + ((lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                           ((lane / 8) % 2) * 8);
        mma_bf16(sc[0], a, b[0], b[1]);
        mma_bf16(sc[1], a, b[2], b[3]);
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x =
              cap > 0.f ? repro_torch::apply_softcap(sc[nb][e] * scale, cap) *
                              LOG2E
                        : sc[nb][e] * scale_log2;
          sc[nb][e] = r0 + 8 * nb + 2 * t4 + (e & 1) < c_end ? x : NEG_INF;
          mx[e / 2] = fmaxf(mx[e / 2], sc[nb][e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);  // finite: row r0 is valid
        alpha[r] = exp2_approx(m_r[r] - m_new);
        m_r[r] = m_new;
        l_r[r] *= alpha[r];
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nb][e] = exp2_approx(sc[nb][e] - m_r[e / 2]);
          l_r[e / 2] += sc[nb][e];
        }
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        acc[nb][0] *= alpha[0];
        acc[nb][1] *= alpha[0];
        acc[nb][2] *= alpha[1];
        acc[nb][3] *= alpha[1];
      }
      // P as the A operand of the 16-row k-step, in bf16 hi + lo
      uint32_t ph[4], pl[4];
      repro_torch::split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
      repro_torch::split_bf16(sc[0][2], sc[0][3], ph[1], pl[1]);
      repro_torch::split_bf16(sc[1][0], sc[1][1], ph[2], pl[2]);
      repro_torch::split_bf16(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
      for (int nb = 0; nb < D / 16; ++nb) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + (lane % 16) * LD + nb * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * nb], ph, b[0], b[1]);
        mma_bf16(acc[2 * nb + 1], ph, b[2], b[3]);
        mma_bf16(acc[2 * nb], pl, b[0], b[1]);
        mma_bf16(acc[2 * nb + 1], pl, b[2], b[3]);
      }
    }
    __syncwarp();  // the stage is read before it is filled again
  }
  repro_torch::cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  __syncthreads();  // every warp is done with its ring

  // each walking warp's state: fbuf[w][g][D] acc, then [w][g] (m, l)
  if (walks) {
    const int g = lane / 4;
    float* aw = fbuf + warp * G * D;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const int col = nb * 8 + 2 * t4;
      if (g < G)
        *reinterpret_cast<float2*>(aw + g * D + col) =
            make_float2(acc[nb][0], acc[nb][1]);
      if (g + 8 < G)
        *reinterpret_cast<float2*>(aw + (g + 8) * D + col) =
            make_float2(acc[nb][2], acc[nb][3]);
    }
    float* ml = fbuf + NW * G * D + warp * G * 2;
    if (t4 == 0) {
      if (g < G) {
        ml[2 * g] = m_r[0];
        ml[2 * g + 1] = l_r[0];
      }
      if (g + 8 < G) {
        ml[2 * (g + 8)] = m_r[1];
        ml[2 * (g + 8) + 1] = l_r[1];
      }
    }
  }
  __syncthreads();

  // merge the warps: four columns a thread; the block's state goes to the
  // output (one split) or to the workspace, where partial accumulators
  // lie [bh][split][g][D] and their (m, l) after all of them
  const float* mls = fbuf + NW * G * D;
  const size_t n_acc = static_cast<size_t>(gridDim.x) * nsplit * G * D;
  bf16* ob = o + bb * o_b + (kvh * G) * o_h;
  float* mine = part + (static_cast<size_t>(bh) * nsplit + split) * G * D;
  float* mine_ml =
      part + n_acc + (static_cast<size_t>(bh) * nsplit + split) * G * 2;
  for (int i = 4 * tid; i < G * D; i += 4 * NT) {
    const int g = i / D, d = i % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, mls[(w * G + g) * 2]);
    float den = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float wt = exp2_approx(mls[(w * G + g) * 2] - mx);
      const float4 a = *reinterpret_cast<const float4*>(fbuf + w * G * D + i);
      den = fmaf(mls[(w * G + g) * 2 + 1], wt, den);
      num.x = fmaf(a.x, wt, num.x);
      num.y = fmaf(a.y, wt, num.y);
      num.z = fmaf(a.z, wt, num.z);
      num.w = fmaf(a.w, wt, num.w);
    }
    if (nsplit == 1) {
      const float inv_den = 1.f / fmaxf(den, 1e-30f);
      __nv_bfloat162 lo2 = __floats2bfloat162_rn(num.x * inv_den,
                                                 num.y * inv_den);
      __nv_bfloat162 hi2 = __floats2bfloat162_rn(num.z * inv_den,
                                                 num.w * inv_den);
      uint2 st;
      st.x = *reinterpret_cast<uint32_t*>(&lo2);
      st.y = *reinterpret_cast<uint32_t*>(&hi2);
      *reinterpret_cast<uint2*>(ob + g * o_h + d) = st;
      if constexpr (STATS)
        if (d == 0) {
          stats[bh * G + g] = mx * LN2;
          stats[(gridDim.x + bh) * G + g] = den;
        }
    } else {
      *reinterpret_cast<float4*>(mine + i) = num;
      if (d == 0) {
        mine_ml[2 * g] = mx;
        mine_ml[2 * g + 1] = den;
      }
    }
  }
  if (nsplit == 1) return;

  __threadfence();  // the partials are visible device-wide before the ticket
  __syncthreads();
  if (tid == 0)
    last_block = atomicAdd(&tickets[bh], 1u) ==
                 static_cast<unsigned>(nsplit - 1);
  __syncthreads();
  if (!last_block) return;
  if (tid == 0) tickets[bh] = 0u;  // ready for the next launch

  // the last block: per head the splits' weights exp2(m - max) and the
  // denominator, one warp a head, then every column of every head
  const float* all = part + static_cast<size_t>(bh) * nsplit * G * D;
  const float* all_ml = part + n_acc + static_cast<size_t>(bh) * nsplit * G * 2;
  float* wts = fbuf;                // [G][nsplit]
  float* inv = fbuf + G * nsplit;   // [G]
  for (int g = warp; g < G; g += NW) {
    float mx = NEG_INF;
    for (int sp = lane; sp < nsplit; sp += 32)
      mx = fmaxf(mx, __ldcg(all_ml + (sp * G + g) * 2));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float den = 0.f;
    for (int sp = lane; sp < nsplit; sp += 32) {
      const float wt = exp2_approx(__ldcg(all_ml + (sp * G + g) * 2) - mx);
      wts[g * nsplit + sp] = wt;
      den = fmaf(__ldcg(all_ml + (sp * G + g) * 2 + 1), wt, den);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, off);
    if (lane == 0) {
      inv[g] = 1.f / fmaxf(den, 1e-30f);
      if constexpr (STATS) {
        stats[bh * G + g] = mx * LN2;
        stats[(gridDim.x + bh) * G + g] = den;
      }
    }
  }
  __syncthreads();
  for (int i = 4 * tid; i < G * D; i += 4 * NT) {
    const int g = i / D, d = i % D;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* pw = wts + g * nsplit;
#pragma unroll 8
    for (int sp = 0; sp < nsplit; ++sp) {
      const float4 a =
          __ldcg(reinterpret_cast<const float4*>(all + sp * G * D + i));
      num.x = fmaf(a.x, pw[sp], num.x);
      num.y = fmaf(a.y, pw[sp], num.y);
      num.z = fmaf(a.z, pw[sp], num.z);
      num.w = fmaf(a.w, pw[sp], num.w);
    }
    __nv_bfloat162 lo2 =
        __floats2bfloat162_rn(num.x * inv[g], num.y * inv[g]);
    __nv_bfloat162 hi2 =
        __floats2bfloat162_rn(num.z * inv[g], num.w * inv[g]);
    uint2 st;
    st.x = *reinterpret_cast<uint32_t*>(&lo2);
    st.y = *reinterpret_cast<uint32_t*>(&hi2);
    *reinterpret_cast<uint2*>(ob + g * o_h + d) = st;
  }
}

// Calls f(integral_constant<D>, integral_constant<G>) for the run-time
// (d, g), one of the pairs the kernel is compiled for: the head dims and
// groups (H / KV) of the repository's configs, full size and reduced,
// e.g. llama3-8b (128, 4), qwen2.5-3b (128, 8), recurrentgemma-2b
// (256, 10), gemma2-9b (256, 2), llava-next-34b (128, 7).
template <typename F>
int with_shape(int d, int g, F&& f) {
#define REPRO_DECODE_PAIR(D_, G_)                  \
  if (d == D_ && g == G_)                          \
    return f(std::integral_constant<int, D_>{},    \
             std::integral_constant<int, G_>{});
  REPRO_DECODE_PAIR(32, 1)
  REPRO_DECODE_PAIR(32, 2)
  REPRO_DECODE_PAIR(32, 4)
  REPRO_DECODE_PAIR(64, 1)
  REPRO_DECODE_PAIR(64, 2)
  REPRO_DECODE_PAIR(128, 1)
  REPRO_DECODE_PAIR(128, 4)
  REPRO_DECODE_PAIR(128, 7)
  REPRO_DECODE_PAIR(128, 8)
  REPRO_DECODE_PAIR(256, 2)
  REPRO_DECODE_PAIR(256, 10)
#undef REPRO_DECODE_PAIR
  return static_cast<int>(cudaErrorInvalidValue);
}

// The kernel of a dtype at (D, G), with or without the statistics (a
// template argument, so that the kernel without them is the one it was):
// its threads and dynamic shared memory; bf16 takes the tensor cores, f32
// the CUDA cores.
template <bool BF16, int D, int G, bool STATS>
struct Kernel;
template <int D, int G, bool STATS>
struct Kernel<false, D, G, STATS> {
  static const void* fn() {
    return reinterpret_cast<const void*>(decode_kernel<float, D, G, STATS>);
  }
  static constexpr int threads = NT;
  static constexpr size_t smem = smem_bytes<D, G>();
};
template <int D, int G, bool STATS>
struct Kernel<true, D, G, STATS> {
  static const void* fn() {
    return reinterpret_cast<const void*>(decode_kernel_mma<D, G, STATS>);
  }
  static constexpr int threads = Mma<D>::NT;
  static constexpr size_t smem = Mma<D>::smem;
};

// lets the kernel take its dynamic shared memory (above 48 KB), once
template <bool BF16, int D, int G, bool STATS>
cudaError_t allow_smem() {
  using K = Kernel<BF16, D, G, STATS>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      K::fn(), cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(K::smem));
  return attr;
}

struct Args {
  const void *q, *k, *v;
  const int* lengths;
  void* o;
  int t, nsplit, chunk;
  const DecodePlan* p;
  float* stats;
};

template <bool BF16, bool STATS>
int launch(int d, int g, const Args& a) {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  return with_shape(d, g, [&](auto dc, auto gc) {
    constexpr int D = decltype(dc)::value, G = decltype(gc)::value;
    using K = Kernel<BF16, D, G, STATS>;
    // the bf16 kernel's last block keeps each split's weight a head where
    // the warps' rings were
    if (BF16 && sizeof(float) * G * (a.nsplit + 1) > Mma<D>::ring_bytes)
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t attr = allow_smem<BF16, D, G, STATS>();
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const DecodePlan& p = *a.p;
    const long long* st = p.st;
    const dim3 grid(p.b * p.kv, a.nsplit);
    if constexpr (BF16)
      decode_kernel_mma<D, G, STATS><<<grid, K::threads, K::smem,
                                       p.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), a.lengths, static_cast<T*>(a.o), p.kv,
          a.t, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
          st[9], p.scale, p.window, p.cap, a.chunk, p.part, p.tickets,
          a.stats);
    else
      decode_kernel<T, D, G, STATS><<<grid, K::threads, K::smem,
                                      p.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), a.lengths, static_cast<T*>(a.o), p.kv,
          a.t, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
          st[9], p.scale, p.window, p.cap, a.chunk, p.part, p.tickets,
          a.stats);
    return static_cast<int>(cudaGetLastError());
  });
}

template <bool BF16>
int blocks_per_sm(int d, int g, int* blocks) {
  return with_shape(d, g, [&](auto dc, auto gc) {
    constexpr int D = decltype(dc)::value, G = decltype(gc)::value;
    using K = Kernel<BF16, D, G, false>;
    cudaError_t err = allow_smem<BF16, D, G, false>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, K::fn(), K::threads, K::smem);
    return static_cast<int>(err);
  });
}

}  // namespace

// q [b, h, d], k and v [b, kv, t, d], lengths [b] int32, o [b, h, d] on
// the device, in f32 (p->bf16 == 0) or bf16 (p->bf16 == 1), (d, h / kv)
// one of with_shape's pairs; rows are 16-byte aligned.  The cache's t
// rows are cut into nsplit pieces of `chunk` rows; with nsplit > 1,
// p->part holds b * kv * nsplit * (h / kv) * (d + 2) floats.  stats, when
// not null, gets each (row, head)'s softmax statistics over its keys, f32
// [2][b][h]: the largest scaled (and softcapped) score, then the sum of
// exp(score - that max); a row with no key gets -1e30 and 0.  Launches on
// p->stream and returns cudaGetLastError() (0 = launched).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* lengths, void* o, int t,
                                int nsplit, int chunk, const DecodePlan* p,
                                float* stats) {
  if (p->h % p->kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, lengths, o, t, nsplit, chunk, p, stats};
  const int g = p->h / p->kv;
  if (stats)
    return p->bf16 ? launch<true, true>(p->d, g, a)
                   : launch<false, true>(p->d, g, a);
  return p->bf16 ? launch<true, false>(p->d, g, a)
                 : launch<false, false>(p->d, g, a);
}

// *blocks: how many blocks of the kernel at head dim d and group g fit on
// one SM of the current device at once (its shared memory and registers
// allow), for the wrapper's split sizing.  Returns the CUDA error (0 = ok).
extern "C" int decode_attention_blocks_per_sm(int d, int g, int bf16,
                                              int* blocks) {
  return bf16 ? blocks_per_sm<true>(d, g, blocks)
              : blocks_per_sm<false>(d, g, blocks);
}
