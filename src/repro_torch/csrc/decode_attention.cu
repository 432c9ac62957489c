// Flash decode: one query token per row against its KV cache, GQA, per-row
// lengths, optional sliding window and tanh softcap.
//
// Replaces the TPU kernel
// repro/kernels/decode_attention/decode_attention.py::decode_attention
// (_decode_kernel), whose grid ran (batch, q head, K block) with the
// K-block axis in order, the online-softmax state in VMEM and the blocks
// past the length skipped.  Here one thread block owns one (batch, KV
// head, split of the cache) and serves all H / KV query heads of the
// group, so each K/V row is read from device memory once per group, not
// once per query head.  It walks only the valid columns [lo, len) of its
// split, where lo = len - window when windowed, so it reads nothing past
// lengths[b]; any T is allowed.
//
// Bound on the H100: bytes.  Each valid cache position costs
// 2 * D * sizeof(T) bytes of K/V for 4 * D * G flops (G = H / KV), far
// below the card's 295 flops per byte.  Reading the cache fast needs many
// loads in flight, and B * KV blocks (64 for llama3-8b at batch 8) cannot
// fill 132 SMs, so the cache is split along T into gridDim.y pieces: each
// block leaves its partial (max, denom, acc) in a workspace and the last
// block of its (batch, KV head) to finish merges them, found with a
// threadfence and an atomic ticket (CUDA's threadFenceReduction sample),
// and which sets the ticket back to 0, so the workspace is allocated once.
// One launch, no second kernel.  The arithmetic is f32 on the CUDA cores,
// from 64-row K/V tiles in shared memory (16-byte loads, one-word padding
// against bank conflicts).  The shared memory grows with D and G (144 KB at
// D = 256, G = 10: one block per SM), so the wrapper sizes the splits from
// the blocks per SM that decode_attention_blocks_per_sm reports for the
// (D, G) at hand.
#include <type_traits>

#include "attention_tiles.cuh"

namespace {

using repro_torch::NEG_INF;

constexpr int BK = 64;    // cache rows per tile
constexpr int NT = 128;   // threads

template <int D, int G>
constexpr size_t smem_bytes() {
  return sizeof(float) * (G * D + BK * (D + 1) + BK * D + G * (BK + 1) + 3 * G);
}

// G = H / KV is a template parameter so that each thread's share of the
// group (its scores and its output columns) is a register array of exact
// size, with no predicated work for heads it does not have.
template <typename T, int D, int G>
__global__ void __launch_bounds__(NT) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ lengths,
    T* __restrict__ o, int n_kv, int t_len, long long q_b,
    long long q_h, long long k_b, long long k_h, long long k_s, long long v_b,
    long long v_h, long long v_s, long long o_b, long long o_h, float scale,
    int window, float cap, int chunk, float* __restrict__ part,
    unsigned* __restrict__ tickets) {
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

// lets the kernel take its dynamic shared memory (above 48 KB), once
template <typename T, int D, int G>
cudaError_t allow_smem() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_kernel<T, D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<D, G>()));
  return attr;
}

struct Args {
  const void *q, *k, *v;
  const int* lengths;
  void* o;
  int b, kv, t;
  const long long* st;
  float scale;
  int window;
  float cap;
  int nsplit, chunk;
  float* part;
  unsigned* tickets;
  cudaStream_t stream;
};

template <typename T>
int launch(int d, int g, const Args& a) {
  return with_shape(d, g, [&](auto dc, auto gc) {
    constexpr int D = decltype(dc)::value, G = decltype(gc)::value;
    const cudaError_t attr = allow_smem<T, D, G>();
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const long long* st = a.st;
    decode_kernel<T, D, G>
        <<<dim3(a.b * a.kv, a.nsplit), NT, smem_bytes<D, G>(), a.stream>>>(
            static_cast<const T*>(a.q), static_cast<const T*>(a.k),
            static_cast<const T*>(a.v), a.lengths, static_cast<T*>(a.o),
            a.kv, a.t, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
            st[7], st[8], st[9], a.scale, a.window, a.cap, a.chunk, a.part,
            a.tickets);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int blocks_per_sm(int d, int g, int* blocks) {
  return with_shape(d, g, [&](auto dc, auto gc) {
    constexpr int D = decltype(dc)::value, G = decltype(gc)::value;
    cudaError_t err = allow_smem<T, D, G>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, decode_kernel<T, D, G>, NT, smem_bytes<D, G>());
    return static_cast<int>(err);
  });
}

}  // namespace

// q [b, h, d], k and v [b, kv, t, d], lengths [b] int32, o [b, h, d] on
// the device, in f32 (bf16 == 0) or bf16 (bf16 == 1), (d, h / kv) one of
// with_shape's pairs.  st[10] holds the element strides of q (b, h), k (b,
// h, s), v (b, h, s) and o (b, h); the last dim is contiguous and rows are
// 16-byte aligned.  The cache is cut into nsplit pieces of `chunk` rows;
// with nsplit > 1, part holds b * kv * nsplit * (h / kv) * (d + 2) floats
// and tickets b * kv zeros, which the launch leaves at zero.  window <= 0:
// none; cap <= 0: none.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* lengths, void* o, int b, int h,
                                int kv, int t, int d, const long long* st,
                                float scale, int window, float cap,
                                int nsplit, int chunk, float* part,
                                unsigned* tickets, int bf16, void* stream) {
  if (h % kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,     k,      v,     lengths, o,    b,       kv,
               t,     st,     scale, window,  cap,  nsplit,  chunk,
               part,  tickets, static_cast<cudaStream_t>(stream)};
  return bf16 ? launch<__nv_bfloat16>(d, h / kv, a)
              : launch<float>(d, h / kv, a);
}

// *blocks: how many blocks of the kernel at head dim d and group g fit on
// one SM of the current device at once (its shared memory and registers
// allow), for the wrapper's split sizing.  Returns the CUDA error (0 = ok).
extern "C" int decode_attention_blocks_per_sm(int d, int g, int bf16,
                                              int* blocks) {
  return bf16 ? blocks_per_sm<__nv_bfloat16>(d, g, blocks)
              : blocks_per_sm<float>(d, g, blocks);
}
