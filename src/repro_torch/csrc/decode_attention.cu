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
// against bank conflicts).
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
  constexpr int VG = NT / D;   // threads per output column in the PV phase
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
  // PV phase: thread owns output column d of heads g0, g0 + VG, ...
  const int d = tid % D, g0 = tid / D;
  float acc[HV];
#pragma unroll
  for (int i = 0; i < HV; ++i) acc[i] = 0.f;

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
      if (g0 + i * VG < G) acc[i] *= a_s[g0 + i * VG];
#pragma unroll 4
    for (int j = 0; j < nvalid; ++j) {
      const float w = Vs[j * D + d];
#pragma unroll
      for (int i = 0; i < HV; ++i) {
        const int g = g0 + i * VG;
        if (g < G) acc[i] = fmaf(Ps[g * LP + j], w, acc[i]);
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
        ob[g * o_h + d] =
            repro_torch::from_f32<T>(acc[i] / fmaxf(l_s[g], 1e-30f));
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
    if (g < G) mine[g * row + 2 + d] = acc[i];
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
    float den = 0.f, num = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const float* pg = all + (sp * G + g) * row;
      const float w = expf(__ldcg(pg) - mx);
      den = fmaf(__ldcg(pg + 1), w, den);
      num = fmaf(__ldcg(pg + 2 + d), w, num);
    }
    ob[g * o_h + d] = repro_torch::from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* o, int b, int kv, int t, const long long* st, float scale,
           int window, float cap, int nsplit, int chunk, float* part,
           unsigned* tickets, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, G>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_kernel<T, D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(b * kv, nsplit);
  decode_kernel<T, D, G><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), kv, t, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], scale,
      window, cap, chunk, part, tickets);
  return static_cast<int>(cudaGetLastError());
}

#define DECODE_ARGS \
  q, k, v, lengths, o, b, kv, t, st, scale, window, cap, nsplit, chunk, part, \
      tickets, stream

template <typename T, int D>
int dispatch_group(int g, const void* q, const void* k, const void* v,
                   const int* lengths, void* o, int b, int kv, int t,
                   const long long* st, float scale, int window, float cap,
                   int nsplit, int chunk, float* part, unsigned* tickets,
                   cudaStream_t stream) {
  switch (g) {
    case 1: return launch<T, D, 1>(DECODE_ARGS);
    case 2: return launch<T, D, 2>(DECODE_ARGS);
    case 4: return launch<T, D, 4>(DECODE_ARGS);
    case 8: return launch<T, D, 8>(DECODE_ARGS);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(int d, int g, const void* q, const void* k, const void* v,
             const int* lengths, void* o, int b, int kv, int t,
             const long long* st, float scale, int window, float cap,
             int nsplit, int chunk, float* part, unsigned* tickets,
             cudaStream_t stream) {
  switch (d) {
    case 32: return dispatch_group<T, 32>(g, DECODE_ARGS);
    case 64: return dispatch_group<T, 64>(g, DECODE_ARGS);
    case 128: return dispatch_group<T, 128>(g, DECODE_ARGS);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [b, h, d], k and v [b, kv, t, d] (h / kv in {1, 2, 4, 8}), lengths
// [b] int32, o [b, h, d] on the device, in f32 (bf16 == 0) or bf16
// (bf16 == 1).  st[10] holds the element strides of q (b, h), k (b, h, s),
// v (b, h, s) and o (b, h); the last dim is contiguous and rows are 16-byte
// aligned.  The cache is cut into nsplit pieces of `chunk` rows; with
// nsplit > 1, part holds b * kv * nsplit * (h / kv) * (d + 2) floats and
// tickets b * kv zeros, which the launch leaves at zero.  window <= 0:
// none; cap <= 0: none.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* lengths, void* o, int b, int h,
                                int kv, int t, int d, const long long* st,
                                float scale, int window, float cap,
                                int nsplit, int chunk, float* part,
                                unsigned* tickets, int bf16, void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (h % kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return dispatch<__nv_bfloat16>(d, h / kv, q, k, v, lengths, o, b, kv, t,
                                   st, scale, window, cap, nsplit, chunk,
                                   part, tickets, cs);
  return dispatch<float>(d, h / kv, q, k, v, lengths, o, b, kv, t, st, scale,
                         window, cap, nsplit, chunk, part, tickets, cs);
}
