// Paged decode attention for Hopper (sm_90a): one new token per sequence
// over a BaM-paged KV pool, the decode hot path of every global layer.
//
// Replaces: paged_attention_pallas in src/repro/kernels/paged_attention.py
// (body _paged_kernel).  The TPU kernel walks a (batch, kv_head, page) grid
// with the page axis sequential, scalar-prefetches the page table so each
// step's BlockSpec DMAs the right physical page, and keeps the online
// softmax state (m, l, acc) of the G query heads in VMEM scratch.
//
// Bound: bytes.  Each live K and V position is read once (Hkv * D elements
// per position and side), plus q and the output; the arithmetic is
// 4 * G * D flops per position, far below the card's ops:byte balance.  So
// the design is about keeping enough loads in flight on all 132 SMs.
//
// Design: split-KV flash-decoding in two kernels on one stream, after the
// JAX package's shard-local flash-decode (_paged_attention_flash_decode in
// src/repro/models/transformer.py), with the split by logical position.
// * paged_partial_kernel: one CTA per (kv head, sequence, chunk of
//   PA_CH = 128 logical positions), so a sequence of 1280 positions runs
//   on ten CTAs per head rather than one.  The CTA streams its chunk's K
//   rows, then its V rows, in tiles of PA_TP positions through a
//   PA_STAGES-slot shared-memory ring with 16-byte cp.async copies, kept in
//   the pool's dtype (no f32 staging): PA_STAGES - 1 tiles are in flight
//   while one is computed.  The CTA reads its page_table entries once into
//   a table of row offsets (this takes the place of scalar prefetch); holes
//   (-1) are never read: their rows are zero-filled by cp.async's source
//   size 0 and masked.  Scores: PA_SPLIT threads per position, each a
//   share of the head dim, all G heads against one K load, reduced with
//   shuffles; the G x 128 scores go to shared memory, one softmax per head
//   over the chunk (log2 domain) gives (m, l), and p @ V accumulates in f32
//   registers, each thread owning four head-dim columns of every head over
//   a fixed subset of the positions.  The per-head loops unroll to a
//   compile-time bound GB >= G (2, 4, 5, 8, 16).  The CTA writes its
//   partial (m, l, acc[G][D]) to an f32 workspace; a chunk with no live
//   position writes m = ATTN_NEG_INF, l = 0 and acc = 0.  Chunks at or past
//   seq_lens write nothing.
// * paged_combine_kernel: one CTA per (query head, sequence) combines the
//   live chunks in logical order: M = max m_i, l = sum l_i 2^(m_i - M),
//   acc = sum acc_i 2^(m_i - M), out = acc / max(l, 1e-30).  Every weight
//   is finite (ATTN_NEG_INF is finite), so an empty chunk adds 0, never
//   NaN, and a row with no live key writes 0, as the reference.  With a
//   non-null lse it also writes each row's log-sum-exp of the scaled
//   scores, (M + log2 l) ln 2, or -inf for a row with no live key, so that
//   partial results over disjoint sets of pages (the shard-local
//   flash-decoding of models/transformer.py) combine exactly: weight each
//   by exp(lse - max lse), which is 0 for a shard with no live key.
// Every sum runs in a fixed order over logical positions and no atomic
// decides one, so the result does not depend on which physical page holds
// a logical page, and two runs agree bit for bit.
#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int PA_THREADS = 256;
constexpr int PA_CH = 128;                    // logical positions per chunk
constexpr int PA_TP = 64;                     // positions per ring slot
constexpr int PA_STAGES = 2;                  // ring slots
constexpr int PA_GMAX = 16;                   // query heads per kv head
constexpr int PA_DMAX = 256;                  // head dim
constexpr int PA_SPLIT = PA_THREADS / PA_TP;   // score threads per position
static_assert(PA_SPLIT * PA_TP == PA_THREADS && (PA_SPLIT & (PA_SPLIT - 1)) == 0,
              "a power-of-two number of score threads per position");

// GB >= G query heads per kv head (2, 4, 5, 8 or 16): the per-head loops
// unroll to GB with the heads past G predicated off.
template <typename T, int GB>
__global__ void __launch_bounds__(PA_THREADS) paged_partial_kernel(
    const T* __restrict__ q,                 // (B, Hq, D)
    const T* __restrict__ k_pages,           // (B, P, page, Hkv, D)
    const T* __restrict__ v_pages,           // (B, P, page, Hkv, D)
    const int32_t* __restrict__ page_table,  // (B, NP), -1 = hole
    const int32_t* __restrict__ seq_lens,    // (B,)
    int P, int page, int Hkv, int D, int G, int NP, int NC,
    float scale_log2, int ring_bytes,
    float* __restrict__ m_ws,                // (B, Hq, NC)
    float* __restrict__ l_ws,                // (B, Hq, NC)
    float* __restrict__ acc_ws) {            // (B, Hq, NC, D)
  const int h = blockIdx.x, b = blockIdx.y, c = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Hq = Hkv * G;
  const int c0 = c * PA_CH;

  extern __shared__ __align__(16) uint8_t smem[];
  const int row_bytes = D * (int)sizeof(T) + 16;   // padded rows
  uint8_t* ring = smem;
  float* q_s = reinterpret_cast<float*>(smem + ring_bytes);   // G x D
  float* p_s = q_s + G * D;                        // G x PA_CH
  __shared__ long long off_s[PA_CH];   // each position's row, -1 at a hole
  __shared__ float m_s[PA_GMAX], l_s[PA_GMAX];

  // the length, this chunk's page-table entries and q are loaded together
  // (none waits for another): the page table is read once per CTA
  constexpr int PER_T = (PA_CH + PA_THREADS - 1) / PA_THREADS;
  const int S = NP * page;
  int phys[PER_T];
#pragma unroll
  for (int k = 0; k < PER_T; ++k) {
    const int pos = c0 + tid + k * PA_THREADS;
    phys[k] = tid + k * PA_THREADS < PA_CH && pos < S
                  ? page_table[(int64_t)b * NP + pos / page] : -1;
  }
  const T* qb = q + ((int64_t)b * Hq + (int64_t)h * G) * D;
  for (int i = tid; i < G * D / 8; i += PA_THREADS) {
    float x[8];
    load8(qb + 8 * i, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) q_s[8 * i + e] = x[e];
  }
  const int len = min(seq_lens[b], S);
  if (c0 >= len) return;                     // the combine reads c0 < len only
  const int n = min(PA_CH, len - c0);        // positions of this chunk
  const int n_tiles = (n + PA_TP - 1) / PA_TP;
  const int items = 2 * n_tiles;             // K tiles, then V tiles
  const int cpr = D * (int)sizeof(T) / 16;   // 16-byte copies per row
#pragma unroll
  for (int k = 0; k < PER_T; ++k) {
    const int t = tid + k * PA_THREADS, pos = c0 + t;
    if (t < n)
      off_s[t] = phys[k] < 0 ? -1 : ((((int64_t)b * P + phys[k]) * page +
                                      pos % page) * Hkv + h) * (int64_t)D;
  }
  __syncthreads();

  auto issue = [&](int i) {
    if (i < items) {
      const T* src = i < n_tiles ? k_pages : v_pages;
      const int t0 = (i % n_tiles) * PA_TP;
      const int rows = min(PA_TP, n - t0);
      uint8_t* dst = ring + (i % PA_STAGES) * PA_TP * row_bytes;
      for (int ci = tid; ci < rows * cpr; ci += PA_THREADS) {
        const int t = ci / cpr, j = ci % cpr;
        const long long off = off_s[t0 + t];
        cp_async16(dst + t * row_bytes + j * 16,
                   reinterpret_cast<const uint8_t*>(src + max(off, 0ll)) + j * 16,
                   off >= 0 ? 16 : 0);
      }
    }
    cp_async_commit();               // every thread counts the same groups
  };
#pragma unroll
  for (int i = 0; i < PA_STAGES - 1; ++i) issue(i);

  // scores: PA_SPLIT threads per position, each a share of the head dim
  // (the 8-element groups qd, qd + PA_SPLIT, ...), all G heads against one
  // K load
  const int ts = tid / PA_SPLIT, qd = tid % PA_SPLIT;
  // p @ V: thread owns columns 4 cq .. 4 cq + 3 and positions part,
  // part + nsplit, ... of each tile
  const int quads = D / 4, nsplit = PA_THREADS / quads;
  const int cq = tid % quads, part = tid / quads;
  float acc[GB][4];
#pragma unroll
  for (int g = 0; g < GB; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;

  for (int i = 0; i < items; ++i) {
    issue(i + PA_STAGES - 1);
    cp_async_wait<PA_STAGES - 1>();
    __syncthreads();                 // item i visible to all
    const uint8_t* tile = ring + (i % PA_STAGES) * PA_TP * row_bytes;
    if (i < n_tiles) {
      const int t0 = i * PA_TP, rows = min(PA_TP, n - t0);
      float sc[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) sc[g] = 0.f;
      if (ts < rows) {
        const T* kr = reinterpret_cast<const T*>(tile + ts * row_bytes);
#pragma unroll 4
        for (int grp = qd; grp < D / 8; grp += PA_SPLIT) {
          float k8[8];
          load8(kr + grp * 8, k8);
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            if (g < G) {
              const float4 qa = *reinterpret_cast<const float4*>(q_s + g * D + grp * 8);
              const float4 qc = *reinterpret_cast<const float4*>(q_s + g * D + grp * 8 + 4);
              sc[g] += ((qa.x * k8[0] + qa.y * k8[1]) + (qa.z * k8[2] + qa.w * k8[3])) +
                       ((qc.x * k8[4] + qc.y * k8[5]) + (qc.z * k8[6] + qc.w * k8[7]));
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int o = 1; o < PA_SPLIT; o <<= 1)
          sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], o);
      if (qd == 0 && ts < rows) {
        const bool live = off_s[t0 + ts] >= 0;
#pragma unroll
        for (int g = 0; g < GB; ++g)
          if (g < G) p_s[g * PA_CH + t0 + ts] = live ? sc[g] * scale_log2 : -INFINITY;
      }
      if (i == n_tiles - 1) {
        __syncthreads();
        // softmax over the chunk, one warp per head (log2 domain)
        for (int g = warp; g < G; g += PA_THREADS / 32) {
          float* pr = p_s + g * PA_CH;
          float mx = ATTN_NEG_INF;
          for (int t = lane; t < n; t += 32) mx = fmaxf(mx, pr[t]);
          mx = warp_max(mx);
          float sum = 0.f;
          for (int t = lane; t < n; t += 32) {
            const float p = exp2f(pr[t] - mx);   // exp2(-inf) = 0 at a hole
            pr[t] = p;
            sum += p;
          }
          sum = warp_sum(sum);
          if (lane == 0) {
            m_s[g] = mx;
            l_s[g] = sum;
          }
        }
      }
    } else if (part < nsplit) {
      const int t0 = (i - n_tiles) * PA_TP, rows = min(PA_TP, n - t0);
#pragma unroll 4
      for (int t = part; t < rows; t += nsplit) {
        float v4[4];
        load4(reinterpret_cast<const T*>(tile + t * row_bytes) + 4 * cq, v4);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g < G) {
            const float p = p_s[g * PA_CH + t0 + t];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][e] += p * v4[e];
          }
        }
      }
    }
    __syncthreads();                 // the slot may be refilled next
  }

  // sum the nsplit position subsets in a fixed order, through the ring
  float* red = reinterpret_cast<float*>(ring);     // nsplit x G x D
  if (part < nsplit) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
      if (g < G)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[(part * G + g) * D + 4 * cq + e] = acc[g][e];
  }
  __syncthreads();
  const int64_t row0 = (int64_t)b * Hq + (int64_t)h * G;
  for (int i = tid; i < G * D; i += PA_THREADS) {
    const int g = i / D, d = i % D;
    float a = 0.f;
    for (int s = 0; s < nsplit; ++s) a += red[(s * G + g) * D + d];
    acc_ws[((row0 + g) * NC + c) * D + d] = a;
  }
  if (tid < G) {
    m_ws[(row0 + tid) * NC + c] = m_s[tid];
    l_ws[(row0 + tid) * NC + c] = l_s[tid];
  }
}

template <typename T>
__global__ void __launch_bounds__(PA_THREADS) paged_combine_kernel(
    const float* __restrict__ m_ws, const float* __restrict__ l_ws,
    const float* __restrict__ acc_ws, const int32_t* __restrict__ seq_lens,
    int Hq, int D, int NP, int page, int NC, T* __restrict__ out,
    float* __restrict__ lse) {
  const int hq = blockIdx.x, b = blockIdx.y;
  const int len = min(seq_lens[b], NP * page);
  const int nc = len > 0 ? min(NC, (len + PA_CH - 1) / PA_CH) : 0;
  const int64_t row = (int64_t)b * Hq + hq;
  const float* m = m_ws + row * NC;
  const float* l = l_ws + row * NC;
  // the loops over chunks unroll so that their loads are in flight together
  float M = ATTN_NEG_INF;
#pragma unroll 8
  for (int c = 0; c < nc; ++c) M = fmaxf(M, m[c]);
  float lsum = 0.f;
#pragma unroll 8
  for (int c = 0; c < nc; ++c) lsum += l[c] * exp2f(m[c] - M);
  const float denom = fmaxf(lsum, 1e-30f);
  if (lse != nullptr && threadIdx.x == 0)
    lse[row] = lsum > 0.f ? (M + log2f(lsum)) * 0.6931471805599453f : -INFINITY;
  for (int d = threadIdx.x; d < D; d += PA_THREADS) {
    float a = 0.f;
#pragma unroll 8
    for (int c = 0; c < nc; ++c)
      a += acc_ws[(row * NC + c) * D + d] * exp2f(m[c] - M);
    out[row * D + d] = from_f32<T>(a / denom);
  }
}

template <typename T, int GB>
int launch_g(const void* q, const void* kp, const void* vp, const void* pt,
             const void* sl, int B, int P, int page, int Hkv, int D, int G,
             int NP, float scale, float* m_ws, float* l_ws, float* acc_ws,
             void* out, float* lse, cudaStream_t st) {
  const int NC = (NP * page + PA_CH - 1) / PA_CH;
  const int nsplit = PA_THREADS / (D / 4);
  const int ring_bytes = max(PA_STAGES * PA_TP * (D * (int)sizeof(T) + 16),
                             nsplit * G * D * (int)sizeof(float));
  const int smem = ring_bytes + (int)sizeof(float) * (G * D + G * PA_CH);
  cudaError_t e = cudaFuncSetAttribute(
      paged_partial_kernel<T, GB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (NC > 0) {
    paged_partial_kernel<T, GB><<<dim3(Hkv, B, NC), PA_THREADS, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), static_cast<const int32_t*>(pt),
        static_cast<const int32_t*>(sl), P, page, Hkv, D, G, NP, NC,
        scale * 1.4426950408889634f, ring_bytes, m_ws, l_ws, acc_ws);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  paged_combine_kernel<T><<<dim3(Hkv * G, B), PA_THREADS, 0, st>>>(
      m_ws, l_ws, acc_ws, static_cast<const int32_t*>(sl), Hkv * G, D, NP,
      page, NC, static_cast<T*>(out), lse);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* pt,
           const void* sl, int B, int P, int page, int Hkv, int D, int G,
           int NP, float scale, float* m_ws, float* l_ws, float* acc_ws,
           void* out, float* lse, cudaStream_t st) {
#define PA_LAUNCH(GB)                                                      \
  return launch_g<T, GB>(q, kp, vp, pt, sl, B, P, page, Hkv, D, G, NP,     \
                         scale, m_ws, l_ws, acc_ws, out, lse, st)
  if (G <= 2) PA_LAUNCH(2);
  if (G <= 4) PA_LAUNCH(4);
  if (G <= 5) PA_LAUNCH(5);
  if (G <= 8) PA_LAUNCH(8);
  PA_LAUNCH(16);
#undef PA_LAUNCH
}

}  // namespace

// Floats of the f32 workspace that paged_attention_launch needs: m and l
// (B, Hq, NC) each, then acc (B, Hq, NC, D), with NC = ceil(NP * page /
// PA_CH).  The combine reads only chunks below seq_lens, which the partial
// kernel always writes, so the workspace needs no clearing.
extern "C" int64_t paged_attention_workspace_floats(int B, int Hq, int NP,
                                                    int page, int D) {
  const int64_t nc = ((int64_t)NP * page + PA_CH - 1) / PA_CH;
  return (int64_t)B * Hq * nc * (D + 2);
}

// D must be a multiple of 8 and at most 256, G at most 16, every tensor
// 16-byte aligned, and ws a workspace of paged_attention_workspace_floats
// floats.  is_bf16 selects bf16 over f32.  lse, when not null, receives
// the (B, Hq) f32 log-sum-exp of each row.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table,
                                      const void* seq_lens, int B, int P,
                                      int page, int Hkv, int D, int G, int NP,
                                      float scale, int is_bf16, void* ws,
                                      void* out, void* lse, void* stream) {
  if (D % 8 != 0 || D > PA_DMAX || G > PA_GMAX || G < 1 || page < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hkv == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t rows = (int64_t)B * Hkv * G * ((NP * page + PA_CH - 1) / PA_CH);
  float* m = static_cast<float*>(ws);
  float* l = m + rows;
  float* a = l + rows;
  float* lse_f = static_cast<float*>(lse);
  return is_bf16 ? launch<__nv_bfloat16>(q, k_pages, v_pages, page_table,
                                         seq_lens, B, P, page, Hkv, D, G, NP,
                                         scale, m, l, a, out, lse_f, st)
                 : launch<float>(q, k_pages, v_pages, page_table, seq_lens, B,
                                 P, page, Hkv, D, G, NP, scale, m, l, a, out,
                                 lse_f, st);
}
