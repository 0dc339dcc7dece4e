// Paged decode attention for Hopper (sm_90a): one new token per sequence
// over a BaM-paged KV pool, the decode hot path of every global layer.
//
// Replaces: paged_attention_pallas in src/repro/kernels/paged_attention.py
// (body _paged_kernel).  The TPU kernel walks a (batch, kv_head, page) grid
// with the page axis sequential, scalar-prefetches the page table so each
// step's BlockSpec DMAs the right physical page, and keeps the online
// softmax state (m, l, acc) of the G query heads in VMEM scratch.
//
// Bound: bytes.  Each live K and V position is read once (page * Hkv * D
// elements per page and side), plus q and the output; the arithmetic is
// 4 * G * D flops per position, far below the card's ops:byte balance.
// Design: one block per (b, kv_head).  The block holds its G query rows in
// shared memory as f32 and loops over the logical pages in order, reading
// page_table[b, i] itself (this takes the place of scalar prefetch).  Holes
// (-1) and positions >= seq_lens[b] are never read -- the TPU kernel still
// DMAs page max(pt, 0) and masks it.  Each page is processed in tiles of
// TP positions: the block stages the tile's K and V rows in shared memory
// with 16-byte loads (all threads, many loads in flight), computes the
// G x TP scores from shared memory, updates (m, l) per query row with one
// warp per row, and folds p @ V into f32 accumulators that each thread
// keeps for its head-dim columns.  Pages are reduced in logical order, so
// a page's physical slot cannot change the result.  A row with no live key
// ends with l = 0 and writes 0 (acc / max(l, 1e-30)), as the reference.
#include "common.cuh"

namespace {

constexpr int PA_THREADS = 256;
constexpr int PA_TP = 64;                     // positions per tile
constexpr int PA_GMAX = 16;                   // query heads per kv head
constexpr int PA_DMAX = 256;                  // head dim
constexpr int PA_DPT = (PA_DMAX + PA_THREADS - 1) / PA_THREADS;  // per thread

template <typename T>
__global__ void __launch_bounds__(PA_THREADS) paged_attention_kernel(
    const T* __restrict__ q,                 // (B, Hq, D)
    const T* __restrict__ k_pages,           // (B, P, page, Hkv, D)
    const T* __restrict__ v_pages,           // (B, P, page, Hkv, D)
    const int32_t* __restrict__ page_table,  // (B, NP), -1 = hole
    const int32_t* __restrict__ seq_lens,    // (B,)
    int P, int page, int Hkv, int D, int G, int NP, float scale,
    T* __restrict__ out) {                   // (B, Hq, D)
  extern __shared__ float smem[];
  const int kld = D + 1;                     // padded K rows: no bank conflicts
  float* q_s = smem;                         // G x D
  float* k_s = q_s + G * D;                  // TP x (D + 1)
  float* v_s = k_s + PA_TP * kld;            // TP x D
  float* p_s = v_s + PA_TP * D;              // G x TP scores, then probs
  __shared__ float m_s[PA_GMAX], l_s[PA_GMAX], a_s[PA_GMAX];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Hq = Hkv * G;
  const T* qb = q + ((int64_t)b * Hq + (int64_t)h * G) * D;
  for (int i = tid; i < G * D; i += PA_THREADS) q_s[i] = to_f32(qb[i]);
  if (tid < G) {
    m_s[tid] = ATTN_NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[PA_GMAX][PA_DPT];
#pragma unroll
  for (int g = 0; g < PA_GMAX; ++g)
#pragma unroll
    for (int c = 0; c < PA_DPT; ++c) acc[g][c] = 0.f;

  const int len = seq_lens[b];
  const int64_t row = (int64_t)Hkv * D;      // elements between positions
  const int chunks = D / 8;
  for (int i = 0; i < NP; ++i) {
    const int start = i * page;
    if (start >= len) break;                 // later pages start later still
    const int phys = page_table[(int64_t)b * NP + i];
    if (phys < 0) continue;                  // a hole: masked, never read
    const int64_t base = ((int64_t)b * P + phys) * page * row + (int64_t)h * D;
    const int n_page = min(page, len - start);
    for (int t0 = 0; t0 < n_page; t0 += PA_TP) {
      const int nt = min(PA_TP, n_page - t0);
      __syncthreads();                       // the last tile's readers are done
      for (int ci = tid; ci < nt * chunks; ci += PA_THREADS) {
        const int t = ci / chunks, d0 = (ci % chunks) * 8;
        const int64_t off = base + (int64_t)(t0 + t) * row + d0;
        float kv8[8], vv8[8];
        load8(k_pages + off, kv8);
        load8(v_pages + off, vv8);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          k_s[t * kld + d0 + j] = kv8[j];
          v_s[t * D + d0 + j] = vv8[j];
        }
      }
      __syncthreads();
      // scores s[g][t] = (q_g . k_t) * scale, one (g, t) pair per thread;
      // four partial sums (D is a multiple of 8) keep four FMA chains in
      // flight
      for (int pi = tid; pi < G * nt; pi += PA_THREADS) {
        const int g = pi / nt, t = pi % nt;
        const float* qr = q_s + g * D;
        const float* kr = k_s + t * kld;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        for (int d = 0; d < D; d += 4) {
          s0 += qr[d] * kr[d];
          s1 += qr[d + 1] * kr[d + 1];
          s2 += qr[d + 2] * kr[d + 2];
          s3 += qr[d + 3] * kr[d + 3];
        }
        p_s[g * PA_TP + t] = ((s0 + s1) + (s2 + s3)) * scale;
      }
      __syncthreads();
      // online softmax, one warp per query row (every position is live)
      for (int g = warp; g < G; g += PA_THREADS / 32) {
        float mx = ATTN_NEG_INF;
        for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, p_s[g * PA_TP + t]);
        mx = warp_max(mx);
        const float m_prev = m_s[g];
        const float m_next = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int t = lane; t < nt; t += 32) {
          const float p = expf(p_s[g * PA_TP + t] - m_next);
          p_s[g * PA_TP + t] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_next);
          a_s[g] = alpha;
          l_s[g] = l_s[g] * alpha + sum;
          m_s[g] = m_next;
        }
      }
      __syncthreads();
      // acc[g][d] = acc[g][d] * alpha_g + sum_t p[g][t] * v[t][d]
#pragma unroll
      for (int c = 0; c < PA_DPT; ++c) {
        const int d = tid + c * PA_THREADS;
        if (d < D) {
#pragma unroll
          for (int g = 0; g < PA_GMAX; ++g)
            if (g < G) acc[g][c] *= a_s[g];
          for (int t = 0; t < nt; ++t) {
            const float vv = v_s[t * D + d];
#pragma unroll
            for (int g = 0; g < PA_GMAX; ++g)
              if (g < G) acc[g][c] += p_s[g * PA_TP + t] * vv;
          }
        }
      }
    }
  }
  __syncthreads();
  T* ob = out + ((int64_t)b * Hq + (int64_t)h * G) * D;
#pragma unroll
  for (int c = 0; c < PA_DPT; ++c) {
    const int d = tid + c * PA_THREADS;
    if (d < D) {
#pragma unroll
      for (int g = 0; g < PA_GMAX; ++g)
        if (g < G) ob[g * D + d] = from_f32<T>(acc[g][c] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* pt,
           const void* sl, int B, int P, int page, int Hkv, int D, int G,
           int NP, float scale, void* out, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)G * D + (size_t)PA_TP * (D + 1) +
                       (size_t)PA_TP * D + (size_t)G * PA_TP);
  cudaError_t e = cudaFuncSetAttribute(
      paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  paged_attention_kernel<T><<<dim3(Hkv, B), PA_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int32_t*>(pt),
      static_cast<const int32_t*>(sl), P, page, Hkv, D, G, NP, scale,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// D must be a multiple of 8 and at most 256, G at most 16, and every tensor
// 16-byte aligned (the wrapper checks).  is_bf16 selects bf16 over f32.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table,
                                      const void* seq_lens, int B, int P,
                                      int page, int Hkv, int D, int G, int NP,
                                      float scale, int is_bf16, void* out,
                                      void* stream) {
  if (D % 8 != 0 || D > PA_DMAX || G > PA_GMAX || G < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hkv == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(q, k_pages, v_pages, page_table,
                                         seq_lens, B, P, page, Hkv, D, G, NP,
                                         scale, out, st)
                 : launch<float>(q, k_pages, v_pages, page_table, seq_lens, B,
                                 P, page, Hkv, D, G, NP, scale, out, st);
}
