// Blockwise (flash) attention forward for Hopper (sm_90a): causal or
// windowed GQA prefill attention, the full-sequence forward's hot path.
//
// Replaces: flash_attention_pallas in src/repro/kernels/flash_attention.py
// (bodies _flash_kernel, static window, and _flash_kernel_dyn, a traced
// per-layer window).  The TPU kernel walks a (batch, q_head, q_block,
// kv_block) grid with the kv axis sequential, keeps (m, l, acc) in VMEM
// scratch, folds GQA into the kv BlockSpec (h // group), pads both
// sequences to the block size and visits every kv block, masked or not.
//
// Bound: operations.  4 * D flops per live (query, key) pair (q.k and p.v),
// against 2 * D * (Sq + 2 * Skv) elements moved per head; at prefill
// lengths the pairs dominate.  Design (simple, right first): one block per
// (q tile of 64 rows, q head, batch); 256 threads as a 16 x 16 grid, each
// thread owning 4 query rows (ty + 16 i) and, per kv tile of 32 keys, 2
// score columns (tx + 16 j) and D / 16 output columns (tx + 16 k).  The Q
// tile stays in shared memory as f32; K and V tiles are staged there with
// 16-byte loads, K rows padded by one word so the score loop is free of
// bank conflicts.  Row max and row sum are reduced across the 16 lanes of
// a row with warp shuffles.  The kernel masks kv_pos < Skv (the ragged edge,
// without padding copies), kv_pos <= q_pos (causal) and kv_pos > q_pos -
// window (64-bit, so a window near 2^31 cannot overflow), and skips kv
// tiles that no row of the q tile can see; the result is the same.  Arith
// is f32 SIMT: the tensor-core (wgmma) version is later work.
#include "common.cuh"

namespace {

constexpr int FA_THREADS = 256;
constexpr int FA_BQ = 64;
constexpr int FA_BKV = 32;
constexpr int FA_PLD = FA_BKV + 1;   // padded probability rows

template <typename T, int NDT>       // NDT >= ceil(D / 16) head-dim columns
__global__ void __launch_bounds__(FA_THREADS) flash_fwd_kernel(
    const T* __restrict__ q,         // (B, Hq, Sq, D)
    const T* __restrict__ k,         // (B, Hkv, Skv, D)
    const T* __restrict__ v,         // (B, Hkv, Skv, D)
    int Hq, int Hkv, int Sq, int Skv, int D, int causal, int has_window,
    long long window, float scale, T* __restrict__ out) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;                  // BQ x (D + 1)
  float* k_s = q_s + FA_BQ * ld;      // BKV x (D + 1)
  float* v_s = k_s + FA_BKV * ld;     // BKV x D
  float* p_s = v_s + FA_BKV * D;      // BQ x (BKV + 1)

  const int q0 = blockIdx.x * FA_BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + ((int64_t)b * Hq + h) * (int64_t)Sq * D;
  const T* kb = k + ((int64_t)b * Hkv + hk) * (int64_t)Skv * D;
  const T* vb = v + ((int64_t)b * Hkv + hk) * (int64_t)Skv * D;
  const int chunks = D / 8;

  for (int ci = tid; ci < FA_BQ * chunks; ci += FA_THREADS) {
    const int r = ci / chunks, d0 = (ci % chunks) * 8;
    float x8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q0 + r < Sq) load8(qb + (int64_t)(q0 + r) * D + d0, x8);
#pragma unroll
    for (int j = 0; j < 8; ++j) q_s[r * ld + d0 + j] = x8[j];
  }

  // kv tiles that some row q0..q_last of this tile can see
  const int q_last = min(q0 + FA_BQ, Sq) - 1;
  int kv_end = Skv;
  if (causal) kv_end = min(kv_end, q_last + 1);
  long long lo = 0;
  if (has_window) lo = (long long)q0 - window + 1;   // kv_pos > q0 - window
  const int kv_begin = lo > 0 ? (int)(lo / FA_BKV) * FA_BKV : 0;

  float m[4], l[4], acc[4][NDT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = ATTN_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NDT; ++c) acc[i][c] = 0.f;
  }

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += FA_BKV) {
    __syncthreads();                  // the last tile's readers are done
    for (int ci = tid; ci < FA_BKV * chunks; ci += FA_THREADS) {
      const int c = ci / chunks, d0 = (ci % chunks) * 8;
      float k8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (kv0 + c < Skv) {
        const int64_t off = (int64_t)(kv0 + c) * D + d0;
        load8(kb + off, k8);
        load8(vb + off, v8);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        k_s[c * ld + d0 + j] = k8[j];
        v_s[c * D + d0 + j] = v8[j];
      }
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], bb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) bb[j] = k_s[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] += a[i] * bb[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qp = q0 + ty + 16 * i;
      bool live[2];
      float mx = ATTN_NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const long long kp = kv0 + tx + 16 * j;
        live[j] = kp < Skv && (!causal || kp <= qp) &&
                  (!has_window || kp > qp - window);
        s[i][j] = live[j] ? s[i][j] * scale : ATTN_NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes of row (ty + 16 i) are one half-warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_next = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_next) : 0.f;
        p_s[(ty + 16 * i) * FA_PLD + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_next;
#pragma unroll
      for (int c = 0; c < NDT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < FA_BKV; ++c) {
      float vv[NDT];
#pragma unroll
      for (int kk = 0; kk < NDT; ++kk) {
        const int d = tx + 16 * kk;
        vv[kk] = d < D ? v_s[c * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty + 16 * i) * FA_PLD + c];
#pragma unroll
        for (int kk = 0; kk < NDT; ++kk) acc[i][kk] += p * vv[kk];
      }
    }
  }

  T* ob = out + ((int64_t)b * Hq + h) * (int64_t)Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp < Sq) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int kk = 0; kk < NDT; ++kk) {
        const int d = tx + 16 * kk;
        if (d < D) ob[(int64_t)qp * D + d] = from_f32<T>(acc[i][kk] / denom);
      }
    }
  }
}

template <typename T, int NDT>
int launch(const void* q, const void* k, const void* v, int B, int Hq,
           int Hkv, int Sq, int Skv, int D, int causal, int has_window,
           long long window, float scale, void* out, cudaStream_t st) {
  const size_t smem = sizeof(float) *
      ((size_t)FA_BQ * (D + 1) + (size_t)FA_BKV * (D + 1) +
       (size_t)FA_BKV * D + (size_t)FA_BQ * FA_PLD);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NDT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + FA_BQ - 1) / FA_BQ, Hq, B);
  flash_fwd_kernel<T, NDT><<<grid, FA_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), Hq, Hkv, Sq, Skv, D, causal, has_window,
      window, scale, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, int B, int Hq,
             int Hkv, int Sq, int Skv, int D, int causal, int has_window,
             long long window, float scale, void* out, cudaStream_t st) {
  const int ndt = (D + 15) / 16;
  if (ndt <= 1)
    return launch<T, 1>(q, k, v, B, Hq, Hkv, Sq, Skv, D, causal, has_window,
                        window, scale, out, st);
  if (ndt <= 2)
    return launch<T, 2>(q, k, v, B, Hq, Hkv, Sq, Skv, D, causal, has_window,
                        window, scale, out, st);
  if (ndt <= 4)
    return launch<T, 4>(q, k, v, B, Hq, Hkv, Sq, Skv, D, causal, has_window,
                        window, scale, out, st);
  if (ndt <= 8)
    return launch<T, 8>(q, k, v, B, Hq, Hkv, Sq, Skv, D, causal, has_window,
                        window, scale, out, st);
  return launch<T, 16>(q, k, v, B, Hq, Hkv, Sq, Skv, D, causal, has_window,
                       window, scale, out, st);
}

}  // namespace

// D must be a multiple of 8 and at most 256, Hq a multiple of Hkv, and every
// tensor contiguous and 16-byte aligned (the wrapper checks).  has_window = 0
// means no window; is_bf16 selects bf16 over f32.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, int B, int Hq, int Hkv,
                                      int Sq, int Skv, int D, int causal,
                                      int has_window, long long window,
                                      float scale, int is_bf16, void* out,
                                      void* stream) {
  if (D % 8 != 0 || D > 256 || D < 8 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch_d<__nv_bfloat16>(q, k, v, B, Hq, Hkv, Sq, Skv, D, causal,
                                       has_window, window, scale, out, st)
             : launch_d<float>(q, k, v, B, Hq, Hkv, Sq, Skv, D, causal,
                               has_window, window, scale, out, st);
}
