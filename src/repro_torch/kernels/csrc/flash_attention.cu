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
// lengths the pairs dominate.  Two kernels, chosen by the wrapper
// (kernels/flash_attention.py) by an explicit rule on dtype and shape:
//
// * flash_fwd_tc_kernel, bf16 with D in {64, 128, 256}: tensor cores.  One
//   CTA per (q tile of 128 rows, q head, batch) with two consumer
//   warpgroups of 64 rows and one producer warp.  The producer loads the Q
//   tile once and the K and V tiles (128 keys, 64 at D 256) through a
//   two-stage shared-memory ring with TMA, 128-byte swizzled, guarded by
//   full/empty mbarriers.  Each consumer computes S = Q K^T with wgmma
//   (both operands K-major in shared memory), the online softmax in f32
//   registers with exp2 and log2(e) folded into the scale, and O += P V
//   with P converted to bf16 in registers as wgmma's A operand (its
//   accumulator layout is the A-fragment layout) and V as the transposed,
//   N-major B operand.  Masks are applied only on tiles that straddle the
//   causal diagonal, the window edge or Skv; TMA zero-fills rows past Sq or
//   Skv.  A row with no live key keeps m = -inf and l = 0 and writes 0.
// * flash_fwd_kernel, every other case (f32, other head dims): f32 SIMT.
//   One block per (q tile of 64 rows, q head, batch); 256 threads as a
//   16 x 16 grid, each thread owning 4 query rows (ty + 16 i) and, per kv
//   tile of 32 keys, 2 score columns (tx + 16 j) and D / 16 output columns
//   (tx + 16 k).  Q, K and V tiles are staged in shared memory as f32, K
//   rows padded by one word; row max and sum are reduced across the 16
//   lanes of a row with shuffles.  f32 stays on this kernel: TF32 tensor
//   cores keep 10 mantissa bits, too few for the f32 tolerance of 3e-5.
//
// With a non-null ``lse`` pointer both also write each row's log-sum-exp of
// the scaled scores, m + log(max(l, 1e-30)) in natural log, f32 (B, Hq,
// Sq), which the backward (flash_attention_bwd.cu) reads; a row with no live
// key writes -1e30, as the plain version.  A null pointer writes nothing.
//
// Both mask kv_pos < Skv (the ragged edge, without padding copies), kv_pos
// <= q_pos (causal) and kv_pos > q_pos - window (64-bit, so a window near
// 2^31 cannot overflow), and skip kv tiles that no row of the q tile can
// see; the result is the same.
#include <cuda.h>        // CUtensorMap and its enums (types only)

#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

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
    long long window, float scale, T* __restrict__ out,
    float* __restrict__ lse) {
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
      if (lse != nullptr && tx == 0)
        lse[((int64_t)b * Hq + h) * Sq + qp] = m[i] + logf(denom);
    }
  }
}

template <typename T, int NDT>
int launch(const void* q, const void* k, const void* v, int B, int Hq,
           int Hkv, int Sq, int Skv, int D, int causal, int has_window,
           long long window, float scale, void* out, float* lse,
           cudaStream_t st) {
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
      window, scale, static_cast<T*>(out), lse);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, int B, int Hq,
             int Hkv, int Sq, int Skv, int D, int causal, int has_window,
             long long window, float scale, void* out, float* lse,
             cudaStream_t st) {
  const int ndt = (D + 15) / 16;
  if (ndt <= 1)
    return launch<T, 1>(q, k, v, B, Hq, Hkv, Sq, Skv, D, causal, has_window,
                        window, scale, out, lse, st);
  if (ndt <= 2)
    return launch<T, 2>(q, k, v, B, Hq, Hkv, Sq, Skv, D, causal, has_window,
                        window, scale, out, lse, st);
  if (ndt <= 4)
    return launch<T, 4>(q, k, v, B, Hq, Hkv, Sq, Skv, D, causal, has_window,
                        window, scale, out, lse, st);
  if (ndt <= 8)
    return launch<T, 8>(q, k, v, B, Hq, Hkv, Sq, Skv, D, causal, has_window,
                        window, scale, out, lse, st);
  return launch<T, 16>(q, k, v, B, Hq, Hkv, Sq, Skv, D, causal, has_window,
                       window, scale, out, lse, st);
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
                                      void* lse, void* stream) {
  if (D % 8 != 0 || D > 256 || D < 8 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  return is_bf16
             ? launch_d<__nv_bfloat16>(q, k, v, B, Hq, Hkv, Sq, Skv, D, causal,
                                       has_window, window, scale, out, lse_f,
                                       st)
             : launch_d<float>(q, k, v, B, Hq, Hkv, Sq, Skv, D, causal,
                               has_window, window, scale, out, lse_f, st);
}

// ======================================================= tensor-core (bf16) ==
namespace {

constexpr int TC_BQ = 128;                 // query rows per CTA
constexpr int TC_STAGES = 2;               // K/V ring depth
constexpr int TC_CONSUMERS = 256;          // two warpgroups of 64 rows
constexpr int TC_THREADS = TC_CONSUMERS + 32;   // and one producer warp

template <int D>
struct TcTile {
  // the f32 O accumulator takes D / 2 registers a thread: at D 256 the kv
  // tile shrinks to 64 keys so that S (BKV / 2) fits beside it
  static constexpr int BKV = D == 256 ? 64 : 128;
  static constexpr int NCH = D / 64;       // 64-column (128-byte) chunks
  static constexpr int Q_BYTES = TC_BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;   // one K or one V tile
  static constexpr int BAR_OFF = Q_BYTES + TC_STAGES * 2 * KV_BYTES;
  // + 1024 to align the base for the swizzle, + the mbarriers
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 2 * TC_STAGES);
};

// Shared memory (1024-byte aligned): Q as NCH chunks of [128 rows][64], then
// per stage K and V as NCH chunks of [BKV rows][64], each row 128 bytes with
// TMA's 128-byte swizzle, then the barriers q_full, full[s], empty[s].
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1) flash_fwd_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q,    // (B*Hq, Sq, D) bf16
    const __grid_constant__ CUtensorMap tm_k,    // (B*Hkv, Skv, D) bf16
    const __grid_constant__ CUtensorMap tm_v,
    int Hq, int Hkv, int Sq, int Skv, int causal, int has_window,
    long long window, float scale_log2, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse) {
  using Tl = TcTile<D>;
  constexpr int BKV = Tl::BKV, NCH = Tl::NCH;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bars = base + Tl::BAR_OFF;
  const uint32_t q_full = bars;

  const int tile = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int q0 = tile * TC_BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q_last = min(q0 + TC_BQ, Sq) - 1;
  int kv_end = Skv;
  if (causal) kv_end = min(kv_end, q_last + 1);
  const long long lo = has_window ? (long long)q0 - window + 1 : 0;
  const int t_begin = lo > 0 ? (int)(lo / BKV) : 0;
  const int n_tiles = max(0, (kv_end + BKV - 1) / BKV - t_begin);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);                       // full
      mbar_init(bars + 8 * (1 + TC_STAGES + s), TC_CONSUMERS);  // empty
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= TC_CONSUMERS) {
    // producer warp: one thread issues every TMA load
    if (tid == TC_CONSUMERS) {
      mbar_arrive_expect_tx(q_full, Tl::Q_BYTES);
      for (int c = 0; c < NCH; ++c)
        tma_load_3d(q_s + c * TC_BQ * 128, &tm_q, q_full, c * 64, q0,
                    b * Hq + h);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % TC_STAGES;
        const uint32_t k_s = base + Tl::Q_BYTES + st * 2 * Tl::KV_BYTES;
        const uint32_t v_s = k_s + Tl::KV_BYTES;
        const uint32_t full = bars + 8 * (1 + st);
        mbar_wait(bars + 8 * (1 + TC_STAGES + st), ((it / TC_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full, 2 * Tl::KV_BYTES);
        const int kv0 = (t_begin + it) * BKV;
        for (int c = 0; c < NCH; ++c) {
          tma_load_3d(k_s + c * BKV * 128, &tm_k, full, c * 64, kv0,
                      b * Hkv + hk);
          tma_load_3d(v_s + c * BKV * 128, &tm_v, full, c * 64, kv0,
                      b * Hkv + hk);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63; in the wgmma
  // accumulator layout this thread holds rows r0 and r0 + 8, and for
  // register i the column 8 (i / 4) + 2 (lane % 4) + (i % 2), row
  // r0 + 8 ((i / 2) % 2)
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const long long qa = q0 + wg * 64, qb = qa + 63;
  const uint32_t q_wg = q_s + wg * 64 * 128;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % TC_STAGES;
    const uint32_t k_s = base + Tl::Q_BYTES + st * 2 * Tl::KV_BYTES;
    const uint32_t v_s = k_s + Tl::KV_BYTES;
    mbar_wait(bars + 8 * (1 + st), (it / TC_STAGES) & 1);

    // S = Q K^T: D / 16 steps of k16, 32 bytes apart inside a 128-byte
    // swizzled row, a chunk (rows x 128 bytes) apart every four steps
    float s[BKV / 2];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc_b128(q_wg + c * TC_BQ * 128 + kk * 32, 16, 1024);
        const uint64_t db = desc_b128(k_s + c * BKV * 128 + kk * 32, 16, 1024);
        if constexpr (BKV == 128)
          wgmma_ss_n128(s, da, db, c | kk);
        else
          wgmma_ss_n64(s, da, db, c | kk);
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) reg_fence(s[i]);

    const int kv0 = (t_begin + it) * BKV;
    const bool edge = kv0 + BKV > Skv || (causal && kv0 + BKV - 1 > qa) ||
                      (has_window && (long long)kv0 <= qb - window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const long long qp = r0 + 8 * ((i >> 1) & 1);
        const long long kp = kv0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        const bool live = kp < Skv && (!causal || kp <= qp) &&
                          (!has_window || kp > qp - window);
        if (!live) s[i] = -INFINITY;
      }
    }

    // online softmax in the log2 domain; the four lanes of a row reduce
    // with shuffles
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float mb[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r] * scale_log2);
      mb[r] = m_new == -INFINITY ? 0.f : m_new;   // no live key yet: p = 0
      alpha[r] = exp2f(m_r[r] - mb[r]);
      m_r[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp2f(s[i] * scale_log2 - mb[r]);
      rs[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // P as bf16 A fragments: the accumulator registers 8 kc .. 8 kc + 7 of
    // a 64 x 16 slice are exactly the four A registers of that slice
    uint32_t p[BKV / 16][4];
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p[kc][j] = pack_bf16(s[8 * kc + 2 * j], s[8 * kc + 2 * j + 1]);

    // O += P V: V [kv][d] is N-major; 16 kv rows (2048 bytes) a step, the
    // next 64 columns a chunk (LBO) away
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      if constexpr (D == 64) {
        wgmma_rs_n64_tb(o, p[kc], desc_b128(v_s + kc * 2048, BKV * 128, 1024));
      } else {
#pragma unroll
        for (int j = 0; j < D / 128; ++j)
          wgmma_rs_n128_tb(o + 64 * j, p[kc],
                           desc_b128(v_s + 2 * j * BKV * 128 + kc * 2048,
                                     BKV * 128, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) reg_fence(o[i]);
    mbar_arrive(bars + 8 * (1 + TC_STAGES + st));   // the slot may refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  __nv_bfloat16* ob = out + ((int64_t)b * Hq + h) * (int64_t)Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row < Sq) {
      const float denom = fmaxf(l_r[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int i = 4 * j + 2 * r;
        const int col = 8 * j + 2 * (lane & 3);
        *reinterpret_cast<uint32_t*>(ob + (int64_t)row * D + col) =
            pack_bf16(o[i] / denom, o[i + 1] / denom);
      }
      // m_r is log2-domain; a row that saw no live key keeps m = -inf
      if (lse != nullptr && (lane & 3) == 0)
        lse[((int64_t)b * Hq + h) * Sq + row] =
            m_r[r] == -INFINITY
                ? ATTN_NEG_INF
                : (m_r[r] + log2f(denom)) * 0.6931471805599453f;
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (BH, S, D) bf16 tensor seen as tiles of [rows][64 columns], 128-byte
// swizzled; rows past S read as zeros.
bool make_map(CUtensorMap* m, const void* ptr, int BH, int S, int D,
              int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, int B, int Hq,
              int Hkv, int Sq, int Skv, int causal, int has_window,
              long long window, float scale, void* out, float* lse,
              cudaStream_t st) {
  using Tl = TcTile<D>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B * Hq, Sq, D, TC_BQ) ||
      !make_map(&tk, k, B * Hkv, Skv, D, Tl::BKV) ||
      !make_map(&tv, v, B * Hkv, Skv, D, Tl::BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tl::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + TC_BQ - 1) / TC_BQ, Hq, B);
  flash_fwd_tc_kernel<D><<<grid, TC_THREADS, Tl::SMEM, st>>>(
      tq, tk, tv, Hq, Hkv, Sq, Skv, causal, has_window, window,
      scale * 1.4426950408889634f, static_cast<__nv_bfloat16*>(out), lse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 only, D in {64, 128, 256}, Skv >= 1, Hq a multiple of Hkv, every
// tensor contiguous and 16-byte aligned (the wrapper checks and chooses).
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, int B, int Hq,
                                         int Hkv, int Sq, int Skv, int D,
                                         int causal, int has_window,
                                         long long window, float scale,
                                         void* out, void* lse, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0 || Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  switch (D) {
    case 64:
      return launch_tc<64>(q, k, v, B, Hq, Hkv, Sq, Skv, causal, has_window,
                           window, scale, out, lse_f, st);
    case 128:
      return launch_tc<128>(q, k, v, B, Hq, Hkv, Sq, Skv, causal, has_window,
                            window, scale, out, lse_f, st);
    case 256:
      return launch_tc<256>(q, k, v, B, Hq, Hkv, Sq, Skv, causal, has_window,
                            window, scale, out, lse_f, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
