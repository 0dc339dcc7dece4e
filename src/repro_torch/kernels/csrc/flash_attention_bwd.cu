// Blockwise (flash) attention backward for Hopper (sm_90a): dQ, dK and dV
// of causal, windowed or unmasked GQA attention from q, k, v, the forward's
// output O and per-row log-sum-exp (flash_attention.cu writes it), and dO.
//
// Replaces: no Pallas kernel.  The reference differentiates its flash
// attention with the jnp custom_vjp backward _fa_vjp_bwd
// (src/repro/kernels/ref.py, bound to flash_attention_xla), which per
// (query block, kv block) recomputes P = exp(S scale - lse) under the mask
// and accumulates dV += P^T dO, dP = dO V^T, dS = P (dP - Delta) scale with
// Delta = rowsum(dO O), dQ += dS K and dK += dS^T Q, everything in f32,
// the GQA group summed into its kv head.  This computes the same function.
//
// Bound: operations.  Per live (query, key) pair the backward's five
// products (S, dP, dV, dK, dQ) take 10 D flops; this design recomputes S
// and dP in the dQ pass, 14 D in all, against 2 D (Sq (4 Hq + 1) + 4 Skv
// Hkv) elements moved.  Three kernels from one C entry, with no atomics, so
// two runs give the same bits:
//
// * fa_bwd_delta_kernel: Delta = rowsum(dO * O), one warp a row, into an
//   f32 workspace (B, Hq, Sq) that the wrapper allocates;
// * fa_bwd_dkdv_kernel: one CTA per (kv tile of 32 keys, kv head, batch).
//   It keeps its K and V tiles in shared memory as f32 and dK and dV in
//   registers, and loops over the query tiles (32 rows) of every query head
//   of its GQA group that can see one of its keys, so the group's sum stays
//   inside the CTA and nothing is summed across CTAs;
// * fa_bwd_dq_kernel: one CTA per (query tile of 32 rows, query head,
//   batch), dQ in registers; it recomputes S and dP from lse and Delta for
//   every kv tile its rows can see.
//
// 256 threads as a 16 x 16 grid.  In a 32 x 32 (query, key) tile a thread
// computes rows ty + 16 i and keys tx + 16 j (i, j < 2); for the
// accumulations it owns rows (keys in dkdv, queries in dq) ty + 16 i and
// head-dim columns tx + 16 c.  Tiles are staged as f32 with rows padded by
// one word; at D 256 a CTA takes 140,288 bytes of dynamic shared memory
// (set with cudaFuncSetAttribute; one CTA an SM).  Both passes skip the
// tiles the causal and window masks hide entirely, as the forward does, and
// mask kv_pos < Skv, q_pos < Sq, kv_pos <= q_pos (causal) and kv_pos > q_pos
// - window (64-bit) inside the tiles they visit.  A row with no live key
// has P = 0 throughout and contributes nothing.  f32 or bf16 inputs; the
// gradients are written in the inputs' dtype.  wgmma and TMA are later
// work.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int BW_THREADS = 256;
constexpr int BW_BQ = 32;             // query rows a tile
constexpr int BW_BKV = 32;            // keys a tile
constexpr int BW_PLD = BW_BKV + 1;    // padded P / dS rows

template <typename T>
__global__ void __launch_bounds__(BW_THREADS) fa_bwd_delta_kernel(
    const T* __restrict__ out, const T* __restrict__ dout, int64_t rows,
    int D, float* __restrict__ delta) {
  const int64_t row =
      (int64_t)blockIdx.x * (BW_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = out + row * D;
  const T* g = dout + row * D;
  float acc = 0.f;
  for (int d0 = lane * 8; d0 < D; d0 += 256) {
    float a[8], b8[8];
    load8(o + d0, a);
    load8(g + d0, b8);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += a[j] * b8[j];
  }
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// rows [row0, row0 + rows) of a (n, D) matrix into dst (rows x ld) as f32,
// zeros past n
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src, int row0,
                                          int n, int rows, int D) {
  const int chunks = D / 8;
  for (int ci = threadIdx.x; ci < rows * chunks; ci += BW_THREADS) {
    const int r = ci / chunks, d0 = (ci % chunks) * 8;
    float x8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row0 + r < n) load8(src + (int64_t)(row0 + r) * D + d0, x8);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[r * ld + d0 + j] = x8[j];
  }
}

__device__ __forceinline__ bool live(long long qp, long long kp, int Sq,
                                     int Skv, int causal, int has_window,
                                     long long window) {
  return qp < Sq && kp < Skv && (!causal || kp <= qp) &&
         (!has_window || kp > qp - window);
}

// P and dS of one (query tile, kv tile) pair into p_s and ds_s (BQ x PLD),
// from the staged q, dO, K and V tiles and the rows' lse and Delta
__device__ __forceinline__ void p_and_ds(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const float* lse_s, const float* dl_s, int ld, int D, int q0, int kv0,
    int Sq, int Skv, int causal, int has_window, long long window,
    float scale, float* p_s, float* ds_s) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int d = 0; d < D; ++d) {
    float a[2], g[2], kk[2], vv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      a[i] = q_s[(ty + 16 * i) * ld + d];
      g[i] = do_s[(ty + 16 * i) * ld + d];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      kk[j] = k_s[(tx + 16 * j) * ld + d];
      vv[j] = v_s[(tx + 16 * j) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] += a[i] * kk[j];
        dp[i][j] += g[i] * vv[j];
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tx + 16 * j;
      const float p = live(q0 + r, kv0 + c, Sq, Skv, causal, has_window,
                           window)
                          ? expf(s[i][j] * scale - lse_s[r])
                          : 0.f;
      p_s[r * BW_PLD + c] = p;
      ds_s[r * BW_PLD + c] = p * (dp[i][j] - dl_s[r]) * scale;
    }
  }
}

template <typename T, int NDT>       // NDT >= ceil(D / 16) head-dim columns
__global__ void __launch_bounds__(BW_THREADS) fa_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, int Hq,
    int Hkv, int Sq, int Skv, int D, int causal, int has_window,
    long long window, float scale, T* __restrict__ dk, T* __restrict__ dv) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* k_s = smem;                       // BKV x ld
  float* v_s = k_s + BW_BKV * ld;          // BKV x ld
  float* q_s = v_s + BW_BKV * ld;          // BQ x ld
  float* do_s = q_s + BW_BQ * ld;          // BQ x ld
  float* p_s = do_s + BW_BQ * ld;          // BQ x PLD
  float* ds_s = p_s + BW_BQ * BW_PLD;      // BQ x PLD
  float* lse_s = ds_s + BW_BQ * BW_PLD;    // BQ
  float* dl_s = lse_s + BW_BQ;             // BQ

  const int kv0 = blockIdx.x * BW_BKV, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int G = Hq / Hkv;
  const int64_t kv_off = ((int64_t)b * Hkv + hk) * (int64_t)Skv * D;
  load_tile(k_s, ld, k + kv_off, kv0, Skv, BW_BKV, D);
  load_tile(v_s, ld, v + kv_off, kv0, Skv, BW_BKV, D);

  // query tiles with a row that sees one of keys kv0 .. kv_last
  const int kv_last = min(kv0 + BW_BKV, Skv) - 1;
  const int q_begin = causal ? kv0 / BW_BQ * BW_BQ : 0;
  long long q_end = Sq;
  if (has_window && (long long)kv_last + window < q_end)
    q_end = (long long)kv_last + window;       // q_pos < kv_pos + window

  float dk_acc[2][NDT], dv_acc[2][NDT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NDT; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const int64_t q_off = ((int64_t)b * Hq + h) * (int64_t)Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += BW_BQ) {
      __syncthreads();                 // the last tile's readers are done
      load_tile(q_s, ld, q + q_off * D, q0, Sq, BW_BQ, D);
      load_tile(do_s, ld, dout + q_off * D, q0, Sq, BW_BQ, D);
      if (tid < BW_BQ) {
        const bool in = q0 + tid < Sq;
        lse_s[tid] = in ? lse[q_off + q0 + tid] : 0.f;
        dl_s[tid] = in ? delta[q_off + q0 + tid] : 0.f;
      }
      __syncthreads();
      p_and_ds(q_s, do_s, k_s, v_s, lse_s, dl_s, ld, D, q0, kv0, Sq, Skv,
               causal, has_window, window, scale, p_s, ds_s);
      __syncthreads();
      for (int r = 0; r < BW_BQ; ++r) {
        float pv[2], dsv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pv[i] = p_s[r * BW_PLD + ty + 16 * i];
          dsv[i] = ds_s[r * BW_PLD + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < NDT; ++c) {
          const int d = tx + 16 * c;
          const float gd = d < D ? do_s[r * ld + d] : 0.f;
          const float qd = d < D ? q_s[r * ld + d] : 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            dv_acc[i][c] += pv[i] * gd;
            dk_acc[i][c] += dsv[i] * qd;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = kv0 + ty + 16 * i;
    if (kp < Skv) {
#pragma unroll
      for (int c = 0; c < NDT; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          dk[kv_off + (int64_t)kp * D + d] = from_f32<T>(dk_acc[i][c]);
          dv[kv_off + (int64_t)kp * D + d] = from_f32<T>(dv_acc[i][c]);
        }
      }
    }
  }
}

template <typename T, int NDT>
__global__ void __launch_bounds__(BW_THREADS) fa_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, int Hq,
    int Hkv, int Sq, int Skv, int D, int causal, int has_window,
    long long window, float scale, T* __restrict__ dq) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;                       // BQ x ld
  float* do_s = q_s + BW_BQ * ld;          // BQ x ld
  float* k_s = do_s + BW_BQ * ld;          // BKV x ld
  float* v_s = k_s + BW_BKV * ld;          // BKV x ld
  float* p_s = v_s + BW_BKV * ld;          // BQ x PLD
  float* ds_s = p_s + BW_BQ * BW_PLD;      // BQ x PLD
  float* lse_s = ds_s + BW_BQ * BW_PLD;    // BQ
  float* dl_s = lse_s + BW_BQ;             // BQ

  const int q0 = blockIdx.x * BW_BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int hk = h / (Hq / Hkv);
  const int64_t q_off = ((int64_t)b * Hq + h) * (int64_t)Sq;
  const int64_t kv_off = ((int64_t)b * Hkv + hk) * (int64_t)Skv * D;
  load_tile(q_s, ld, q + q_off * D, q0, Sq, BW_BQ, D);
  load_tile(do_s, ld, dout + q_off * D, q0, Sq, BW_BQ, D);
  if (tid < BW_BQ) {
    const bool in = q0 + tid < Sq;
    lse_s[tid] = in ? lse[q_off + q0 + tid] : 0.f;
    dl_s[tid] = in ? delta[q_off + q0 + tid] : 0.f;
  }

  // kv tiles that some row q0 .. q_last of this tile can see
  const int q_last = min(q0 + BW_BQ, Sq) - 1;
  int kv_end = Skv;
  if (causal) kv_end = min(kv_end, q_last + 1);
  const long long lo = has_window ? (long long)q0 - window + 1 : 0;
  const int kv_begin = lo > 0 ? (int)(lo / BW_BKV) * BW_BKV : 0;

  float dq_acc[2][NDT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NDT; ++c) dq_acc[i][c] = 0.f;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BW_BKV) {
    __syncthreads();                   // the last tile's readers are done
    load_tile(k_s, ld, k + kv_off, kv0, Skv, BW_BKV, D);
    load_tile(v_s, ld, v + kv_off, kv0, Skv, BW_BKV, D);
    __syncthreads();
    p_and_ds(q_s, do_s, k_s, v_s, lse_s, dl_s, ld, D, q0, kv0, Sq, Skv,
             causal, has_window, window, scale, p_s, ds_s);
    __syncthreads();
    for (int c2 = 0; c2 < BW_BKV; ++c2) {
      float dsv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) dsv[i] = ds_s[(ty + 16 * i) * BW_PLD + c2];
#pragma unroll
      for (int c = 0; c < NDT; ++c) {
        const int d = tx + 16 * c;
        const float kd = d < D ? k_s[c2 * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) dq_acc[i][c] += dsv[i] * kd;
      }
    }
  }

  T* dqb = dq + q_off * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp < Sq) {
#pragma unroll
      for (int c = 0; c < NDT; ++c) {
        const int d = tx + 16 * c;
        if (d < D) dqb[(int64_t)qp * D + d] = from_f32<T>(dq_acc[i][c]);
      }
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *out, *lse, *dout;
  int B, Hq, Hkv, Sq, Skv, D, causal, has_window;
  long long window;
  float scale;
  float* delta;
  void *dq, *dk, *dv;
};

template <typename T, int NDT>
int launch_bwd(const BwdArgs& a, cudaStream_t st) {
  const size_t smem = sizeof(float) *
      ((size_t)(2 * BW_BQ + 2 * BW_BKV) * (a.D + 1) +
       (size_t)2 * BW_BQ * BW_PLD + 2 * BW_BQ);
  cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_dkdv_kernel<T, NDT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(fa_bwd_dq_kernel<T, NDT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const int64_t rows = (int64_t)a.B * a.Hq * a.Sq;
  const int rows_per_block = BW_THREADS / 32;
  fa_bwd_delta_kernel<T><<<(unsigned)((rows + rows_per_block - 1) /
                                      rows_per_block),
                           BW_THREADS, 0, st>>>(
      static_cast<const T*>(a.out), dout, rows, a.D, a.delta);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (a.Skv > 0) {
    const dim3 grid_kv((a.Skv + BW_BKV - 1) / BW_BKV, a.Hkv, a.B);
    fa_bwd_dkdv_kernel<T, NDT><<<grid_kv, BW_THREADS, smem, st>>>(
        q, k, v, dout, lse, a.delta, a.Hq, a.Hkv, a.Sq, a.Skv, a.D, a.causal,
        a.has_window, a.window, a.scale, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid_q((a.Sq + BW_BQ - 1) / BW_BQ, a.Hq, a.B);
  fa_bwd_dq_kernel<T, NDT><<<grid_q, BW_THREADS, smem, st>>>(
      q, k, v, dout, lse, a.delta, a.Hq, a.Hkv, a.Sq, a.Skv, a.D, a.causal,
      a.has_window, a.window, a.scale, static_cast<T*>(a.dq));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_d(const BwdArgs& a, cudaStream_t st) {
  const int ndt = (a.D + 15) / 16;
  if (ndt <= 1) return launch_bwd<T, 1>(a, st);
  if (ndt <= 2) return launch_bwd<T, 2>(a, st);
  if (ndt <= 4) return launch_bwd<T, 4>(a, st);
  if (ndt <= 8) return launch_bwd<T, 8>(a, st);
  return launch_bwd<T, 16>(a, st);
}

}  // namespace

// q, dout, out, dq: (B, Hq, Sq, D); k, v, dk, dv: (B, Hkv, Skv, D); lse
// and the workspace delta: f32 (B, Hq, Sq).  D a multiple of 8 and at most
// 256, Hq a multiple of Hkv, every tensor contiguous and 16-byte aligned
// (the wrapper checks).  has_window = 0 means no window; is_bf16 selects
// bf16 over f32.  Launches the Delta pre-pass, the dK/dV kernel and the dQ
// kernel in that order on ``stream``.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, int B, int Hq, int Hkv, int Sq,
    int Skv, int D, int causal, int has_window, long long window, float scale,
    int is_bf16, void* delta, void* dq, void* dk, void* dv, void* stream) {
  if (D % 8 != 0 || D > 256 || D < 8 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0 || Sq == 0)
    return static_cast<int>(cudaGetLastError());
  const BwdArgs a{q, k, v, out, lse, dout, B, Hq, Hkv, Sq, Skv, D, causal,
                  has_window, window, scale, static_cast<float*>(delta), dq,
                  dk, dv};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd_d<__nv_bfloat16>(a, st)
                 : launch_bwd_d<float>(a, st);
}
