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
// Bound: operations.  Per live (query, key) pair the five products (S, dP,
// dV, dK, dQ) take 10 D flops, against 2 D (Sq (4 Hq + 1) + 4 Skv Hkv)
// elements moved.  Both variants do exactly those five products: the dK/dV
// pass writes dS of every live (query tile, key tile) pair into a workspace
// and a dQ pass reads it back (dQ = dS K), so nothing is recomputed.  The
// workspace holds, per (batch, query head), nj tiles for each query tile
// (nj bounds the key tiles a query tile can see: every key tile without a
// window, about window / tile + 2 with one); where that passes 256 MiB for
// all heads, the (batch, head) rows are taken in chunks of one dK/dV and
// one dQ launch each (qwen2.5-14b at S 4096: 64 MiB a head in f32, four
// heads a chunk; gemma3-1b's train shape: 37.7 MB, one chunk).  No atomics:
// where Hq > Hkv every CTA owns one query head, writes its dK and dV as f32
// partials, and a last kernel sums the group in a fixed order, so two runs
// give the same bits (the restart drill needs it).  Kernels, in order, from
// one C entry for each variant:
//
// * fa_bwd_delta_kernel: Delta = rowsum(dO * O), one warp a row;
// * dK/dV: one CTA per (key tile, query head, batch), looping over the
//   query tiles that can see its keys;
// * dQ: one CTA per (query tile, query head, batch; two tiles of 32 in
//   "simt"), looping over the key tiles its rows can see and reading their
//   dS from the workspace;
// * fa_bwd_group_sum_kernel (Hq > Hkv only): dK, dV = the group's partials
//   summed in head order.
//
// Both passes put the tile on the slow grid axis, in the order that starts
// the longest CTAs first under a causal mask (the first key tiles, the
// last query tiles), so that with one CTA an SM the short ones fill the
// tail.
//
// The wrapper (kernels/flash_attention.py:bwd_variant) chooses, as the
// forward's variant does:
//
// * "tc", bf16 with D in {64, 128, 256} and Skv >= 1: tensor cores.  Tiles
//   of 64 keys and 64 queries.  The dK/dV CTA has one producer warp, which
//   loads K and V once and streams Q and dO through a two-stage ring with
//   TMA (128-byte swizzle, full/empty mbarriers), and two consumer
//   warpgroups: warpgroup 0 computes S = Q K^T with wgmma, P = exp(S scale -
//   lse) under the masks in f32 registers, hands P to warpgroup 1 through
//   shared memory and accumulates dV += P^T dO (P^T stored as bf16, 128-byte
//   swizzled, as wgmma's A; dO as the transposed, N-major B); warpgroup 1
//   computes dP = dO V^T, dS = P (dP - Delta) scale, writes dS as bf16 A
//   fragments of the dQ pass into the workspace (16-byte stores, already in
//   wgmma's register layout) and accumulates dK += dS^T Q.  Each warpgroup
//   keeps one accumulator of 64 x D (D / 2 registers a thread, 128 at D
//   256), which is why dV and dK live in different warpgroups.  The dQ CTA
//   is one warpgroup and a producer warp streaming K tiles; dS comes from
//   the workspace straight into A registers.  P and dS are rounded to bf16
//   before the three products that read them (dV, dK, dQ):
//   kernels/ref.py:flash_attention_bwd_tc_ref emulates exactly that.
// * "simt", everything else (every f32 call, bf16 at other head dims): f32
//   SIMT arithmetic, TF32 off as the f32 reference asks.  Tiles of 32 keys
//   and 32 queries, 256 threads, the head dim padded to DP in {32, 64, 128,
//   256}.  What bounds it is shared memory as much as the FMA units: a
//   warp's float4 load delivers 512 bytes to registers, 4 of the SM's
//   128-byte cycles, broadcast or not, so a loop that loads 1 float for
//   each 2 FMAs can reach at most half the f32 peak
//   (tools/torch_bwd_variants.py --leave-out times each loop of the dK/dV
//   kernel).  So every loop loads 1 float for each 4 FMAs, from 8 x 8
//   register blocks: half the CTA (4 warps) computes S^T = K Q^T, P and dV
//   += P^T dO, the other half dP^T = V dO^T, dS and dK += dS^T Q, each warp
//   8 keys; in S^T or dP^T a group of 8 lanes computes an 8 key x 8 query
//   block, each lane an eighth of the head dim (16 float4 loads for 256
//   FMAs), summed by a three-step shuffle reduce-scatter that leaves each
//   lane one query; in dV or dK each lane owns 8 keys x DP / 32 columns
//   (at D 256, 4 float4 loads for 64 FMAs).  Half 0 writes P, half 1 reads
//   it to make dS.  dQ: each thread 8 queries x DP / 32 columns of 64
//   queries (two query tiles share each K tile; 4 float4 loads for 64
//   FMAs).  Rows are padded by 4 words so a quarter-warp's float4s fall in
//   distinct banks.  Q, dO, lse and Delta (dK/dV) and K and dS (dQ) stream
//   through two-stage rings filled by cp.async, so the next tile loads
//   while this one computes; bf16 (at other head dims) is converted while
//   staged, without the overlap.  At D 256 a dK/dV CTA takes 209,408 bytes
//   of shared memory (one an SM; the head split gives 512 CTAs at the train
//   shape where one CTA per key tile and kv head gave 128 on 132 SMs).
//
// Both variants mask kv_pos < Skv, q_pos < Sq, kv_pos <= q_pos (causal) and
// kv_pos > q_pos - window (64-bit) inside the tiles they visit, and visit
// exactly the tile pairs that hold a live pair (tile_pair_live, one
// predicate for both passes).  A row with no live key has P = 0 throughout
// and contributes nothing.  The gradients are written in the inputs'
// dtype.
#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr long long BW_WS_CAP_BYTES = 1ll << 28;   // dS workspace a chunk
constexpr int BW_THREADS = 256;

// ------------------------------------------------------------- tiling --
// Does the (query tile qt, key tile kt) pair hold a live (query, key)?
__host__ __device__ __forceinline__ bool tile_pair_live(
    int qt, int kt, int bt, int Sq, int Skv, int causal, int has_window,
    long long window) {
  const long long q0 = (long long)qt * bt, k0 = (long long)kt * bt;
  if (q0 >= Sq || k0 >= Skv) return false;
  const long long q_last = (q0 + bt < Sq ? q0 + bt : Sq) - 1;
  const long long k_last = (k0 + bt < Skv ? k0 + bt : Skv) - 1;
  if (causal && k0 > q_last) return false;
  return !has_window || k_last > q0 - window;
}

// The first key tile query tile qt can see: dS tile (qt, kt) is workspace
// tile kt - first_key_tile(qt) of qt's row.
__host__ __device__ __forceinline__ int first_key_tile(
    int qt, int bt, int has_window, long long window) {
  if (!has_window) return 0;
  const long long lo = (long long)qt * bt - window + 1;
  return lo > 0 ? (int)(lo / bt) : 0;
}

// Key tiles [first_key_tile, end) hold every live pair of query tile qt.
__device__ __forceinline__ int key_tile_end(int qt, int bt, int nkt,
                                            int Sq, int causal) {
  if (!causal) return nkt;
  const int q_last = min(qt * bt + bt, Sq) - 1;
  return min(nkt, q_last / bt + 1);
}

// Query tiles [begin, end) hold every live pair of key tile kt.
__device__ __forceinline__ void query_tile_range(
    int kt, int bt, int nqt, int Skv, int causal, int has_window,
    long long window, int* begin, int* end) {
  *begin = causal ? kt : 0;
  *end = nqt;
  if (has_window) {
    const long long k_last = (long long)min(kt * bt + bt, Skv) - 1;
    const long long hi = k_last + window - 1;   // q_pos < kv_pos + window
    if (hi < 0) *end = 0;
    else if (hi / bt + 1 < *end) *end = (int)(hi / bt + 1);
  }
}

__device__ __forceinline__ bool live(long long qp, long long kp, int Sq,
                                     int Skv, int causal, int has_window,
                                     long long window) {
  return qp < Sq && kp < Skv && (!causal || kp <= qp) &&
         (!has_window || kp > qp - window);
}

// The launch's tiles and its workspace (floats): Delta (B Hq Sq), the f32
// dK and dV partials (2 B Hq Skv D, only when Hq > Hkv), then the dS tiles
// of chunk_bh (batch, head) rows.
struct Plan {
  int bt, nqt, nkt, nj, chunk_bh;
  long long part_off, ws_off, total;
};

Plan make_plan(int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
               int has_window, long long window, int tc) {
  Plan p;
  p.bt = tc ? 64 : 32;
  p.nqt = (Sq + p.bt - 1) / p.bt;
  p.nkt = (Skv + p.bt - 1) / p.bt;
  long long nj = p.nkt;
  if (causal && has_window) {
    // key tiles within [q0 - window + 1, q0 + bt - 1]
    const long long w = window > 0 ? (window + 2 * p.bt - 2) / p.bt + 1 : 1;
    if (w < nj) nj = w;
  }
  p.nj = (int)nj;
  const long long per_bh =
      (long long)p.nqt * nj * p.bt * p.bt * (tc ? 2 : 4);
  const long long bh = (long long)B * Hq;
  long long chunk = per_bh > 0 ? BW_WS_CAP_BYTES / per_bh : bh;
  if (chunk > bh) chunk = bh;
  if (chunk < 1) chunk = 1;
  p.chunk_bh = (int)chunk;
  auto up = [](long long x) { return (x + 63) / 64 * 64; };
  p.part_off = up(bh * Sq);
  p.ws_off = p.part_off + (Hq != Hkv ? up(2 * bh * Skv * D) : 0);
  p.total = p.ws_off + up((chunk * per_bh + 3) / 4);
  return p;
}

// Set a kernel's dynamic shared-memory limit once per kernel instance.
template <auto Kernel>
cudaError_t smem_limit_once(int bytes) {
  static const cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return e;
}

// ----------------------------------------------------- shared kernels --
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

// V consecutive floats (16-byte, 8-byte or 4-byte aligned) to global memory
// as T.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* dst, const float* x) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
    else if constexpr (V == 2)
      *reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);
    else
      *reinterpret_cast<float*>(dst) = x[0];
  } else {
    if constexpr (V == 4)
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
    else if constexpr (V == 2)
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x[0], x[1]);
    else
      *dst = __float2bfloat16(x[0]);
  }
}

// dK, dV (B, Hkv, Skv, D) = the sum over g of the partials of query head
// hk G + g (B, Hq, Skv, D), in head order.
template <typename T>
__global__ void __launch_bounds__(BW_THREADS) fa_bwd_group_sum_kernel(
    const float* __restrict__ part_k, const float* __restrict__ part_v,
    int64_t rows, int64_t row_elems, int G, T* __restrict__ dk,
    T* __restrict__ dv) {
  const int64_t n4 = rows * row_elems / 4;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e = i * 4, bhk = e / row_elems, rest = e % row_elems;
    float a[4] = {0.f, 0.f, 0.f, 0.f}, c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int g = 0; g < G; ++g) {
      const int64_t src = (bhk * G + g) * row_elems + rest;
      const float4 x = *reinterpret_cast<const float4*>(part_k + src);
      const float4 y = *reinterpret_cast<const float4*>(part_v + src);
      a[0] += x.x; a[1] += x.y; a[2] += x.z; a[3] += x.w;
      c[0] += y.x; c[1] += y.y; c[2] += y.z; c[3] += y.w;
    }
    store_vec<T, 4>(dk + e, a);
    store_vec<T, 4>(dv + e, c);
  }
}

// ================================================================ simt ==
constexpr int SM_B = 32;              // queries and keys a tile
constexpr int SM_PLD = SM_B + 4;      // padded P / dS rows
constexpr int SM_DQLD = 2 * SM_B + 4; // padded dS^T rows of a dQ CTA

template <int DP>                     // the head dim padded to 32 .. 256
struct SimtTile {
  static constexpr int LD = DP + 4;            // padded f32 rows
  static constexpr int NCOL = DP / 32;         // columns a thread owns
  static constexpr int VEC = NCOL < 4 ? NCOL : 4;
  static constexpr int NV = NCOL / VEC;
  // K, V, two stages of Q and dO; P, dS; two stages of lse and Delta
  static constexpr int DKDV_SMEM =
      4 * (6 * SM_B * LD + 2 * SM_B * SM_PLD + 4 * SM_B);
  // two stages of K and of dS^T (32 keys x 64 queries)
  static constexpr int DQ_SMEM = 4 * (2 * SM_B * LD + 2 * SM_B * SM_DQLD);
  // column of vector vv, element 0, for column thread c of quarter cq
  static __device__ __forceinline__ int col(int cq, int vv, int c) {
    return cq * 8 * NCOL + vv * 8 * VEC + VEC * c;
  }
};

template <int V>
__device__ __forceinline__ void lds_vec(const float* p, float* o) {
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  } else if constexpr (V == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x; o[1] = x.y;
  } else {
    o[0] = *p;
  }
}

// Rows [row0, row0 + 32) of a (n, D) matrix into dst (32 x DP + 4) as f32,
// zeros past n and past D: f32 by cp.async (the caller commits and waits),
// bf16 loaded and converted here.
template <int DP>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int row0, int n, int D) {
  constexpr int LD = DP + 4, CH = DP / 4;
  for (int ci = threadIdx.x; ci < SM_B * CH; ci += BW_THREADS) {
    const int r = ci / CH, d = (ci % CH) * 4;
    const bool in = row0 + r < n && d < D;
    cp_async16(dst + r * LD + d, in ? src + (int64_t)(row0 + r) * D + d : src,
               in ? 16 : 0);
  }
}
template <int DP>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const __nv_bfloat16* src,
                                           int row0, int n, int D) {
  constexpr int LD = DP + 4, CH = DP / 4;
  for (int ci = threadIdx.x; ci < SM_B * CH; ci += BW_THREADS) {
    const int r = ci / CH, d = (ci % CH) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < n && d < D) load4(src + (int64_t)(row0 + r) * D + d, x);
    *reinterpret_cast<float4*>(dst + r * LD + d) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}
// 32 f32 values src[row0 ..] into dst, zeros past n (cp.async)
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int row0, int n) {
  if (threadIdx.x < SM_B) {
    const bool in = row0 + (int)threadIdx.x < n;
    cp_async4(dst + threadIdx.x, in ? src + row0 + threadIdx.x : src,
              in ? 4 : 0);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(BW_THREADS, 1) fa_bwd_dkdv_simt_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, int Hq,
    int Hkv, int Sq, int Skv, int D, int causal, int has_window,
    long long window, float scale, int bh0, int nqt, int nj,
    float* __restrict__ ws, float* __restrict__ part_k,
    float* __restrict__ part_v, T* __restrict__ dk, T* __restrict__ dv) {
  using Tl = SimtTile<DP>;
  constexpr int LD = Tl::LD, NCOL = Tl::NCOL, VEC = Tl::VEC, NV = Tl::NV;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                         // 32 x LD
  float* v_s = k_s + SM_B * LD;              // 32 x LD
  float* q_s = v_s + SM_B * LD;              // 2 stages of 32 x LD
  float* do_s = q_s + 2 * SM_B * LD;         // 2 stages of 32 x LD
  float* p_s = do_s + 2 * SM_B * LD;         // P [query][key], 32 x PLD
  float* ds_s = p_s + SM_B * SM_PLD;         // dS [query][key]
  float* lse_s = ds_s + SM_B * SM_PLD;       // 2 stages of 32
  float* dl_s = lse_s + 2 * SM_B;            // 2 stages of 32

  // key tiles in order over the slow grid axis: under a causal mask the
  // first see the most query tiles, so the longest CTAs start first
  const int kt = blockIdx.y, bhl = blockIdx.x, bh = bh0 + bhl;
  const int G = Hq / Hkv, b = bh / Hq, hk = (bh % Hq) / G;
  const int k0 = kt * SM_B;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int64_t kv_rows = ((int64_t)b * Hkv + hk) * Skv;
  const int64_t q_rows = (int64_t)bh * Sq;
  const T* qb = q + q_rows * D;
  const T* gb = dout + q_rows * D;

  int qt_begin, qt_end;
  query_tile_range(kt, SM_B, nqt, Skv, causal, has_window, window,
                   &qt_begin, &qt_end);
  auto next_live = [&](int t) {
    while (t < qt_end &&
           !tile_pair_live(t, kt, SM_B, Sq, Skv, causal, has_window, window))
      ++t;
    return t;
  };
  auto stage = [&](int t, int s) {
    stage_rows<DP>(q_s + s * SM_B * LD, qb, t * SM_B, Sq, D);
    stage_rows<DP>(do_s + s * SM_B * LD, gb, t * SM_B, Sq, D);
    stage_vec(lse_s + s * SM_B, lse + q_rows, t * SM_B, Sq);
    stage_vec(dl_s + s * SM_B, delta + q_rows, t * SM_B, Sq);
  };

  stage_rows<DP>(k_s, k + kv_rows * D, k0, Skv, D);
  stage_rows<DP>(v_s, v + kv_rows * D, k0, Skv, D);
  int cur = next_live(qt_begin);
  if (cur < qt_end) stage(cur, 0);
  cp_async_commit();

  // Half 0 (warps 0-3) computes S, P and dV, half 1 (warps 4-7) dP, dS
  // and dK; warp hw of either half owns keys 8 hw .. 8 hw + 7.  Phase A:
  // lane part (an eighth of the head dim) of queries 8 qg .. 8 qg + 7.
  // Phase B: columns col(cq, vv, c) + e of the warp's keys.
  const int half = w >> 2, hw = w & 3;
  const int part = lane & 7, qg = lane >> 3, cq = lane >> 3, c = lane & 7;
  const float* a_s = half == 0 ? k_s : v_s;
  float* pd_s = half == 0 ? p_s : ds_s;      // what phase B reads
  float acc[8][NCOL];                        // dV (half 0) or dK (half 1)
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < NCOL; ++e) acc[j][e] = 0.f;

  for (int st = 0; cur < qt_end; st ^= 1) {
    const int nxt = next_live(cur + 1);
    cp_async_wait<0>();
    __syncthreads();              // this stage landed; the last readers done
    if (nxt < qt_end) stage(nxt, st ^ 1);
    cp_async_commit();
    const float* qs = q_s + st * SM_B * LD;
    const float* gs = do_s + st * SM_B * LD;
    const int q0 = cur * SM_B;

    // ---- S^T = K Q^T (half 0) or dP^T = V dO^T (half 1): 8 keys x 8
    // queries a group of 8 lanes, each lane an eighth of the head dim
    const float* bq = half == 0 ? qs : gs;
    float s[8][8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) s[j][i] = 0.f;
#pragma unroll 1
    for (int d0 = 0; d0 < DP; d0 += 32) {
      const int d = d0 + 4 * part;
      float4 a[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        a[j] = *reinterpret_cast<const float4*>(a_s + (8 * hw + j) * LD + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 x =
            *reinterpret_cast<const float4*>(bq + (8 * qg + i) * LD + d);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[j][i] = fmaf(a[j].x, x.x, s[j][i]);
          s[j][i] = fmaf(a[j].y, x.y, s[j][i]);
          s[j][i] = fmaf(a[j].z, x.z, s[j][i]);
          s[j][i] = fmaf(a[j].w, x.w, s[j][i]);
        }
      }
    }
    // reduce-scatter over the 8 parts: lane part keeps query i = part
    const bool b2 = part & 4, b1 = part & 2, b0 = part & 1;
    float sv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float r1[4], r2[2];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        r1[t] = (b2 ? s[j][4 + t] : s[j][t]) +
                __shfl_xor_sync(0xffffffffu, b2 ? s[j][t] : s[j][4 + t], 4);
#pragma unroll
      for (int t = 0; t < 2; ++t)
        r2[t] = (b1 ? r1[2 + t] : r1[t]) +
                __shfl_xor_sync(0xffffffffu, b1 ? r1[t] : r1[2 + t], 2);
      sv[j] = (b0 ? r2[1] : r2[0]) +
              __shfl_xor_sync(0xffffffffu, b0 ? r2[0] : r2[1], 1);
    }
    // P (half 0), then dS (half 1), of query 8 qg + part and the warp's
    // keys, as two float4s of a [query][key] row
    const int ql = 8 * qg + part;
    float* row = pd_s + ql * SM_PLD + 8 * hw;
    if (half == 0) {
      const float lv = lse_s[st * SM_B + ql];
      float pj[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        pj[j] = live(q0 + ql, k0 + 8 * hw + j, Sq, Skv, causal, has_window,
                     window)
                    ? expf(sv[j] * scale - lv)
                    : 0.f;
      *reinterpret_cast<float4*>(row) = make_float4(pj[0], pj[1], pj[2],
                                                    pj[3]);
      *reinterpret_cast<float4*>(row + 4) = make_float4(pj[4], pj[5], pj[6],
                                                        pj[7]);
    }
    __syncthreads();                             // P is in p_s
    if (half == 1) {
      const float dl = dl_s[st * SM_B + ql];
      const float* prow = p_s + ql * SM_PLD + 8 * hw;
      const float4 p0 = *reinterpret_cast<const float4*>(prow);
      const float4 p1 = *reinterpret_cast<const float4*>(prow + 4);
      const float pj[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      float dsj[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) dsj[j] = pj[j] * (sv[j] - dl) * scale;
      *reinterpret_cast<float4*>(row) = make_float4(dsj[0], dsj[1], dsj[2],
                                                    dsj[3]);
      *reinterpret_cast<float4*>(row + 4) = make_float4(dsj[4], dsj[5],
                                                        dsj[6], dsj[7]);
      // dS^T [key][query] of the pair for the dQ pass
      float* wt = ws + (((int64_t)bhl * nqt + cur) * nj +
                        (kt - first_key_tile(cur, SM_B, has_window, window))) *
                           (SM_B * SM_B);
#pragma unroll
      for (int j = 0; j < 8; ++j) wt[(8 * hw + j) * SM_B + ql] = dsj[j];
      named_bar_sync(1, 128);                    // dS is in ds_s
    }

    // ---- dV += P^T dO (half 0) or dK += dS^T Q (half 1)
    const float* ob = half == 0 ? gs : qs;
#pragma unroll 8
    for (int r = 0; r < SM_B; ++r) {
      const float4 p0 = *reinterpret_cast<const float4*>(pd_s + r * SM_PLD +
                                                         8 * hw);
      const float4 p1 = *reinterpret_cast<const float4*>(pd_s + r * SM_PLD +
                                                         8 * hw + 4);
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int vv = 0; vv < NV; ++vv) {
        float x[VEC];
        lds_vec<VEC>(ob + r * LD + Tl::col(cq, vv, c), x);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[j][vv * VEC + e] = fmaf(pv[j], x[e], acc[j][vv * VEC + e]);
      }
    }
    cur = nxt;
  }
  cp_async_wait<0>();               // nothing lands after the CTA exits

  T* grad = half == 0 ? dv : dk;
  float* part_g = half == 0 ? part_v : part_k;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int kp = k0 + 8 * hw + j;
    if (kp >= Skv) continue;
#pragma unroll
    for (int vv = 0; vv < NV; ++vv) {
      const int d = Tl::col(cq, vv, c);
      if (d >= D) continue;
      if (G == 1)
        store_vec<T, VEC>(grad + (kv_rows + kp) * D + d, &acc[j][vv * VEC]);
      else
        store_vec<float, VEC>(part_g + ((int64_t)bh * Skv + kp) * D + d,
                              &acc[j][vv * VEC]);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(BW_THREADS) fa_bwd_dq_simt_kernel(
    const T* __restrict__ k, const float* __restrict__ ws, int Hq, int Hkv,
    int Sq, int Skv, int D, int causal, int has_window, long long window,
    int bh0, int nqt, int nj, T* __restrict__ dq) {
  using Tl = SimtTile<DP>;
  constexpr int LD = Tl::LD, NCOL = Tl::NCOL, VEC = Tl::VEC, NV = Tl::NV;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                         // 2 stages of 32 x LD
  float* dt_s = k_s + 2 * SM_B * LD;         // 2 stages of dS^T, 32 x DQLD

  // two query tiles, qt0 and qt0 + 1, share each K tile; the last (under
  // a causal mask the longest) first
  const int qt0 = 2 * (gridDim.y - 1 - blockIdx.y), bhl = blockIdx.x,
            bh = bh0 + bhl;
  const int b = bh / Hq, hk = (bh % Hq) / (Hq / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const T* kb = k + ((int64_t)b * Hkv + hk) * Skv * D;
  const int nkt = (Skv + SM_B - 1) / SM_B;
  const int kt_first = first_key_tile(qt0, SM_B, has_window, window);
  const int kt_end = key_tile_end(min(qt0 + 1, nqt - 1), SM_B, nkt, Sq,
                                  causal);
  auto half_live = [&](int hf, int t) {
    return qt0 + hf < nqt && tile_pair_live(qt0 + hf, t, SM_B, Sq, Skv,
                                            causal, has_window, window);
  };
  auto next_live = [&](int t) {
    while (t < kt_end && !half_live(0, t) && !half_live(1, t)) ++t;
    return t;
  };
  auto stage = [&](int t, int s) {
    stage_rows<DP>(k_s + s * SM_B * LD, kb, t * SM_B, Skv, D);
    const int r = tid / 8, c4 = (tid % 8) * 4;    // 256 chunks a tile
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const bool on = half_live(hf, t);
      const int qt = qt0 + hf;
      const float* src =
          on ? ws + (((int64_t)bhl * nqt + qt) * nj +
                     (t - first_key_tile(qt, SM_B, has_window, window))) *
                        (SM_B * SM_B) + r * SM_B + c4
             : ws;
      cp_async16(dt_s + s * SM_B * SM_DQLD + r * SM_DQLD + SM_B * hf + c4,
                 src, on ? 16 : 0);
    }
  };

  int cur = next_live(kt_first);
  if (cur < kt_end) stage(cur, 0);
  cp_async_commit();

  // queries 8 qg + j of the 64, columns col(cq, vv, c) + e
  const int qg = 4 * (w & 1) + (lane >> 3), c = lane & 7, cq = w >> 1;
  float acc[8][NCOL];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < NCOL; ++e) acc[j][e] = 0.f;

  for (int st = 0; cur < kt_end; st ^= 1) {
    const int nxt = next_live(cur + 1);
    cp_async_wait<0>();
    __syncthreads();
    if (nxt < kt_end) stage(nxt, st ^ 1);
    cp_async_commit();
    const float* ks = k_s + st * SM_B * LD;
    const float* ds = dt_s + st * SM_B * SM_DQLD;
#pragma unroll 8
    for (int r = 0; r < SM_B; ++r) {
      const float4 d0 =
          *reinterpret_cast<const float4*>(ds + r * SM_DQLD + 8 * qg);
      const float4 d1 =
          *reinterpret_cast<const float4*>(ds + r * SM_DQLD + 8 * qg + 4);
      const float dsv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int vv = 0; vv < NV; ++vv) {
        float x[VEC];
        lds_vec<VEC>(ks + r * LD + Tl::col(cq, vv, c), x);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[j][vv * VEC + e] = fmaf(dsv[j], x[e], acc[j][vv * VEC + e]);
      }
    }
    cur = nxt;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int qp = qt0 * SM_B + 8 * qg + j;
    if (qp >= Sq) continue;
#pragma unroll
    for (int vv = 0; vv < NV; ++vv) {
      const int d = Tl::col(cq, vv, c);
      if (d < D)
        store_vec<T, VEC>(dq + ((int64_t)bh * Sq + qp) * D + d,
                          &acc[j][vv * VEC]);
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *out, *lse, *dout;
  int B, Hq, Hkv, Sq, Skv, D, causal, has_window;
  long long window;
  float scale;
  float* work;
  void *dq, *dk, *dv;
};

template <typename T>
int launch_delta(const BwdArgs& a, cudaStream_t st) {
  const int64_t rows = (int64_t)a.B * a.Hq * a.Sq;
  const int per_block = BW_THREADS / 32;
  fa_bwd_delta_kernel<T><<<(unsigned)((rows + per_block - 1) / per_block),
                           BW_THREADS, 0, st>>>(
      static_cast<const T*>(a.out), static_cast<const T*>(a.dout), rows,
      a.D, a.work);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_group_sum(const BwdArgs& a, const Plan& p, cudaStream_t st) {
  const int64_t rows = (int64_t)a.B * a.Hkv, row_elems = (int64_t)a.Skv * a.D;
  const float* pk = a.work + p.part_off;
  fa_bwd_group_sum_kernel<T><<<grid_for(rows * row_elems / 4, BW_THREADS),
                               BW_THREADS, 0, st>>>(
      pk, pk + (int64_t)a.B * a.Hq * row_elems, rows, row_elems,
      a.Hq / a.Hkv, static_cast<T*>(a.dk), static_cast<T*>(a.dv));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int launch_simt(const BwdArgs& a, cudaStream_t st) {
  using Tl = SimtTile<DP>;
  const Plan p = make_plan(a.B, a.Hq, a.Hkv, a.Sq, a.Skv, a.D, a.causal,
                           a.has_window, a.window, 0);
  cudaError_t e =
      smem_limit_once<fa_bwd_dkdv_simt_kernel<T, DP>>(Tl::DKDV_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = smem_limit_once<fa_bwd_dq_simt_kernel<T, DP>>(Tl::DQ_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  int r = launch_delta<T>(a, st);
  if (r != 0) return r;
  const bool grouped = a.Hq != a.Hkv;
  float* part_k = a.work + p.part_off;
  float* part_v = part_k + (int64_t)a.B * a.Hq * a.Skv * a.D;
  float* ws = a.work + p.ws_off;
  const int nbh = a.B * a.Hq;
  for (int bh0 = 0; bh0 < nbh; bh0 += p.chunk_bh) {
    const int n = min(p.chunk_bh, nbh - bh0);
    if (p.nkt > 0) {
      fa_bwd_dkdv_simt_kernel<T, DP>
          <<<dim3(n, p.nkt), BW_THREADS, Tl::DKDV_SMEM, st>>>(
              static_cast<const T*>(a.q), static_cast<const T*>(a.k),
              static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
              static_cast<const float*>(a.lse), a.work, a.Hq, a.Hkv, a.Sq,
              a.Skv, a.D, a.causal, a.has_window, a.window, a.scale, bh0,
              p.nqt, p.nj, ws, part_k, part_v, static_cast<T*>(a.dk),
              static_cast<T*>(a.dv));
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    fa_bwd_dq_simt_kernel<T, DP>
        <<<dim3(n, (p.nqt + 1) / 2), BW_THREADS, Tl::DQ_SMEM, st>>>(
            static_cast<const T*>(a.k), ws, a.Hq, a.Hkv, a.Sq, a.Skv, a.D,
            a.causal, a.has_window, a.window, bh0, p.nqt, p.nj,
            static_cast<T*>(a.dq));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (grouped && p.nkt > 0) return launch_group_sum<T>(a, p, st);
  return 0;
}

template <typename T>
int launch_simt_d(const BwdArgs& a, cudaStream_t st) {
  if (a.D <= 32) return launch_simt<T, 32>(a, st);
  if (a.D <= 64) return launch_simt<T, 64>(a, st);
  if (a.D <= 128) return launch_simt<T, 128>(a, st);
  return launch_simt<T, 256>(a, st);
}

// ================================================================== tc ==
constexpr int TB_B = 64;                       // queries and keys a tile
constexpr int TB_TILE = TB_B * TB_B;           // elements of a 64 x 64 tile
constexpr int TB_CONSUMERS = 256;              // two warpgroups
constexpr int TB_DKDV_THREADS = TB_CONSUMERS + 32;
constexpr int TB_DQ_THREADS = 128 + 32;        // one warpgroup, a producer
// named barriers of the dK/dV kernel (0 is __syncthreads)
constexpr int BAR_P_READY = 1, BAR_XCH_FREE = 2, BAR_WG0 = 3, BAR_WG1 = 4;

template <int D>
struct TbTile {
  static constexpr int NCH = D / 64;             // 64-column chunks
  static constexpr int ROWS = TB_B * D * 2;      // one 64-row bf16 tile
  // dK/dV (1024-byte aligned): K, V, two stages of Q and dO (NCH chunks of
  // [64 rows][64], 128-byte swizzled), P^T and dS^T ([64 keys][64
  // queries] bf16, swizzled), the P exchange (32 x 128 f32), barriers
  static constexpr int ST_OFF = 2 * ROWS;
  static constexpr int PT_OFF = ST_OFF + 4 * ROWS;
  static constexpr int DST_OFF = PT_OFF + TB_TILE * 2;
  static constexpr int XCH_OFF = DST_OFF + TB_TILE * 2;
  static constexpr int BAR_OFF = XCH_OFF + 32 * 128 * 4;
  static constexpr int DKDV_SMEM = 1024 + BAR_OFF + 8 * 5;
  // dQ: two stages of K, barriers
  static constexpr int DQ_SMEM = 1024 + 2 * ROWS + 8 * 4;
};

// Byte offset of bf16 element (row, col) in a [rows][64] tile with the
// 128-byte swizzle (16-byte chunk index XOR row % 8).
__device__ __forceinline__ uint32_t swz128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + ((col & 7) << 1);
}

template <int D>
__global__ void __launch_bounds__(TB_DKDV_THREADS, 1) fa_bwd_dkdv_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q,    // (B*Hq, Sq, D) bf16
    const __grid_constant__ CUtensorMap tm_k,    // (B*Hkv, Skv, D) bf16
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do,   // like q
    const float* __restrict__ lse, const float* __restrict__ delta, int Hq,
    int Hkv, int Sq, int Skv, int causal, int has_window, long long window,
    float scale, int bh0, int nqt, int nj, __nv_bfloat16* __restrict__ ws,
    float* __restrict__ part_k, float* __restrict__ part_v,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv) {
  using Tl = TbTile<D>;
  constexpr int NCH = Tl::NCH;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t k_s = base, v_s = base + Tl::ROWS;
  const uint32_t bars = base + Tl::BAR_OFF, kv_full = bars;

  const int kt = blockIdx.y, bhl = blockIdx.x, bh = bh0 + bhl;  // as simt
  const int G = Hq / Hkv, b = bh / Hq, hk = (bh % Hq) / G;
  const int k0 = kt * TB_B;
  int qt_begin, qt_end;
  query_tile_range(kt, TB_B, nqt, Skv, causal, has_window, window,
                   &qt_begin, &qt_end);
  auto pair_live = [&](int t) {
    return tile_pair_live(t, kt, TB_B, Sq, Skv, causal, has_window, window);
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);                  // full
      mbar_init(bars + 8 * (3 + s), TB_CONSUMERS);       // empty
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= TB_CONSUMERS) {
    // producer warp: one thread issues every TMA load
    if (tid == TB_CONSUMERS) {
      mbar_arrive_expect_tx(kv_full, 2 * Tl::ROWS);
      for (int c = 0; c < NCH; ++c) {
        tma_load_3d(k_s + c * 8192, &tm_k, kv_full, c * 64, k0, b * Hkv + hk);
        tma_load_3d(v_s + c * 8192, &tm_v, kv_full, c * 64, k0, b * Hkv + hk);
      }
      int it = 0;
      for (int qt = qt_begin; qt < qt_end; ++qt) {
        if (!pair_live(qt)) continue;
        const int st = it & 1;
        const uint32_t q_s = base + Tl::ST_OFF + st * 2 * Tl::ROWS;
        const uint32_t full = bars + 8 * (1 + st);
        mbar_wait(bars + 8 * (3 + st), ((it >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(full, 2 * Tl::ROWS);
        for (int c = 0; c < NCH; ++c) {
          tma_load_3d(q_s + c * 8192, &tm_q, full, c * 64, qt * TB_B, bh);
          tma_load_3d(q_s + Tl::ROWS + c * 8192, &tm_do, full, c * 64,
                      qt * TB_B, bh);
        }
        ++it;
      }
    }
    return;
  }

  // consumers: in the wgmma accumulator layout this thread holds local rows
  // rq and rq + 8 and, for register i, row rq + 8 ((i / 2) % 2) and column
  // 8 (i / 4) + 2 (lane % 4) + (i % 2)
  const int wg = tid >> 7, wt = tid & 127, lane = tid & 31;
  const int rq = (wt >> 5) * 16 + lane / 4;
  float* xch = reinterpret_cast<float*>(gbase + Tl::XCH_OFF);
  const float sl2 = scale * 1.4426950408889634f;
  float acc[D / 2];                       // dV (warpgroup 0) or dK (1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(kv_full, 0);

  int it = 0;
  for (int qt = qt_begin; qt < qt_end; ++qt) {
    if (!pair_live(qt)) continue;
    const int st = it & 1, q0 = qt * TB_B;
    const uint32_t q_s = base + Tl::ST_OFF + st * 2 * Tl::ROWS;
    const uint32_t do_s = q_s + Tl::ROWS;
    // (lse or Delta of rows rq and rq + 8, read before the wait)
    float rowv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = q0 + rq + 8 * r;
      const int64_t row = (int64_t)bh * Sq + qp;
      rowv[r] = qp >= Sq ? 0.f
                : wg == 0 ? lse[row] * 1.4426950408889634f
                          : delta[row];
    }
    mbar_wait(bars + 8 * (1 + st), (it >> 1) & 1);

    // S = Q K^T (warpgroup 0) or dP = dO V^T (warpgroup 1): 64 x 64
    float s[32];
    const uint32_t a_s = wg == 0 ? q_s : do_s, b_s = wg == 0 ? k_s : v_s;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(s, desc_b128(a_s + c * 8192 + kk * 32, 16, 1024),
                     desc_b128(b_s + c * 8192 + kk * 32, 16, 1024), c | kk);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 32; ++i) reg_fence(s[i]);

    const uint32_t at_off = wg == 0 ? Tl::PT_OFF : Tl::DST_OFF;
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const bool on = live(q0 + rq + 8 * r,
                             k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1), Sq,
                             Skv, causal, has_window, window);
        s[i] = on ? exp2f(s[i] * sl2 - rowv[r]) : 0.f;
      }
      if (it > 0) named_bar_sync(BAR_XCH_FREE, TB_CONSUMERS);
#pragma unroll
      for (int i = 0; i < 32; ++i) xch[i * 128 + wt] = s[i];
    } else {
      named_bar_sync(BAR_P_READY, TB_CONSUMERS);
#pragma unroll
      for (int i = 0; i < 32; ++i)                               // dS
        s[i] = xch[i * 128 + wt] * (s[i] - rowv[(i >> 1) & 1]) * scale;
      named_bar_arrive(BAR_XCH_FREE, TB_CONSUMERS);
      // dS as the dQ pass's A fragments (the registers of each 16-key slice)
      uint4* wtile = reinterpret_cast<uint4*>(
          ws + (((int64_t)bhl * nqt + qt) * nj +
                (kt - first_key_tile(qt, TB_B, has_window, window))) *
                   TB_TILE);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wtile[kc * 128 + wt] = make_uint4(
            pack_bf16(s[8 * kc], s[8 * kc + 1]),
            pack_bf16(s[8 * kc + 2], s[8 * kc + 3]),
            pack_bf16(s[8 * kc + 4], s[8 * kc + 5]),
            pack_bf16(s[8 * kc + 6], s[8 * kc + 7]));
    }
    // P^T (warpgroup 0) or dS^T (1) as bf16 [key][query], wgmma's A
#pragma unroll
    for (int i = 0; i < 32; ++i)
      *reinterpret_cast<__nv_bfloat16*>(
          gbase + at_off +
          swz128(8 * (i >> 2) + 2 * (lane & 3) + (i & 1),
                 rq + 8 * ((i >> 1) & 1))) = __float2bfloat16(s[i]);
    fence_proxy_async();
    if (wg == 0) named_bar_arrive(BAR_P_READY, TB_CONSUMERS);
    named_bar_sync(wg == 0 ? BAR_WG0 : BAR_WG1, 128);

    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1): M 64 keys, K 64
    // queries, N = D; the B tile [query][d] is N-major
    const uint32_t bt_s = wg == 0 ? do_s : q_s;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint64_t da = desc_b128(base + at_off + kc * 32, 16, 1024);
      if constexpr (D == 64) {
        wgmma_ss_n64_tb(acc, da, desc_b128(bt_s + kc * 2048, 8192, 1024));
      } else {
#pragma unroll
        for (int j = 0; j < D / 128; ++j)
          wgmma_ss_n128_tb(acc + 64 * j, da,
                           desc_b128(bt_s + 2 * j * 8192 + kc * 2048, 8192,
                                     1024));
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) reg_fence(acc[i]);
    mbar_arrive(bars + 8 * (3 + st));       // the stage may refill
    ++it;
  }
  // the last exchange has been read
  if (wg == 0 && it > 0) named_bar_sync(BAR_XCH_FREE, TB_CONSUMERS);

  float* part = wg == 0 ? part_v : part_k;
  __nv_bfloat16* grad = wg == 0 ? dv : dk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = k0 + rq + 8 * r;
    if (kp >= Skv) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * r, col = 8 * j + 2 * (lane & 3);
      if (G == 1)
        *reinterpret_cast<uint32_t*>(
            grad + (((int64_t)b * Hkv + hk) * Skv + kp) * D + col) =
            pack_bf16(acc[i], acc[i + 1]);
      else
        *reinterpret_cast<float2*>(part + ((int64_t)bh * Skv + kp) * D + col) =
            make_float2(acc[i], acc[i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(TB_DQ_THREADS, 1) fa_bwd_dq_tc_kernel(
    const __grid_constant__ CUtensorMap tm_k,    // (B*Hkv, Skv, D) bf16
    const __nv_bfloat16* __restrict__ ws, int Hq, int Hkv, int Sq, int Skv,
    int causal, int has_window, long long window, int bh0, int nqt, int nj,
    __nv_bfloat16* __restrict__ dq) {
  using Tl = TbTile<D>;
  constexpr int NCH = Tl::NCH;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + 2 * Tl::ROWS;

  const int qt = gridDim.y - 1 - blockIdx.y, bhl = blockIdx.x,
            bh = bh0 + bhl;                      // the last tiles first
  const int b = bh / Hq, hk = (bh % Hq) / (Hq / Hkv);
  const int nkt = (Skv + TB_B - 1) / TB_B;
  const int kt_first = first_key_tile(qt, TB_B, has_window, window);
  const int kt_end = key_tile_end(qt, TB_B, nkt, Sq, causal);
  auto pair_live = [&](int t) {
    return tile_pair_live(qt, t, TB_B, Sq, Skv, causal, has_window, window);
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(bars + 8 * s, 1);                  // full
      mbar_init(bars + 8 * (2 + s), 128);          // empty
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128) {
    if (tid == 128) {
      int it = 0;
      for (int kt = kt_first; kt < kt_end; ++kt) {
        if (!pair_live(kt)) continue;
        const int st = it & 1;
        const uint32_t full = bars + 8 * st;
        mbar_wait(bars + 8 * (2 + st), ((it >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(full, Tl::ROWS);
        for (int c = 0; c < NCH; ++c)
          tma_load_3d(base + st * Tl::ROWS + c * 8192, &tm_k, full, c * 64,
                      kt * TB_B, b * Hkv + hk);
        ++it;
      }
    }
    return;
  }

  const int lane = tid & 31, rq = (tid >> 5) * 16 + lane / 4;
  const uint4* wsq = reinterpret_cast<const uint4*>(
      ws + ((int64_t)bhl * nqt + qt) * nj * TB_TILE);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  int it = 0;
  for (int kt = kt_first; kt < kt_end; ++kt) {
    if (!pair_live(kt)) continue;
    const int st = it & 1;
    const uint32_t k_s = base + st * Tl::ROWS;
    const uint4* tile = wsq + (int64_t)(kt - kt_first) * (TB_TILE / 8);
    uint32_t a[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint4 f = tile[kc * 128 + tid];
      a[kc][0] = f.x; a[kc][1] = f.y; a[kc][2] = f.z; a[kc][3] = f.w;
    }
    mbar_wait(bars + 8 * st, (it >> 1) & 1);
    // dQ += dS K: K [key][d] is N-major, 16 keys (2048 bytes) a step
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      if constexpr (D == 64) {
        wgmma_rs_n64_tb(acc, a[kc], desc_b128(k_s + kc * 2048, 8192, 1024));
      } else {
#pragma unroll
        for (int j = 0; j < D / 128; ++j)
          wgmma_rs_n128_tb(acc + 64 * j, a[kc],
                           desc_b128(k_s + 2 * j * 8192 + kc * 2048, 8192,
                                     1024));
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) reg_fence(acc[i]);
    mbar_arrive(bars + 8 * (2 + st));
    ++it;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qt * TB_B + rq + 8 * r;
    if (qp >= Sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * r, col = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(dq + ((int64_t)bh * Sq + qp) * D + col) =
          pack_bf16(acc[i], acc[i + 1]);
    }
  }
}

template <int D>
int launch_tc(const BwdArgs& a, cudaStream_t st) {
  using Tl = TbTile<D>;
  const Plan p = make_plan(a.B, a.Hq, a.Hkv, a.Sq, a.Skv, D, a.causal,
                           a.has_window, a.window, 1);
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, a.q, a.B * a.Hq, a.Sq, D, TB_B) ||
      !make_map(&tk, a.k, a.B * a.Hkv, a.Skv, D, TB_B) ||
      !make_map(&tv, a.v, a.B * a.Hkv, a.Skv, D, TB_B) ||
      !make_map(&tdo, a.dout, a.B * a.Hq, a.Sq, D, TB_B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = smem_limit_once<fa_bwd_dkdv_tc_kernel<D>>(Tl::DKDV_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = smem_limit_once<fa_bwd_dq_tc_kernel<D>>(Tl::DQ_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  int r = launch_delta<__nv_bfloat16>(a, st);
  if (r != 0) return r;
  float* part_k = a.work + p.part_off;
  float* part_v = part_k + (int64_t)a.B * a.Hq * a.Skv * D;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(a.work + p.ws_off);
  const int nbh = a.B * a.Hq;
  for (int bh0 = 0; bh0 < nbh; bh0 += p.chunk_bh) {
    const int n = min(p.chunk_bh, nbh - bh0);
    fa_bwd_dkdv_tc_kernel<D>
        <<<dim3(n, p.nkt), TB_DKDV_THREADS, Tl::DKDV_SMEM, st>>>(
            tq, tk, tv, tdo, static_cast<const float*>(a.lse), a.work, a.Hq,
            a.Hkv, a.Sq, a.Skv, a.causal, a.has_window, a.window, a.scale,
            bh0, p.nqt, p.nj, ws, part_k, part_v,
            static_cast<__nv_bfloat16*>(a.dk),
            static_cast<__nv_bfloat16*>(a.dv));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    fa_bwd_dq_tc_kernel<D><<<dim3(n, p.nqt), TB_DQ_THREADS, Tl::DQ_SMEM, st>>>(
        tk, ws, a.Hq, a.Hkv, a.Sq, a.Skv, a.causal, a.has_window, a.window,
        bh0, p.nqt, p.nj, static_cast<__nv_bfloat16*>(a.dq));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (a.Hq != a.Hkv) return launch_group_sum<__nv_bfloat16>(a, p, st);
  return 0;
}

}  // namespace

// Floats of the workspace a call needs (Delta, the group's partials, the
// dS tiles of one chunk); tc = 1 for the tensor-core variant.
extern "C" long long flash_attention_bwd_workspace_floats(
    int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
    int has_window, long long window, int tc) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0) return 0;
  return make_plan(B, Hq, Hkv, Sq, Skv, D, causal, has_window, window, tc)
      .total;
}

// The SIMT variant.  q, dout, out, dq: (B, Hq, Sq, D); k, v, dk, dv: (B,
// Hkv, Skv, D); lse: f32 (B, Hq, Sq); workspace: the floats
// flash_attention_bwd_workspace_floats(..., 0) gives.  D a multiple of 8
// and at most 256, Hq a multiple of Hkv, every tensor contiguous and 16-byte
// aligned (the wrapper checks).  has_window = 0 means no window; is_bf16
// selects bf16 over f32.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, int B, int Hq, int Hkv, int Sq,
    int Skv, int D, int causal, int has_window, long long window, float scale,
    int is_bf16, void* workspace, void* dq, void* dk, void* dv,
    void* stream) {
  if (D % 8 != 0 || D > 256 || D < 8 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0 || Sq == 0)
    return static_cast<int>(cudaGetLastError());
  const BwdArgs a{q, k, v, out, lse, dout, B, Hq, Hkv, Sq, Skv, D, causal,
                  has_window, window, scale,
                  static_cast<float*>(workspace), dq, dk, dv};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_simt_d<__nv_bfloat16>(a, st)
                 : launch_simt_d<float>(a, st);
}

// The tensor-core variant: bf16 only, D in {64, 128, 256}, Skv >= 1;
// workspace as flash_attention_bwd_workspace_floats(..., 1) gives.
extern "C" int flash_attention_bwd_tc_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, int B, int Hq, int Hkv, int Sq,
    int Skv, int D, int causal, int has_window, long long window, float scale,
    void* workspace, void* dq, void* dk, void* dv, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0 || Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0 || Sq == 0)
    return static_cast<int>(cudaGetLastError());
  const BwdArgs a{q, k, v, out, lse, dout, B, Hq, Hkv, Sq, Skv, D, causal,
                  has_window, window, scale,
                  static_cast<float*>(workspace), dq, dk, dv};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_tc<64>(a, st);
    case 128: return launch_tc<128>(a, st);
    case 256: return launch_tc<256>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
