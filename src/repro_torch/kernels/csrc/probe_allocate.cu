// Fused cache probe + class-then-clock victim select for Hopper (sm_90a).
//
// Replaces: probe_allocate_pallas / _pa_kernel in
// src/repro/kernels/probe_allocate.py.  The TPU kernel gathers every
// directory row through one-hot MXU matmuls (16-bit halves for exact int32),
// scatters the protect overlay by matmul, and ranks same-set misses with a
// cumsum over an (m, S) one-hot matrix.  None of that is carried over: rows
// are read directly, and the rank comes from a per-set bucket of misses.
//
// Result contract: exactly the way probe_allocate_ref gives.  A miss's rank is
// its order, by request index, among the misses of its set; the k-th ranked
// miss takes the k-th eligible way in (class * ways + clock position) order.
// No atomic decides a result: atomics only fill buckets, whose order is then
// ignored (the rank counts smaller request indices).
//
// Bound: memory.  Per key: its 4 B key and 1 B alloc flag, one set row of
// five directory fields plus the clock hand, 18 B of output; the per-set
// count, offset and bucket arrays add a few bytes per key.  Design, one
// launch each on the caller's stream:
//   1. probe: one thread per key -- set hash, tag+owner probe, miss flag;
//      hits mark their (set, way) in a byte protect overlay (idempotent 1s)
//      and misses count into their set's bucket size;
//   2. protect: mark the caller's protect_slots in the overlay;
//   3. scan: one block takes the exclusive prefix sum of the bucket sizes;
//   4. bucket: each miss appends its request index to its set's bucket;
//   5. victim: one thread per miss counts smaller request indices in its
//      bucket (its rank) and picks the way.
// The rank pass is O(bucket size) per miss: about 16 at the main path's
// 262,144 keys over 16,384 sets, quadratic only if the hash sends most keys
// to one set.
#include "common.cuh"

constexpr int kMaxWays = 32;

__global__ void pa_probe_kernel(const int32_t* __restrict__ tags,
                                const int32_t* __restrict__ owner,
                                const int32_t* __restrict__ keys,
                                const uint8_t* __restrict__ amask, int64_t m,
                                int32_t num_sets, int32_t ways, int32_t tenant,
                                int protect_hits, uint8_t* __restrict__ hit,
                                int32_t* __restrict__ hslot,
                                int32_t* __restrict__ sets,
                                uint8_t* __restrict__ miss,
                                uint8_t* __restrict__ prot,
                                int32_t* __restrict__ count) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < m;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int32_t key = keys[i];
    const bool valid = key >= 0;
    const int32_t set = mix_hash(valid ? key : 0) % num_sets;
    const int64_t row = (int64_t)set * ways;
    int32_t found = -1;
    if (valid) {
      for (int32_t w = 0; w < ways; ++w) {
        if (tags[row + w] == key && owner[row + w] == tenant) {
          found = w;
          break;
        }
      }
    }
    const bool is_hit = found >= 0;
    const bool is_miss = valid && !is_hit && (amask == nullptr || amask[i]);
    hit[i] = is_hit ? 1 : 0;
    hslot[i] = is_hit ? set * ways + found : -1;
    sets[i] = set;
    miss[i] = is_miss ? 1 : 0;
    if (protect_hits && is_hit) prot[row + found] = 1;
    if (is_miss) atomicAdd(&count[set], 1);
  }
}

__global__ void pa_protect_kernel(const int32_t* __restrict__ protect_slots,
                                  int64_t p, int64_t num_lines,
                                  uint8_t* __restrict__ prot) {
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < p;
       j += (int64_t)gridDim.x * blockDim.x) {
    const int32_t s = protect_slots[j];
    if (s >= 0 && s < num_lines) prot[s] = 1;
  }
}

// Exclusive prefix sum of count[0:n] into offsets and cursor, one block.
__global__ void pa_scan_kernel(const int32_t* __restrict__ count, int32_t n,
                               int32_t* __restrict__ offsets,
                               int32_t* __restrict__ cursor) {
  __shared__ int32_t sums[1024];
  const int tid = threadIdx.x;
  const int chunk = (n + blockDim.x - 1) / blockDim.x;
  const int beg = tid * chunk;
  const int end = min(beg + chunk, n);
  int32_t local = 0;
  for (int k = beg; k < end; ++k) local += count[k];
  sums[tid] = local;
  __syncthreads();
  for (int d = 1; d < blockDim.x; d <<= 1) {
    const int32_t v = tid >= d ? sums[tid - d] : 0;
    __syncthreads();
    sums[tid] += v;
    __syncthreads();
  }
  int32_t run = tid > 0 ? sums[tid - 1] : 0;
  for (int k = beg; k < end; ++k) {
    offsets[k] = run;
    cursor[k] = run;
    run += count[k];
  }
}

__global__ void pa_bucket_kernel(const int32_t* __restrict__ sets,
                                 const uint8_t* __restrict__ miss, int64_t m,
                                 int32_t* __restrict__ cursor,
                                 int32_t* __restrict__ bucket) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < m;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (miss[i]) {
      const int32_t pos = atomicAdd(&cursor[sets[i]], 1);
      bucket[pos] = static_cast<int32_t>(i);
    }
  }
}

__global__ void pa_victim_kernel(
    const int32_t* __restrict__ tags, const int32_t* __restrict__ owner,
    const int32_t* __restrict__ refcount, const uint8_t* __restrict__ dirty,
    const uint8_t* __restrict__ spec, const int32_t* __restrict__ clock_hand,
    const int32_t* __restrict__ sets, const uint8_t* __restrict__ miss,
    const uint8_t* __restrict__ prot, const int32_t* __restrict__ count,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ bucket,
    int64_t m, int32_t ways, int32_t tenant, int32_t way_lo, int32_t way_hi,
    int spec_insert, int32_t* __restrict__ way_out, uint8_t* __restrict__ ok_out,
    int32_t* __restrict__ evk_out, uint8_t* __restrict__ evd_out) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < m;
       i += (int64_t)gridDim.x * blockDim.x) {
    int32_t way = -1, evk = -1;
    bool ok = false, evd = false;
    if (miss[i]) {
      const int32_t set = sets[i];
      const int32_t beg = offsets[set];
      const int32_t cnt = count[set];
      int32_t rank = 0;
      for (int32_t k = 0; k < cnt; ++k) rank += bucket[beg + k] < i ? 1 : 0;

      const int64_t row = (int64_t)set * ways;
      const int32_t hand = clock_hand[set];
      int32_t key_w[kMaxWays];
      bool elig[kMaxWays];
      int32_t n_elig = 0;
      for (int32_t w = 0; w < ways; ++w) {
        const int32_t tag = tags[row + w];
        const bool d = dirty[row + w] != 0;
        const bool sp = spec[row + w] != 0;
        bool e = refcount[row + w] == 0;
        e = e && !(owner[row + w] != tenant && tag >= 0 && d);  // foreign dirty
        e = e && w >= way_lo && w < way_hi;
        if (spec_insert) e = e && !(sp && tag >= 0);
        e = e && prot[row + w] == 0;
        const int32_t vclass = tag < 0 ? 0 : (sp ? 1 : 2);
        // (w - hand) mod ways as a floor modulo: C's % truncates
        key_w[w] = vclass * ways + (w - hand + ways) % ways;
        elig[w] = e;
        n_elig += e ? 1 : 0;
      }
      if (n_elig > rank) {
        for (int32_t w = 0; w < ways; ++w) {
          if (!elig[w]) continue;
          int32_t eidx = 0;
          for (int32_t v = 0; v < ways; ++v)
            eidx += (elig[v] && key_w[v] < key_w[w]) ? 1 : 0;
          if (eidx == rank) {
            way = w;
            break;
          }
        }
        ok = true;
        evk = tags[row + way];
        evd = dirty[row + way] != 0;
      }
    }
    way_out[i] = way;
    ok_out[i] = ok ? 1 : 0;
    evk_out[i] = evk;
    evd_out[i] = evd ? 1 : 0;
  }
}

extern "C" int probe_allocate_launch(
    const void* tags, const void* owner, const void* refcount,
    const void* dirty, const void* spec, const void* clock_hand,
    const void* keys, const void* amask, int64_t m, const void* protect_slots,
    int64_t p, int num_sets, int ways, int tenant, int way_lo, int way_hi,
    int spec_insert, int protect_hits, void* hit, void* hslot, void* way,
    void* ok, void* evk, void* evd, void* sets, void* miss, void* prot,
    void* count, void* offsets, void* cursor, void* bucket, void* stream) {
  if (ways > kMaxWays) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int64_t num_lines = (int64_t)num_sets * ways;
  cudaMemsetAsync(prot, 0, num_lines, st);
  cudaMemsetAsync(count, 0, sizeof(int32_t) * num_sets, st);
  pa_probe_kernel<<<grid_for(m, threads), threads, 0, st>>>(
      static_cast<const int32_t*>(tags), static_cast<const int32_t*>(owner),
      static_cast<const int32_t*>(keys), static_cast<const uint8_t*>(amask), m,
      num_sets, ways, tenant, protect_hits, static_cast<uint8_t*>(hit),
      static_cast<int32_t*>(hslot), static_cast<int32_t*>(sets),
      static_cast<uint8_t*>(miss), static_cast<uint8_t*>(prot),
      static_cast<int32_t*>(count));
  if (protect_slots != nullptr && p > 0) {
    pa_protect_kernel<<<grid_for(p, threads), threads, 0, st>>>(
        static_cast<const int32_t*>(protect_slots), p, num_lines,
        static_cast<uint8_t*>(prot));
  }
  pa_scan_kernel<<<1, 1024, 0, st>>>(static_cast<const int32_t*>(count),
                                     num_sets, static_cast<int32_t*>(offsets),
                                     static_cast<int32_t*>(cursor));
  pa_bucket_kernel<<<grid_for(m, threads), threads, 0, st>>>(
      static_cast<const int32_t*>(sets), static_cast<const uint8_t*>(miss), m,
      static_cast<int32_t*>(cursor), static_cast<int32_t*>(bucket));
  pa_victim_kernel<<<grid_for(m, threads), threads, 0, st>>>(
      static_cast<const int32_t*>(tags), static_cast<const int32_t*>(owner),
      static_cast<const int32_t*>(refcount),
      static_cast<const uint8_t*>(dirty), static_cast<const uint8_t*>(spec),
      static_cast<const int32_t*>(clock_hand),
      static_cast<const int32_t*>(sets), static_cast<const uint8_t*>(miss),
      static_cast<const uint8_t*>(prot), static_cast<const int32_t*>(count),
      static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(bucket), m, ways, tenant, way_lo, way_hi,
      spec_insert, static_cast<int32_t*>(way), static_cast<uint8_t*>(ok),
      static_cast<int32_t*>(evk), static_cast<uint8_t*>(evd));
  return static_cast<int>(cudaGetLastError());
}
