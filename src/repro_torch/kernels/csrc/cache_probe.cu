// Set-associative cache tag probe for Hopper (sm_90a).
//
// Replaces: cache_probe_pallas / _probe_kernel in src/repro/kernels/cache_probe.py.
// The TPU kernel gathers the directory rows with a one-hot MXU matmul (and a
// 16-bit split for exact int32); here each thread reads its keys' set rows
// directly.
//
// Bound: memory.  Per key the kernel moves its own 4 B key, one or two 32 B
// sectors of the tag and owner rows, and 5 B of output; no arithmetic worth
// counting.  At the main path's 262,144 keys that is under 1 us at the
// card's memory rate, below the fixed cost of a launch.  The directory rows
// are scattered reads served from L2 (a 16,384 x 4 directory is 256 KiB
// per field), one 32-byte sector a row, and on an H100 those sector reads
// take about 3 us at this shape, above the byte bound: so the kernel reads
// the owner row only where a tag matches.  Design: one thread per key in a
// grid-stride loop, neighbouring threads on neighbouring keys so key loads
// and result stores coalesce; the tag row (and, on a tag match, the owner
// row) read as int4 vectors when ways % 4 == 0, scalar loads otherwise.
// Four keys a thread, their four rows loaded before any was compared, ran
// 1 us slower on the H100 than one key a thread (5.7 against 4.6 us of
// device time at the main path's shape): fewer threads kept fewer row
// reads in flight.
#include "common.cuh"

// The flat slot of `key` in its set's row, or -1.  With VEC the row is read
// as int4 vectors, and the owner row only where a tag matches.
template <bool VEC>
__device__ __forceinline__ int32_t probe_row(const int32_t* __restrict__ tags,
                                             const int32_t* __restrict__ owner,
                                             int32_t key, int32_t set,
                                             int32_t ways, int32_t tenant) {
  if (key < 0) return -1;
  const int64_t row = (int64_t)set * ways;
  if (VEC) {
    for (int32_t w = 0; w < ways; w += 4) {
      const int4 t = reinterpret_cast<const int4*>(tags + row)[w / 4];
      if (t.x != key && t.y != key && t.z != key && t.w != key) continue;
      int4 o = make_int4(tenant, tenant, tenant, tenant);
      if (owner != nullptr)
        o = reinterpret_cast<const int4*>(owner + row)[w / 4];
      if (t.x == key && o.x == tenant) return set * ways + w;
      if (t.y == key && o.y == tenant) return set * ways + w + 1;
      if (t.z == key && o.z == tenant) return set * ways + w + 2;
      if (t.w == key && o.w == tenant) return set * ways + w + 3;
    }
    return -1;
  }
  for (int32_t w = 0; w < ways; ++w)
    if (tags[row + w] == key && (owner == nullptr || owner[row + w] == tenant))
      return set * ways + w;
  return -1;
}

// slot[i] = the flat slot of key i, or -1; hit[i] = slot[i] >= 0.  Invalid
// keys hash as key 0, as in the reference, and never hit.
template <bool VEC>
__global__ void cache_probe_kernel(const int32_t* __restrict__ tags,
                                   const int32_t* __restrict__ owner,
                                   const int32_t* __restrict__ keys,
                                   int64_t m, int32_t num_sets, int32_t ways,
                                   int32_t tenant, uint8_t* __restrict__ hit,
                                   int32_t* __restrict__ slot) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < m;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int32_t key = keys[i];
    const int32_t set = mix_hash(key >= 0 ? key : 0) % num_sets;
    const int32_t s = probe_row<VEC>(tags, owner, key, set, ways, tenant);
    slot[i] = s;
    hit[i] = s >= 0 ? 1 : 0;
  }
}

// out: slot (int32 x m), then hit (one byte x m).
extern "C" int cache_probe_launch(const void* tags, const void* owner,
                                  const void* keys, int64_t m, int num_sets,
                                  int ways, int tenant, void* out,
                                  void* stream) {
  if (m > 0) {
    const auto t = static_cast<const int32_t*>(tags);
    const auto o = static_cast<const int32_t*>(owner);
    const auto k = static_cast<const int32_t*>(keys);
    int32_t* slot = static_cast<int32_t*>(out);
    uint8_t* hit = reinterpret_cast<uint8_t*>(slot + m);
    const int threads = 256;
    const unsigned grid = grid_for(m, threads);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = ways % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(tags) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(owner) % 16 == 0;
    if (vec)
      cache_probe_kernel<true><<<grid, threads, 0, st>>>(
          t, o, k, m, num_sets, ways, tenant, hit, slot);
    else
      cache_probe_kernel<false><<<grid, threads, 0, st>>>(
          t, o, k, m, num_sets, ways, tenant, hit, slot);
  }
  return static_cast<int>(cudaGetLastError());
}
