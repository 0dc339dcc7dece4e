// Set-associative cache tag probe for Hopper (sm_90a).
//
// Replaces: cache_probe_pallas / _probe_kernel in src/repro/kernels/cache_probe.py.
// The TPU kernel gathers the directory rows with a one-hot MXU matmul (and a
// 16-bit split for exact int32); here each thread reads its key's set row
// directly.
//
// Bound: memory.  Per key the kernel moves its own 4 B key, one or two 32 B
// sectors of the tag and owner rows, and 5 B of output; no arithmetic worth
// counting.  Design: one thread per key in a grid-stride loop, neighbouring
// threads on neighbouring keys so key loads and result stores coalesce; the
// directory rows are scattered reads served from L2 (a 16,384 x 4 directory
// is 256 KiB per field).
#include "common.cuh"

__global__ void cache_probe_kernel(const int32_t* __restrict__ tags,
                                   const int32_t* __restrict__ owner,
                                   const int32_t* __restrict__ keys,
                                   int64_t m, int32_t num_sets, int32_t ways,
                                   int32_t tenant, uint8_t* __restrict__ hit,
                                   int32_t* __restrict__ slot) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < m;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int32_t key = keys[i];
    const bool valid = key >= 0;
    // invalid keys hash as key 0, as in the reference
    const int32_t set = mix_hash(valid ? key : 0) % num_sets;
    const int64_t row = (int64_t)set * ways;
    int32_t found = -1;
    if (valid) {
      for (int32_t w = 0; w < ways; ++w) {
        if (tags[row + w] == key &&
            (owner == nullptr || owner[row + w] == tenant)) {
          found = w;
          break;
        }
      }
    }
    hit[i] = found >= 0 ? 1 : 0;
    slot[i] = found >= 0 ? set * ways + found : -1;
  }
}

extern "C" int cache_probe_launch(const void* tags, const void* owner,
                                  const void* keys, int64_t m, int num_sets,
                                  int ways, int tenant, void* hit, void* slot,
                                  void* stream) {
  if (m > 0) {
    const int threads = 256;
    cache_probe_kernel<<<grid_for(m, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(tags), static_cast<const int32_t*>(owner),
        static_cast<const int32_t*>(keys), m, num_sets, ways, tenant,
        static_cast<uint8_t*>(hit), static_cast<int32_t*>(slot));
  }
  return static_cast<int>(cudaGetLastError());
}
