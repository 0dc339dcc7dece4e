// Shared device helpers for the BaM hot-path kernels.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

// Knuth multiplicative set hash, bit-identical to repro_torch.utils.mix_hash:
// plain uint32 arithmetic wraps modulo 2^32 as the reference's uint32 does.
__device__ __forceinline__ int32_t mix_hash(int32_t key) {
  uint32_t k = static_cast<uint32_t>(key);
  k = k * 2654435761u;
  k = k ^ (k >> 16);
  return static_cast<int32_t>(k & 0x7fffffffu);
}

// Grid size for a grid-stride loop over n items: enough blocks to fill the
// card several times over, never more than the items need.
inline unsigned grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t cap = 132 * 32;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}
