// Paged block gather for Hopper (sm_90a): the BamArray hit data path.
//
// Replaces: gather_blocks_pallas in src/repro/kernels/gather_blocks.py (its
// inline kernel; the TPU version DMAs one whole line per grid step, indexed
// by a scalar-prefetched slot vector), plus the element pick that
// repro.kernels.ops.gather_blocks(off=) applies after it.
//
// Bound: memory.  The element gather moves per lane a 4 B slot, a 4 B
// offset, one element read from a scattered line (one 32 B sector) and one
// element written; the line gather moves one line in and one line out per
// row.  Design: the element gather is one thread per lane in a grid-stride
// loop, so slot/offset loads and stores coalesce and only the data read is
// scattered -- it never moves a whole line to deliver one element.  The line
// gather gives each output row one block, which copies the row with 16-byte
// vector loads and stores when the row is a multiple of 16 bytes (element
// copies otherwise).  Both zero the output where slot < 0.  Elements are
// moved as raw 2- or 4-byte words, so f32, int32 and bf16 share the code.
#include "common.cuh"

template <typename T>
__global__ void gather_elems_kernel(const T* __restrict__ data,
                                    const int32_t* __restrict__ slots,
                                    const int32_t* __restrict__ off,
                                    int64_t n, int64_t line_elems,
                                    T* __restrict__ out) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int32_t s = slots[i];
    out[i] = s >= 0 ? data[(int64_t)s * line_elems + off[i]] : T(0);
  }
}

template <typename V>
__device__ __forceinline__ V zero_of();
template <>
__device__ __forceinline__ uint4 zero_of<uint4>() { return make_uint4(0, 0, 0, 0); }
template <>
__device__ __forceinline__ uint32_t zero_of<uint32_t>() { return 0u; }
template <>
__device__ __forceinline__ uint16_t zero_of<uint16_t>() { return 0; }

template <typename V>
__global__ void gather_lines_kernel(const V* __restrict__ data,
                                    const int32_t* __restrict__ slots,
                                    int64_t n, int64_t row_words,
                                    V* __restrict__ out) {
  for (int64_t r = blockIdx.x; r < n; r += gridDim.x) {
    const int32_t s = slots[r];
    V* dst = out + r * row_words;
    if (s >= 0) {
      const V* src = data + (int64_t)s * row_words;
      for (int64_t j = threadIdx.x; j < row_words; j += blockDim.x) dst[j] = src[j];
    } else {
      const V z = zero_of<V>();
      for (int64_t j = threadIdx.x; j < row_words; j += blockDim.x) dst[j] = z;
    }
  }
}

extern "C" int gather_elems_launch(const void* data, const void* slots,
                                   const void* off, int64_t n,
                                   int64_t line_elems, int elem_bytes,
                                   void* out, void* stream) {
  if (n > 0) {
    const int threads = 256;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t* sl = static_cast<const int32_t*>(slots);
    const int32_t* of = static_cast<const int32_t*>(off);
    if (elem_bytes == 4) {
      gather_elems_kernel<uint32_t><<<grid_for(n, threads), threads, 0, st>>>(
          static_cast<const uint32_t*>(data), sl, of, n, line_elems,
          static_cast<uint32_t*>(out));
    } else if (elem_bytes == 2) {
      gather_elems_kernel<uint16_t><<<grid_for(n, threads), threads, 0, st>>>(
          static_cast<const uint16_t*>(data), sl, of, n, line_elems,
          static_cast<uint16_t*>(out));
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_lines_launch(const void* data, const void* slots,
                                   int64_t n, int64_t line_elems,
                                   int elem_bytes, void* out, void* stream) {
  if (n > 0) {
    const int threads = 256;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t* sl = static_cast<const int32_t*>(slots);
    const int64_t row_bytes = line_elems * elem_bytes;
    const unsigned grid = static_cast<unsigned>(n < 132 * 64 ? n : 132 * 64);
    const bool aligned = reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (aligned && row_bytes % 16 == 0) {
      gather_lines_kernel<uint4><<<grid, threads, 0, st>>>(
          static_cast<const uint4*>(data), sl, n, row_bytes / 16,
          static_cast<uint4*>(out));
    } else if (elem_bytes == 4) {
      gather_lines_kernel<uint32_t><<<grid, threads, 0, st>>>(
          static_cast<const uint32_t*>(data), sl, n, line_elems,
          static_cast<uint32_t*>(out));
    } else if (elem_bytes == 2) {
      gather_lines_kernel<uint16_t><<<grid, threads, 0, st>>>(
          static_cast<const uint16_t*>(data), sl, n, line_elems,
          static_cast<uint16_t*>(out));
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
