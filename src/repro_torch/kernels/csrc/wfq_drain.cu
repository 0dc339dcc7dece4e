// Closed-form drain accounting for Hopper (sm_90a).
//
// Replaces: ops.wfq_drain in src/repro/kernels/ops.py (the jnp
// wfq_drain_ref, an XLA graph on every backend of the reference); its plain
// version here is kernels/ref.py:wfq_drain_ref, which it matches bit for
// bit.
//
// What it computes, over the num_queues x depth ring entries (pending where
// sq_key >= 0; queue q belongs to device q / group): the pending count, its
// split by device, by tenant and into reads and writes, and with an enabled
// fault model each pending command's bounded retry loop in closed form, as
// core/ssd.py:FaultModel.command_status does (a command without a ticket
// succeeds; on a hard-failed device it errors at once with no retries; else
// attempt a fails where the low 24 bits of the murmur3 finalizer of the
// four uint32 products are under `threshold`, and the command is retried
// while its leading attempts fail, up to `retry_budget`), summed into the
// error, retry and transient-failure counts, and on request each entry's
// status (1 where a pending command errored, else 0).
//
// Design: one grid-stride pass, 256 threads a block, all lanes of a warp in
// step.  Each block keeps its counters in shared memory as int32 and adds
// them to the output with one integer atomicAdd a counter; a warp whose
// lanes share a counter adds its sum once (__reduce_add_sync), and a warp
// with no pending entry adds nothing.  Integer sums do not depend on order,
// so the result is the same bit for bit in every run.  reads_dev and
// err_reads_dev are counted directly (pending reads), which equals the
// plain version's difference of two integer counts.  A pending entry whose
// tenant lies outside [0, n_tenants) is left out of the per-tenant counts,
// where the plain version's index_add_ raises: the two differ only on
// rings that no enqueue wrote (an enqueue stamps its caller's tenant id).
//
// Bound: memory.  Each entry reads its key (4 B), is_write (1 B), tenant
// (4 B) and with faults its ticket (4 B); the outputs are a few hundred
// bytes.  At the rings of the main path (16 x 4096) that is under a
// microsecond, below the cost of a launch.  The status, when asked for,
// writes 4 B an entry.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 32;
constexpr int kMaxTenants = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFaultProbBits = 24;

// int32 output words, in order
enum : int {
  kCount = 0,
  kTransient = 1,
  kPerDevice = 2,   // then 8 arrays of nd: see the field order below
};
enum DevField : int {
  kCountDev = 0, kReadsDev, kWritesDev, kErrorsDev, kErrReadsDev,
  kErrWritesDev, kRetryReadsDev, kRetryWritesDev, kDevFields
};
// then count_tenant (nt), errors_tenant (nt)

struct DrainParams {
  int64_t n;            // num_queues * depth
  int64_t group;        // entries a device: (num_queues / nd) * depth
  int32_t nd, nt;
  int32_t fault;        // 0: no fault model
  int32_t retry_budget;
  uint32_t threshold;   // failure probability in units of 2^-24
  uint32_t seed_term;   // (seed * 0x27D4EB2F) mod 2^32
  uint32_t failed_mask; // bit d: device d hard-failed
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// FaultModel.attempt_failed: uint32 products wrap modulo 2^32.
__device__ __forceinline__ bool attempt_failed(uint32_t dev, uint32_t ticket,
                                               uint32_t attempt,
                                               const DrainParams& p) {
  const uint32_t h = (dev * 0x9E3779B1u) ^ (ticket * 0x85EBCA77u) ^
                     (attempt * 0xC2B2AE3Du) ^ p.seed_term;
  return (fmix32(h) & ((1u << kFaultProbBits) - 1u)) < p.threshold;
}

// Adds every lane's v to s[idx]: one atomic a warp where all lanes share
// idx, else one a lane with v != 0.  All lanes of the warp call it.
__device__ __forceinline__ void warp_add(int32_t* s, int idx, int32_t v) {
  const int idx0 = __shfl_sync(kFull, idx, 0);
  if (__all_sync(kFull, idx == idx0)) {
    const int32_t total = static_cast<int32_t>(
        __reduce_add_sync(kFull, static_cast<uint32_t>(v)));
    if ((threadIdx.x & 31) == 0 && total != 0) atomicAdd(s + idx0, total);
  } else if (v != 0) {
    atomicAdd(s + idx, v);
  }
}

__global__ void __launch_bounds__(kThreads)
wfq_drain_kernel(const int32_t* __restrict__ key,
                 const uint8_t* __restrict__ is_write,
                 const int32_t* __restrict__ tenant,
                 const int32_t* __restrict__ ticket, DrainParams p,
                 int32_t* __restrict__ out, int32_t* __restrict__ status) {
  __shared__ int32_t s[kPerDevice + kDevFields * kMaxDevices +
                       2 * kMaxTenants];
  const int words = kPerDevice + kDevFields * p.nd + 2 * p.nt;
  int32_t* dev_f = s + kPerDevice;
  int32_t* ten_f = dev_f + kDevFields * p.nd;
  for (int j = threadIdx.x; j < words; j += blockDim.x) s[j] = 0;
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x;
       base < p.n; base += stride) {
    const int64_t i = base + threadIdx.x;
    const bool pending = i < p.n && key[i] >= 0;
    const bool w = pending && is_write[i];
    const int32_t dev = pending ? static_cast<int32_t>(i / p.group) : 0;
    const int32_t t = pending ? tenant[i] : 0;
    const bool t_ok = t >= 0 && t < p.nt;   // else left out: see above
    bool err = false;
    int32_t retries = 0, transient = 0;
    if (p.fault && pending) {
      const int32_t tk = ticket[i];
      const bool live = tk >= 0 && !((p.failed_mask >> dev) & 1u);
      bool all_failed = false;
      if (p.threshold > 0) {
        bool prefix = true;
        for (int a = 0; a <= p.retry_budget && prefix; ++a) {
          prefix = attempt_failed(static_cast<uint32_t>(dev),
                                  static_cast<uint32_t>(tk),
                                  static_cast<uint32_t>(a), p);
          transient += prefix;
        }
        all_failed = prefix;
      }
      err = tk >= 0 && !(live && !all_failed);
      retries = live ? min(transient, p.retry_budget) : 0;
      transient = live ? transient : 0;
    }
    if (status != nullptr && i < p.n) status[i] = err;
    if (!__any_sync(kFull, pending)) continue;   // the whole warp's slots free
    warp_add(s, kCount, pending);
    warp_add(s, kTransient, transient);
    warp_add(dev_f, kCountDev * p.nd + dev, pending);
    warp_add(dev_f, kReadsDev * p.nd + dev, pending && !w);
    warp_add(dev_f, kWritesDev * p.nd + dev, w);
    warp_add(ten_f, t_ok ? t : 0, pending && t_ok);
    if (p.fault) {
      warp_add(dev_f, kErrorsDev * p.nd + dev, err);
      warp_add(dev_f, kErrReadsDev * p.nd + dev, err && !w);
      warp_add(dev_f, kErrWritesDev * p.nd + dev, err && w);
      warp_add(dev_f, kRetryReadsDev * p.nd + dev, w ? 0 : retries);
      warp_add(dev_f, kRetryWritesDev * p.nd + dev, w ? retries : 0);
      warp_add(ten_f, p.nt + (t_ok ? t : 0), err && t_ok);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < words; j += blockDim.x)
    if (s[j] != 0) atomicAdd(out + j, s[j]);
}

}  // namespace

// Entries: key, is_write (bytes), tenant, ticket (may be null without a
// fault model), num_queues x depth.  status: num_queues * depth int32
// words, each entry's status, or null.  out: 2 + 8 * nd + 2 * nt int32 words
// (count, transient; count, reads, writes, errors, err_reads, err_writes,
// retry_reads, retry_writes a device; count and errors a tenant), zeroed
// here on the stream before the launch.  Returns a CUDA status, or -1 for
// sizes past the kernel's limits (the wrapper checks them first).
extern "C" int wfq_drain_launch(const void* key, const void* is_write,
                                const void* tenant, const void* ticket,
                                int num_queues, int depth, int nd, int nt,
                                int fault, int64_t threshold,
                                int retry_budget, int64_t seed_term,
                                int64_t failed_mask, void* out,
                                void* status, void* stream) {
  if (nd < 1 || nd > kMaxDevices || nt < 1 || nt > kMaxTenants ||
      num_queues % nd != 0 || (fault && ticket == nullptr) ||
      retry_budget < 0)
    return -1;
  DrainParams p;
  p.n = static_cast<int64_t>(num_queues) * depth;
  p.group = static_cast<int64_t>(num_queues / nd) * depth;
  p.nd = nd;
  p.nt = nt;
  p.fault = fault;
  p.retry_budget = retry_budget;
  p.threshold = static_cast<uint32_t>(threshold);
  p.seed_term = static_cast<uint32_t>(seed_term);
  p.failed_mask = static_cast<uint32_t>(failed_mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t words = 2 + kDevFields * nd + 2 * nt;
  cudaError_t e = cudaMemsetAsync(out, 0, words * sizeof(int32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  // about 4 entries a thread, and never more blocks than two a SM: fewer
  // blocks make fewer global atomics on the same few counters
  int dev = 0;
  cudaGetDevice(&dev);
  static int sms_of[64];   // a property of the card, read once
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int64_t blocks = (p.n + kThreads * 4 - 1) / (kThreads * 4);
  if (blocks > 2 * sms_of[dev]) blocks = 2 * sms_of[dev];
  if (blocks < 1) blocks = 1;
  wfq_drain_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const int32_t*>(key), static_cast<const uint8_t*>(is_write),
      static_cast<const int32_t*>(tenant),
      static_cast<const int32_t*>(ticket), p, static_cast<int32_t*>(out),
      static_cast<int32_t*>(status));
  return static_cast<int>(cudaGetLastError());
}
