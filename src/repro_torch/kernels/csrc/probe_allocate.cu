// Fused cache probe + class-then-clock victim select for Hopper (sm_90a).
//
// Replaces: probe_allocate_pallas / _pa_kernel in
// src/repro/kernels/probe_allocate.py.  The TPU kernel gathers every
// directory row through one-hot MXU matmuls (16-bit halves for exact int32),
// scatters the protect overlay by matmul, and ranks same-set misses with a
// cumsum over an (m, S) one-hot matrix.  None of that is carried over: rows
// are read directly, and each set keeps only the misses it can grant.
//
// Result contract: exactly the way probe_allocate_ref gives.  A miss's rank is
// its order, by request index, among the misses of its set; the k-th ranked
// miss takes the k-th eligible way in (class * ways + clock position) order.
// A set has at most `ways` eligible ways, so only its `ways` smallest miss
// indices can be granted, and the kernel only looks for those.  No atomic
// decides a result: atomics count a set's misses and hand out places in its
// bucket, whose order is ignored, and fill a set's overflow slots by
// atomicMin, whose final contents do not depend on the order of the atomics.
//
// Bound: memory.  Per key: its 4 B key, 1 B valid and 1 B alloc flag, one
// set row of five directory fields plus the clock hand, 15 B of output.  At
// the main path's shape (262,144 keys, 16,384 x 4 sets) that is under 2 us
// at the card's memory rate, below the fixed cost of one launch, so the
// design aims at one launch, few barriers and short chains of dependent
// memory operations, not at bytes.  Measured on an H100: one atomic a miss
// whose result the thread waits for costs about 5 us at that shape, so a
// miss makes one such atomic, not a chain.
//
// Design: ONE cooperative launch (cudaLaunchAttributeCooperative, which a
// CUDA graph can capture), sized by the occupancy API, on the caller's
// stream, in three phases separated by two grid-wide barriers.  G is the
// smallest power of two >= ways; each set has a bucket of kPerLane * G
// request indices and `ways` overflow slots.
//   0. zero the per-set miss counts and the byte protect overlay, empty the
//      overflow slots (INT32_MAX);
//   1. per key (one thread, grid-stride): hash, read the tag row (int4
//      loads when ways % 4 == 0) and the owner row only where a tag
//      matches, write hit / hit_slot and the miss defaults (way -1, ok 0,
//      evicted key -1, evicted dirty 0), mark hits and the caller's
//      protect_slots in the overlay.  A miss takes a place in its set's
//      bucket by an atomic ticket.  Past the bucket's end (a set with more
//      misses than kPerLane * G, as in a skewed wavefront) it inserts its
//      request index x into the overflow slots instead: for k = 0, 1, ...:
//      x = max(x, atomicMin(&slot[k], x)), stopping when x is empty; slot k
//      keeps the minimum of all it was offered and passes the rest on, so
//      the slots end as the `ways` smallest overflow indices in order.  An
//      index above the last slot's present value is already out (the slots
//      only decrease and stay sorted) and stops at once;
//   2. per set, G lanes (32 / G sets a warp), one lane per way: each lane
//      reads its way's five fields, computes eligibility and its order key,
//      and counts the eligible lanes with smaller keys by shuffles; each
//      lane holds kPerLane bucket entries and one overflow slot in
//      registers, and the group takes the n_grant = min(eligible, misses)
//      smallest by repeated group minima; the lane of the k-th eligible way
//      grants it to the k-th.  O(n_grant * (kPerLane + log G)) a set, never
//      quadratic in its misses; a set with no miss returns at once.  No
//      array is indexed at run time, so nothing lives in local memory.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kMaxWays = 32;
constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;  // fewer, fuller blocks: cheaper barriers
constexpr int kPerLane = 8;      // bucket entries a lane of a set's group
constexpr int32_t kEmpty = INT32_MAX;

struct PaParams {
  const int32_t* tags;
  const int32_t* owner;
  const int32_t* refcount;
  const uint8_t* dirty;
  const uint8_t* spec;
  const int32_t* clock_hand;
  const int32_t* keys;
  const uint8_t* valid;
  const uint8_t* amask;          // may be null
  const int32_t* protect_slots;  // may be null
  int64_t p;
  int64_t m;
  int32_t num_sets, ways, group, tenant, way_lo, way_hi;
  int spec_insert, protect_hits;
  // outputs
  uint8_t* hit;
  int32_t* hslot;
  int32_t* way;
  uint8_t* ok;
  int32_t* evk;
  uint8_t* evd;
  // scratch (probe_allocate_scratch_words); the first three are reset in
  // phase 0
  int32_t* count;   // [num_sets]                 misses of the set
  int32_t* over;    // [num_sets * ways]          overflow slots
  uint8_t* prot;    // [num_sets * ways]          protect overlay
  int32_t* bucket;  // [num_sets * kPerLane * G]  request indices
};

static int group_of(int ways) {
  int g = 1;
  while (g < ways) g *= 2;
  return g;
}

extern "C" int64_t probe_allocate_scratch_words(int64_t m, int64_t num_sets,
                                                int ways) {
  const int64_t lines = num_sets * ways;
  return num_sets + lines + (lines + 3) / 4 +
         num_sets * kPerLane * group_of(ways);
}

// The first way whose tag is the key and whose owner is the tenant, or -1.
// The owner row is read only where a tag matches.
template <bool VEC>
__device__ __forceinline__ int32_t find_way(const PaParams& a, int64_t row,
                                            int32_t key) {
  if (VEC) {
    const int4* t4 = reinterpret_cast<const int4*>(a.tags + row);
    for (int32_t w = 0; w < a.ways; w += 4) {
      const int4 t = t4[w / 4];
      if (t.x != key && t.y != key && t.z != key && t.w != key) continue;
      const int4 o = reinterpret_cast<const int4*>(a.owner + row)[w / 4];
      if (t.x == key && o.x == a.tenant) return w;
      if (t.y == key && o.y == a.tenant) return w + 1;
      if (t.z == key && o.z == a.tenant) return w + 2;
      if (t.w == key && o.w == a.tenant) return w + 3;
    }
    return -1;
  }
  for (int32_t w = 0; w < a.ways; ++w)
    if (a.tags[row + w] == key && a.owner[row + w] == a.tenant) return w;
  return -1;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    probe_allocate_kernel(const PaParams a) {
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  const int64_t num_lines = (int64_t)a.num_sets * a.ways;

  const int G = a.group;
  const int64_t cap = (int64_t)kPerLane * G;

  // 0. zero the counts and the overlay, empty the overflow slots
  for (int64_t j = tid; j < a.num_sets; j += nthreads) a.count[j] = 0;
  for (int64_t j = tid; j < num_lines; j += nthreads) a.over[j] = kEmpty;
  for (int64_t j = tid; j < (num_lines + 3) / 4; j += nthreads)
    reinterpret_cast<int32_t*>(a.prot)[j] = 0;
  grid.sync();

  // 1. probe, defaults, overlay, and each miss into its set's bucket
  for (int64_t i = tid; i < a.m; i += nthreads) {
    const int32_t key = a.keys[i];
    const bool valid = a.valid[i] != 0;
    const int32_t set = mix_hash(valid ? key : 0) % a.num_sets;
    const int64_t row = (int64_t)set * a.ways;
    const int32_t found = valid ? find_way<VEC>(a, row, key) : -1;
    const bool is_hit = found >= 0;
    const bool is_miss =
        valid && !is_hit && (a.amask == nullptr || a.amask[i] != 0);
    a.hit[i] = is_hit ? 1 : 0;
    a.hslot[i] = is_hit ? static_cast<int32_t>(row + found) : -1;
    a.way[i] = -1;
    a.ok[i] = 0;
    a.evk[i] = -1;
    a.evd[i] = 0;
    if (a.protect_hits && is_hit) a.prot[row + found] = 1;
    if (is_miss) {
      const int32_t pos = atomicAdd(a.count + set, 1);
      int32_t x = static_cast<int32_t>(i);
      if (pos < cap) {
        a.bucket[set * cap + pos] = x;
      } else {
        int32_t* sl = a.over + row;
        // a stale (older) read is only larger, so never wrongly stops early
        if (__ldcg(sl + a.ways - 1) > x)
          for (int32_t k = 0; k < a.ways && x != kEmpty; ++k)
            x = max(x, atomicMin(sl + k, x));
      }
    }
  }
  for (int64_t j = tid; j < a.p; j += nthreads) {
    const int32_t s = a.protect_slots[j];
    if (s >= 0 && s < num_lines) a.prot[s] = 1;
  }
  grid.sync();

  // 2. victim select: G lanes a set, one lane per way.  Warps are numbered
  // across blocks first, so the sets spread over every SM.
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int base = lane - gl;
  const uint32_t gbits = G == 32 ? 0xffffffffu : (1u << G) - 1;
  const uint32_t gmask = gbits << base;
  const int64_t per_warp = 32 / G;
  const int64_t warp = (threadIdx.x >> 5) * (int64_t)gridDim.x + blockIdx.x;
  const int64_t stride = (nthreads >> 5) * per_warp;
  for (int64_t s0 = warp * per_warp; s0 < a.num_sets; s0 += stride) {
    const int64_t set = s0 + lane / G;
    if (set >= a.num_sets) continue;
    const int32_t cnt = __ldcg(a.count + set);
    if (cnt == 0) continue;
    const int64_t row = set * a.ways;
    const bool in = gl < a.ways;
    // the set's misses: kPerLane bucket entries and one overflow slot a lane
    const int32_t* bk = a.bucket + set * cap;
    int32_t e[kPerLane + 1];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      e[j] = j * G + gl < cnt ? __ldcg(bk + j * G + gl) : kEmpty;
    e[kPerLane] = cnt > cap && in ? __ldcg(a.over + row + gl) : kEmpty;
    int32_t tag = -1, key_w = 0;
    bool d = false, elig = false;
    if (in) {
      tag = a.tags[row + gl];
      d = a.dirty[row + gl] != 0;
      const bool sp = a.spec[row + gl] != 0;
      const bool foreign_dirty =
          a.owner[row + gl] != a.tenant && tag >= 0 && d;
      elig = a.refcount[row + gl] == 0 && !foreign_dirty &&
             gl >= a.way_lo && gl < a.way_hi &&
             !(a.spec_insert && sp && tag >= 0) &&
             __ldcg(a.prot + row + gl) == 0;
      // (w - hand) mod ways as a floor modulo: C's % truncates
      int32_t pos = (gl - a.clock_hand[set]) % a.ways;
      pos += pos < 0 ? a.ways : 0;
      key_w = (tag < 0 ? 0 : (sp ? 1 : 2)) * a.ways + pos;
    }
    const uint32_t emask = (__ballot_sync(gmask, elig) >> base) & gbits;
    const int32_t n_grant = min(__popc(emask), min(cnt, a.ways));
    // this way's place among the eligible ways, in key order
    int32_t eidx = 0;
    for (int32_t v = 0; v < a.ways; ++v) {
      const int32_t kv = __shfl_sync(gmask, key_w, v, G);
      eidx += ((emask >> v) & 1u) && kv < key_w ? 1 : 0;
    }
    // the n_grant smallest request indices, lane r keeping the r-th
    int32_t prev = -1, mine = kEmpty;
    for (int32_t r = 0; r < n_grant; ++r) {
      int32_t best = kEmpty;
#pragma unroll
      for (int j = 0; j <= kPerLane; ++j)
        best = e[j] > prev && e[j] < best ? e[j] : best;
      for (int o = G / 2; o > 0; o >>= 1)
        best = min(best, __shfl_xor_sync(gmask, best, o, G));
      if (gl == r) mine = best;
      prev = best;
    }
    const int32_t req = __shfl_sync(gmask, mine, eidx, G);
    if (elig && eidx < n_grant) {
      a.way[req] = gl;
      a.ok[req] = 1;
      a.evk[req] = tag;
      a.evd[req] = d ? 1 : 0;
    }
  }
}

template <bool VEC>
static int launch(const PaParams& a, cudaStream_t st) {
  int dev = 0;
  cudaGetDevice(&dev);
  // the largest grid a cooperative launch may use, per device (cached: a
  // property of the card and the kernel, not of the call)
  static int grid_of[64][2];
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  int& grid = grid_of[dev][VEC ? 1 : 0];
  if (grid == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, probe_allocate_kernel<VEC>, kThreads, 0);
    if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    grid = sms * min(per_sm, kBlocksPerSm);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, probe_allocate_kernel<VEC>, a));
}

extern "C" int probe_allocate_launch(
    const void* tags, const void* owner, const void* refcount,
    const void* dirty, const void* spec, const void* clock_hand,
    const void* keys, const void* valid, const void* amask,
    const void* protect_slots, int64_t p, int64_t m, int num_sets, int ways,
    int tenant, int way_lo, int way_hi, int spec_insert, int protect_hits,
    void* out, void* scratch, int64_t scratch_words, void* stream) {
  if (ways < 1 || ways > kMaxWays || num_sets < 1 || m >= kEmpty ||
      scratch_words < probe_allocate_scratch_words(m, num_sets, ways))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  PaParams a;
  a.tags = static_cast<const int32_t*>(tags);
  a.owner = static_cast<const int32_t*>(owner);
  a.refcount = static_cast<const int32_t*>(refcount);
  a.dirty = static_cast<const uint8_t*>(dirty);
  a.spec = static_cast<const uint8_t*>(spec);
  a.clock_hand = static_cast<const int32_t*>(clock_hand);
  a.keys = static_cast<const int32_t*>(keys);
  a.valid = static_cast<const uint8_t*>(valid);
  a.amask = static_cast<const uint8_t*>(amask);
  a.protect_slots = static_cast<const int32_t*>(protect_slots);
  a.p = protect_slots != nullptr ? p : 0;
  a.m = m;
  a.num_sets = num_sets;
  a.ways = ways;
  a.group = group_of(ways);
  a.tenant = tenant;
  a.way_lo = way_lo;
  a.way_hi = way_hi;
  a.spec_insert = spec_insert;
  a.protect_hits = protect_hits;
  // out: hit_slot, way, evicted key (int32 x m each), then hit, ok,
  // evicted dirty (one byte x m each)
  int32_t* o32 = static_cast<int32_t*>(out);
  uint8_t* o8 = reinterpret_cast<uint8_t*>(o32 + 3 * m);
  a.hslot = o32;
  a.way = o32 + m;
  a.evk = o32 + 2 * m;
  a.hit = o8;
  a.ok = o8 + m;
  a.evd = o8 + 2 * m;
  const int64_t lines = (int64_t)num_sets * ways;
  a.count = static_cast<int32_t*>(scratch);
  a.over = a.count + num_sets;
  a.prot = reinterpret_cast<uint8_t*>(a.over + lines);
  a.bucket = a.over + lines + (lines + 3) / 4;
  const bool vec = ways % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(tags) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(owner) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int status = vec ? launch<true>(a, st) : launch<false>(a, st);
  if (status != 0) return status;
  return static_cast<int>(cudaGetLastError());
}
