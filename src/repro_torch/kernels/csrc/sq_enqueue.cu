// Fused multi-segment SQ enqueue for Hopper (sm_90a).
//
// Replaces: ops.sq_enqueue in src/repro/kernels/ops.py (the jnp
// sq_enqueue_ref, an XLA graph on every backend of the reference); its plain
// version here is kernels/ref.py:sq_enqueue_ref, which it matches bit for
// bit.
//
// What it computes, for every segment in issue order: each lane's device
// (the block striping of core/ssd.py:device_of_block, remapped around failed
// devices), its ticket (the exclusive count of earlier valid lanes on the
// same device), the round-robin queue pick and virtual slot, the ring-full
// back-pressure (`fits`), and the accepted rank (the exclusive count of
// earlier accepted lanes on the same device), whose ticket id is the
// device's enqueue count before the segment plus that rank.  Between
// segments it carries the tails (accepted lanes a queue), the round-robin
// pointers (valid lanes a device, dropped ones included) and the per-device
// enqueue counts.  Accepted lanes write the six ring fields in place at
// (queue, vslot mod depth); those pairs are distinct, so order is free.
//
// Design: one CTA of 1024 threads walks the segments in order, 1024 lanes
// at a time, and keeps the tails, the pointers and the running per-device
// counts in shared memory, so a call is one launch with no host sync (it
// can be captured in a CUDA graph).  Tickets and ranks depend on lane order, so
// they are prefix scans, not atomics: in each chunk a warp takes one
// __ballot_sync a device (its lanes' in-warp ranks and the warp's count),
// warp d then scans the 32 warps' counts of device d, and a running total a
// device carries the scan from chunk to chunk.  `fits` needs the ticket, so
// a chunk scans twice: valid lanes (tickets), then accepted lanes (ranks).
// Only the per-queue accepted counts, which are order-free sums, use shared
// atomics.  Integer adds of the tails and counts go through uint32, so they
// wrap as the plain version's int32 tensors do.
//
// Bound: memory, and far below a launch at the main path's sizes: per lane
// the kernel reads 14 B (key, valid, and for accepted lanes dst, is_write,
// prio) and writes 13 B (queue, vslot, ticket id, accepted), plus 21 B of
// ring fields an accepted lane.  One CTA is far from that: a 1024-lane
// chunk takes about 3.8 us on an H100 80GB HBM3 (0.245 ms for 65,536
// lanes), which the instructions of its 32 warps on one SM (ballots,
// scans, integer divisions) account for; loading the next chunk during the
// current one saved nothing, so memory latency does not bound it.  A
// multi-CTA decoupled look-back scan is the path past it.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 32;     // one ballot a device, one scan warp each
constexpr int kMaxSegments = 64;
constexpr int kMaxQueues = 4096;    // two int32 arrays in shared memory
constexpr unsigned kFull = 0xffffffffu;

struct SqParams {
  int32_t bounds[kMaxSegments + 1];   // segment s is [bounds[s], bounds[s+1])
  int32_t alive[kMaxDevices];         // surviving devices, in order
  int32_t n_seg, nq, depth, nd, gsize, stripe, n_alive, tenant;
  uint32_t failed_mask;               // bit d: device d hard-failed
};

struct SqArgs {
  // rings, written in place: (nq, depth)
  int32_t* sq_key;
  int32_t* sq_dst;
  uint8_t* sq_is_write;
  int32_t* sq_prio;
  int32_t* sq_tenant;
  int32_t* sq_ticket;
  // state in: (nq,) and (nd,)
  const int32_t* tail_in;
  const int32_t* head;
  const int32_t* rr_in;
  const int32_t* dev_enq_in;
  // lanes in: (n,)
  const int32_t* keys;
  const int32_t* dst;
  const uint8_t* is_write;
  const int32_t* prio;
  const uint8_t* valid;
  // out
  int32_t* tail_out;    // (nq,)
  int32_t* rr_out;      // (nd,)
  int32_t* queue;       // (n,)
  int32_t* vslot;       // (n,)
  int32_t* ticket_id;   // (n,)
  uint8_t* accepted;    // (n,)
  int32_t* n_acc;       // (n_seg,)
  int32_t* n_drop;      // (n_seg,)
  int32_t* n_db;        // (n_seg,)
  int32_t* n_tick;      // (n_seg,)
  int32_t* dev_drop;    // (n_seg, nd)
  int32_t* dev_acc;     // (n_seg, nd)
};

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// Python's (and torch.remainder's) modulo for a positive divisor.
__device__ __forceinline__ int32_t floor_mod(int32_t a, int32_t m) {
  const int32_t r = a % m;
  return r < 0 ? r + m : r;
}

// core/ssd.py:device_of_block for one key.
__device__ __forceinline__ int32_t route(int32_t key, const SqParams& p) {
  if (key < 0) return 0;
  const int32_t stripe = key / p.stripe;
  const int32_t dev = stripe % p.nd;
  if ((p.failed_mask >> dev) & 1u) return p.alive[stripe % p.n_alive];
  return dev;
}

// Lane-order rank of `pred` lanes on `dev` in one 1024-lane chunk: returns
// the in-warp exclusive count, and leaves in wtot[w][d] the offset of warp w
// for device d (running[d] plus the counts of warps before w).  Then
// running[d] is advanced by the chunk's count.  The caller syncs before the
// next use of wtot.
__device__ __forceinline__ int32_t chunk_rank(bool pred, int32_t dev, int nd,
                                              int32_t (*wtot)[kWarps + 1],
                                              int32_t* running) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  int32_t excl = 0, count = 0;
  for (int d = 0; d < nd; ++d) {
    const unsigned b = __ballot_sync(kFull, pred && dev == d);
    if (d == dev) excl = __popc(b & lt);
    if (d == lane) count = __popc(b);
  }
  if (lane < nd) wtot[warp][lane] = count;
  __syncthreads();
  if (warp < nd) {                  // warp d scans device d over the warps
    const int d = warp;
    const int32_t x = wtot[lane][d];
    int32_t inc = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += y;
    }
    const int32_t run = running[d];
    wtot[lane][d] = run + inc - x;
    __syncwarp();
    if (lane == 31) running[d] = run + inc;
  }
  __syncthreads();
  return wtot[warp][dev] + excl;
}

__global__ void __launch_bounds__(kThreads, 1)
sq_enqueue_kernel(SqArgs a, SqParams p) {
  extern __shared__ int32_t smem[];
  int32_t* s_tail = smem;               // (nq,) tails at the segment's start
  int32_t* s_cnt = smem + p.nq;         // (nq,) accepted lanes this segment
  __shared__ int32_t wtot[kWarps][kWarps + 1];
  __shared__ int32_t s_rr[kMaxDevices], s_base[kMaxDevices];
  __shared__ int32_t run_v[kMaxDevices], run_a[kMaxDevices];
  __shared__ int32_t s_drop[kMaxDevices];
  __shared__ int32_t s_ndb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int q = tid; q < p.nq; q += kThreads) {
    s_tail[q] = a.tail_in[q];
    s_cnt[q] = 0;
  }
  if (tid < p.nd) {
    s_rr[tid] = a.rr_in[tid];
    s_base[tid] = a.dev_enq_in[tid];
  }
  if (tid == 0) s_ndb = 0;

  for (int seg = 0; seg < p.n_seg; ++seg) {
    if (tid < p.nd) run_v[tid] = run_a[tid] = s_drop[tid] = 0;
    __syncthreads();
    const int32_t s0 = p.bounds[seg], e0 = p.bounds[seg + 1];
    for (int32_t base = s0; base < e0; base += kThreads) {
      const int32_t i = base + tid;
      const bool in = i < e0;
      const int32_t key = in ? a.keys[i] : -1;
      const bool v = in && a.valid[i];
      const int32_t dev = route(key, p);
      // pass 1: tickets, the queue pick and the virtual slot
      const int32_t ticket = chunk_rank(v, dev, p.nd, wtot, run_v);
      const int32_t queue =
          dev * p.gsize + floor_mod(wrap_add(s_rr[dev], ticket), p.gsize);
      const int32_t vslot = wrap_add(s_tail[queue], ticket / p.gsize);
      const bool fits = wrap_sub(vslot, __ldg(a.head + queue)) < p.depth;
      const bool acc = v && fits;
      __syncthreads();              // every lane has read wtot
      // pass 2: ranks among the accepted lanes
      const int32_t arank = chunk_rank(acc, dev, p.nd, wtot, run_a);
      if (in) {
        a.queue[i] = queue;
        a.vslot[i] = vslot;
        a.ticket_id[i] = wrap_add(s_base[dev], arank);
        a.accepted[i] = acc ? 1 : 0;
      }
      if (acc) {
        atomicAdd(s_cnt + queue, 1);
        const int64_t f = static_cast<int64_t>(queue) * p.depth +
                          floor_mod(vslot, p.depth);
        a.sq_key[f] = key;
        a.sq_dst[f] = a.dst[i];
        a.sq_is_write[f] = a.is_write[i];
        a.sq_prio[f] = a.prio[i];
        a.sq_tenant[f] = p.tenant;
        a.sq_ticket[f] = wrap_add(s_base[dev], arank);
      } else if (v) {
        atomicAdd(s_drop + dev, 1);
      }
      __syncthreads();              // wtot is reused by the next chunk
    }
    __syncthreads();
    // the segment's counts, then carry tails, pointers and device bases
    int32_t doorbells = 0;
    for (int q = tid; q < p.nq; q += kThreads) {
      const int32_t c = s_cnt[q];
      doorbells += c > 0;
      s_tail[q] = wrap_add(s_tail[q], c);
      s_cnt[q] = 0;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      doorbells += __shfl_xor_sync(kFull, doorbells, o);
    if (lane == 0 && doorbells) atomicAdd(&s_ndb, doorbells);
    if (warp == 0) {
      const bool has = lane < p.nd;
      const int32_t kv = has ? run_v[lane] : 0;
      const int32_t ka = has ? run_a[lane] : 0;
      const int32_t kd = has ? s_drop[lane] : 0;
      if (has) {
        a.dev_acc[seg * p.nd + lane] = ka;
        a.dev_drop[seg * p.nd + lane] = kd;
        s_rr[lane] = floor_mod(wrap_add(s_rr[lane], kv), p.gsize);
        s_base[lane] = wrap_add(s_base[lane], ka);
      }
      int32_t sv = kv, sa = ka, sd = kd;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sv += __shfl_xor_sync(kFull, sv, o);
        sa += __shfl_xor_sync(kFull, sa, o);
        sd += __shfl_xor_sync(kFull, sd, o);
      }
      if (lane == 0) {
        a.n_tick[seg] = sv;
        a.n_acc[seg] = sa;
        a.n_drop[seg] = sd;
      }
    }
    __syncthreads();
    if (tid == 0) {
      a.n_db[seg] = s_ndb;
      s_ndb = 0;
    }
  }
  __syncthreads();
  for (int q = tid; q < p.nq; q += kThreads) a.tail_out[q] = s_tail[q];
  if (tid < p.nd) a.rr_out[tid] = s_rr[tid];
}

}  // namespace

// rings: key, dst, is_write, prio, tenant, ticket (nq x depth, in place);
// state: tail (nq), head (nq), rr (nd), dev_enqueued (nd); lanes: keys, dst,
// is_write, prio, valid (n); bounds: n_seg + 1 host ints, 0 = bounds[0] <=
// ... <= bounds[n_seg] = n; alive: n_alive host ints.  out: int32 words
// tail (nq), rr (nd), queue, vslot, ticket id (n each), n_accepted,
// n_dropped, n_doorbells, n_tickets (n_seg each), dev_dropped, dev_accepted
// (n_seg x nd each), then accepted (n bytes).  Returns a CUDA status, or -1
// for sizes past the kernel's limits (the wrapper checks them first).
extern "C" int sq_enqueue_launch(
    void* sq_key, void* sq_dst, void* sq_is_write, void* sq_prio,
    void* sq_tenant, void* sq_ticket, const void* tail, const void* head,
    const void* rr, const void* dev_enqueued, const void* keys,
    const void* dst, const void* is_write, const void* prio,
    const void* valid, int n, int nq, int depth, int nd, int stripe,
    int tenant, const int* bounds, int n_seg, const int* alive, int n_alive,
    void* out, void* stream) {
  if (nd < 1 || nd > kMaxDevices || nq > kMaxQueues || nq % nd != 0 ||
      n_seg < 0 || n_seg > kMaxSegments || n_alive < 1 || n_alive > nd ||
      depth < 1 || stripe < 1)
    return -1;
  SqParams p{};
  for (int s = 0; s <= n_seg; ++s) p.bounds[s] = bounds[s];
  uint32_t live_mask = 0;
  for (int d = 0; d < n_alive; ++d) {
    p.alive[d] = alive[d];
    live_mask |= 1u << alive[d];
  }
  p.n_seg = n_seg;
  p.nq = nq;
  p.depth = depth;
  p.nd = nd;
  p.gsize = nq / nd;
  p.stripe = stripe;
  p.n_alive = n_alive;
  p.tenant = tenant;
  p.failed_mask = ~live_mask & (nd == 32 ? kFull : ((1u << nd) - 1u));

  SqArgs a;
  a.sq_key = static_cast<int32_t*>(sq_key);
  a.sq_dst = static_cast<int32_t*>(sq_dst);
  a.sq_is_write = static_cast<uint8_t*>(sq_is_write);
  a.sq_prio = static_cast<int32_t*>(sq_prio);
  a.sq_tenant = static_cast<int32_t*>(sq_tenant);
  a.sq_ticket = static_cast<int32_t*>(sq_ticket);
  a.tail_in = static_cast<const int32_t*>(tail);
  a.head = static_cast<const int32_t*>(head);
  a.rr_in = static_cast<const int32_t*>(rr);
  a.dev_enq_in = static_cast<const int32_t*>(dev_enqueued);
  a.keys = static_cast<const int32_t*>(keys);
  a.dst = static_cast<const int32_t*>(dst);
  a.is_write = static_cast<const uint8_t*>(is_write);
  a.prio = static_cast<const int32_t*>(prio);
  a.valid = static_cast<const uint8_t*>(valid);
  int32_t* o = static_cast<int32_t*>(out);
  a.tail_out = o;
  a.rr_out = a.tail_out + nq;
  a.queue = a.rr_out + nd;
  a.vslot = a.queue + n;
  a.ticket_id = a.vslot + n;
  a.n_acc = a.ticket_id + n;
  a.n_drop = a.n_acc + n_seg;
  a.n_db = a.n_drop + n_seg;
  a.n_tick = a.n_db + n_seg;
  a.dev_drop = a.n_tick + n_seg;
  a.dev_acc = a.dev_drop + n_seg * nd;
  a.accepted = reinterpret_cast<uint8_t*>(a.dev_acc + n_seg * nd);

  const size_t smem = 2 * static_cast<size_t>(nq) * sizeof(int32_t);
  sq_enqueue_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, p);
  return static_cast<int>(cudaGetLastError());
}
