"""``BamArray``: BaM's array abstraction (§III-E), single tenant, fused path.

Port of ``repro.core.bam_array``.  The primitive surface is ``submit(st,
req) -> (st, token)`` / ``wait(st, token) -> (st, values)``, with the
``read`` / ``write`` shims and ``flush`` on top:

    submit: coalesce -> fused probe+allocate -> bookkeeping -> SQ enqueue
    wait:   drain accounting -> re-probe -> fetch -> fill -> gather -> unpin

Differences from the reference, none of which changes a value:

* state is updated in place (the returned state is the one passed in);
* ``lax.cond`` fast paths are host-side branches on a synced bool;
* after coalescing, ``unique_keys`` is cut to ``num_unique`` rows (one host
  read per submit) and every per-line buffer is sized by that count, where
  the reference sizes them by the wavefront width.  The -1 padding rows are
  inert, so cache, rings and metrics are identical; at BFS/CC wavefronts of
  2^28 lanes the reference's fetch buffer would not fit in device memory.

Not ported yet (``NotImplementedError``): readahead and the ``prefetch``
request kind, ``fused_rounds=False``, an enabled ``FaultModel``, the
bucketed ops and the ``*_jit`` family, and multi-tenant sharing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core import cache as C
from repro_torch.core import queues as Q
from repro_torch.core.coalescer import coalesce
from repro_torch.core.metrics import IOMetrics, recheck_token_watermark
from repro_torch.core.prefetch import PrefetchConfig
from repro_torch.core.ssd import (ArrayOfSSDs, INTEL_OPTANE_P5800X,
                                  device_histogram)
from repro_torch.core.storage import HBMStorage, SimStorage
from repro_torch.kernels import ops as K
from repro_torch.utils import resolve_device, round_up

__all__ = ["BamArray", "BamState", "IORequest", "IOToken", "PrefetchConfig"]

F64 = torch.float64


@dataclasses.dataclass
class BamState:
    """All mutable BaM state: cache, queues, metrics, and the device-side
    store for the ``hbm`` backend (``None`` for ``sim``)."""

    cache: C.CacheState
    queues: Q.QueueState
    metrics: IOMetrics
    storage: Any = None

    def clone(self) -> "BamState":
        """A copy whose tensors share nothing with this state."""
        def copy(obj):
            kw = {f.name: (getattr(obj, f.name).clone()
                           if isinstance(getattr(obj, f.name), torch.Tensor)
                           else getattr(obj, f.name))
                  for f in dataclasses.fields(obj)}
            return type(obj)(**kw)

        return BamState(
            cache=copy(self.cache), queues=copy(self.queues),
            metrics=copy(self.metrics),
            storage=None if self.storage is None else copy(self.storage))


@dataclasses.dataclass
class IORequest:
    """Unified op descriptor: ``kind`` is "read" or "write" ("prefetch" is
    not ported yet); ``idx`` a wavefront of element indices; ``valid`` a
    lane mask (``None`` = bounds check); ``values`` the write payload."""

    kind: str
    idx: torch.Tensor
    values: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None

    @staticmethod
    def read(idx, valid=None) -> "IORequest":
        return IORequest(kind="read", idx=idx, valid=valid)

    @staticmethod
    def write(idx, values, valid=None) -> "IORequest":
        return IORequest(kind="write", idx=idx, values=values, valid=valid)

    @staticmethod
    def prefetch(idx, valid=None) -> "IORequest":
        return IORequest(kind="prefetch", idx=idx, valid=valid)


@dataclasses.dataclass
class IOToken:
    """Future returned by :meth:`BamArray.submit`; redeem exactly once with
    :meth:`BamArray.wait`.  ``ukeys`` and ``pin_slots`` have one row per
    unique line (``num_unique`` rows, at least one).  The reference's
    per-token command histograms and fault tickets serve its deferred-drain
    and fault paths, which are not ported yet."""

    kind: str
    valid: torch.Tensor           # (n,) request lanes
    off: torch.Tensor             # (n,) element offset within its line
    inverse: torch.Tensor         # (n,) lane -> unique-line row
    ukeys: torch.Tensor           # (u,) coalesced block keys
    pin_slots: torch.Tensor       # (u,) slots pinned at submit (-1 none)
    values: Optional[torch.Tensor]  # (n,) write payload
    drop_dev_reads: torch.Tensor  # (nd,) read commands the rings rejected
    drop_dev_writes: torch.Tensor  # (nd,) write commands the rings rejected
    dropped_mask: torch.Tensor    # (n,) lanes whose command was dropped
    redeemed: bool = False


def _mark_redeemed(token: IOToken) -> None:
    """Single-redemption guard: a second wait would over-release pins."""
    # eager torch: a host flag, not a traced value
    if token.redeemed:  # bamlint: ignore[BAM104]
        raise ValueError(
            "IOToken has already been redeemed by wait(); a token must be "
            "waited exactly once (a second wait would over-release its "
            "cache pins)")
    token.redeemed = True


@dataclasses.dataclass
class BamArray:
    """Static description of one BaM-backed array."""

    storage: Any                  # SimStorage (host) or None (hbm backend)
    shape: tuple
    dtype: torch.dtype
    block_elems: int
    device: torch.device
    ssd: ArrayOfSSDs = dataclasses.field(
        default_factory=lambda: ArrayOfSSDs(INTEL_OPTANE_P5800X, 1))

    # ---------------------------------------------------------------- init
    @staticmethod
    def build(data, block_elems: int, *, num_sets: int, ways: int = 4,
              num_queues: int = 8, queue_depth: int = 1024,
              ssd: Optional[ArrayOfSSDs] = None,
              prefetch: Optional[PrefetchConfig] = None,
              backend: str = "sim", fused_rounds: bool = True,
              device=None) -> Tuple["BamArray", BamState]:
        """Create the array and its initial state from a host array.

        ``device`` defaults to ``"cuda"``; ``backend='sim'`` keeps the data
        in (pinned) host memory, ``'hbm'`` in device memory.
        """
        import numpy as np

        dev = resolve_device(device)
        ssd = ssd or ArrayOfSSDs(INTEL_OPTANE_P5800X, 1)
        if prefetch is not None and prefetch.enabled:
            raise NotImplementedError("readahead (PrefetchConfig(enabled="
                                      "True)) is not ported yet")
        if not fused_rounds:
            raise NotImplementedError("the legacy fused_rounds=False path is "
                                      "not ported")
        if ssd.fault.enabled:
            raise NotImplementedError("an enabled FaultModel is not ported "
                                      "yet")
        arr_np = np.asarray(data)
        if backend == "sim":
            store = SimStorage.from_array(arr_np, block_elems, dev)
            state_store, dtype = None, store.dtype
        elif backend == "hbm":
            hs = HBMStorage.from_array(arr_np, block_elems, dev)
            store, state_store, dtype = None, hs, hs.dtype
        else:
            raise ValueError(f"unknown backend {backend!r}")
        num_queues = round_up(num_queues, ssd.n_devices)
        arr = BamArray(storage=store, shape=tuple(arr_np.shape), dtype=dtype,
                       block_elems=block_elems, device=dev, ssd=ssd)
        st = BamState(
            cache=C.make_cache(num_sets, ways, block_elems, dtype, dev),
            queues=Q.make_queues(num_queues, queue_depth,
                                 n_devices=ssd.n_devices,
                                 stripe_blocks=ssd.stripe_blocks,
                                 device=dev),
            metrics=IOMetrics.zeros(ssd.n_devices, dev),
            storage=state_store)
        return arr, st

    # ------------------------------------------------------------- helpers
    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    @property
    def block_bytes(self) -> int:
        return self.block_elems * self.itemsize

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n

    @property
    def num_blocks(self) -> int:
        return -(-self.size // self.block_elems)

    def _store(self, st: BamState):
        return self.storage if self.storage is not None else st.storage

    def _check_channels(self, st: BamState) -> None:
        qs = st.queues
        if (qs.n_devices, qs.stripe_blocks) != (self.ssd.n_devices,
                                                self.ssd.stripe_blocks):
            raise ValueError(
                f"queue channels (n_devices={qs.n_devices}, "
                f"stripe_blocks={qs.stripe_blocks}) do not match the SSD "
                f"array (n_devices={self.ssd.n_devices}, "
                f"stripe_blocks={self.ssd.stripe_blocks})")

    def _split(self, idx: torch.Tensor):
        return (torch.div(idx, self.block_elems, rounding_mode="floor")
                .to(torch.int32),
                torch.remainder(idx, self.block_elems).to(torch.int32))

    def _hist(self, keys, mask=None):
        return device_histogram(keys, self.ssd.n_devices, mask,
                                self.ssd.stripe_blocks)

    # ----------------------------------------------------------- async core
    def submit(self, st: BamState, req: IORequest
               ) -> Tuple[BamState, IOToken]:
        """Issue a wavefront of storage commands without draining them:
        coalesce -> fused probe+allocate -> pin (+ mark in flight) -> write
        back evicted dirty lines -> enqueue SQ commands."""
        self._check_channels(st)
        kind = req.kind
        if kind == "prefetch":
            raise NotImplementedError("IORequest.prefetch is not ported yet")
        if kind not in ("read", "write"):
            raise ValueError(f"unknown IORequest kind {kind!r}")
        if kind == "write" and req.values is None:
            raise ValueError("IORequest(kind='write') needs values")
        if req.idx.shape[0] == 0:
            return self._submit_empty(st, req)
        idx = req.idx.to(self.device)
        valid = req.valid
        if valid is None:
            valid = (idx >= 0) & (idx < self.size)
        valid = valid.to(self.device)
        blk, off = self._split(torch.where(valid, idx, 0))
        blk = torch.where(valid, blk, -1)

        # 1) warp-coalesce the wavefront to unique cache lines, then cut the
        #    -1 padding: one host read per submit (a device sync).  At least
        #    one row stays, so the inverse map of an all-invalid wavefront
        #    still points at a row.
        co = coalesce(blk, valid)
        n_u = max(int(co.num_unique), 1)  # bamlint: ignore[BAM102]
        ukeys = co.unique_keys[:n_u].clone()    # frees the (n,) buffer
        uvalid = ukeys >= 0
        mt = st.metrics

        # 2+3) fused probe + victim allocate: one probe_allocate kernel pass
        cache, pr, alloc = C.probe_allocate(st.cache, ukeys, uvalid)
        n_hit = pr.hit.sum(dtype=torch.int32)
        n_pref_hit = pr.speculative.sum(dtype=torch.int32)
        n_cross = pr.inflight.sum(dtype=torch.int32)
        miss = uvalid & ~pr.hit

        # 3b) pin everything this token touched until its wait; mark granted
        #     lines in flight.
        pin_slots = torch.where(pr.hit, pr.slot,
                                torch.where(alloc.ok, alloc.slot, -1))
        grant_slots = torch.where(alloc.ok, alloc.slot, -1)
        promote_slots = torch.where(pr.speculative, pr.slot, -1)
        C.grant_bookkeeping(cache, n_hit, promote_slots, pin_slots,
                            grant_slots)

        # 4) evicted dirty lines -> write-back commands + immediate DMA.
        wb = alloc.ok & alloc.evicted_dirty & (alloc.evicted_key >= 0)
        wb_keys = torch.where(wb, alloc.evicted_key, -1)

        # 5) enqueue reads + write-backs (+ write-through of bypassed lines)
        read_keys = torch.where(miss, ukeys, -1)
        segs = [(read_keys, alloc.slot, None, None, Q.PRIO_DEMAND),
                (wb_keys, None, torch.ones_like(wb), None, Q.PRIO_DEMAND)]
        byp = bt_keys = None
        if kind == "write":
            byp = miss & ~alloc.ok
            bt_keys = torch.where(byp, ukeys, -1)
            segs.append((bt_keys, None, torch.ones_like(byp), None,
                         Q.PRIO_DEMAND))
        qs, recs = Q.enqueue_segments(st.queues, segs)
        rec_r, rec_w = recs[0], recs[1]
        n_doorbells = rec_r.n_doorbells + rec_w.n_doorbells
        n_dropped = rec_r.n_dropped + rec_w.n_dropped
        drop_reads = self._hist(read_keys, ~rec_r.accepted)
        drop_writes = self._hist(wb_keys, ~rec_w.accepted)
        drop_u = miss & ~rec_r.accepted
        if kind == "write":
            rec_bt = recs[2]
            n_doorbells = n_doorbells + rec_bt.n_doorbells
            n_dropped = n_dropped + rec_bt.n_dropped
            drop_writes = drop_writes + self._hist(bt_keys, ~rec_bt.accepted)
            drop_u = drop_u | (byp & ~rec_bt.accepted)
        depth_now = Q.in_flight(qs)
        depth_dev = Q.in_flight_per_device(qs)

        # 6) persist evicted dirty lines.  Host-side branch in place of the
        #    reference's lax.cond on any(wb) (a device sync): a wavefront
        #    that evicted nothing dirty never touches the line store.
        if bool(wb.any()):  # bamlint: ignore[BAM102]
            ev_lines = cache.data[torch.where(wb, alloc.slot, 0)
                                  .to(torch.int64)]
            self._store(st).write_blocks(wb_keys, ev_lines)

        # 7) submission-side metrics, in place
        n_valid = valid.sum(dtype=torch.int32)
        n_miss = miss.sum(dtype=torch.int32)
        n_wb = wb.sum(dtype=torch.int32)
        if kind == "write":
            n_wb = n_wb + byp.sum(dtype=torch.int32)
        tok_new = valid.any().to(F64)
        window_now = (mt.tokens_in_flight + tok_new).to(torch.int32)
        mt.requests += n_valid
        mt.bytes_requested += n_valid.to(F64) * self.itemsize
        mt.hits += n_hit
        mt.misses += n_miss
        mt.write_ops += n_wb
        mt.bytes_to_storage += n_wb.to(F64) * self.block_bytes
        mt.doorbells += n_doorbells
        mt.dropped += n_dropped
        mt.prefetch_hits += n_pref_hit
        mt.max_queue_depth = torch.maximum(mt.max_queue_depth, depth_now)
        mt.dev_max_depth = torch.maximum(mt.dev_max_depth, depth_dev)
        mt.tokens_submitted += tok_new
        mt.tokens_in_flight += tok_new
        mt.cross_op_coalesced += n_cross
        mt.max_tokens_in_flight = torch.maximum(mt.max_tokens_in_flight,
                                                window_now)
        token = IOToken(
            kind=kind, valid=valid, off=off, inverse=co.inverse_idx,
            ukeys=ukeys, pin_slots=pin_slots,
            values=req.values.to(self.device) if kind == "write" else None,
            drop_dev_reads=drop_reads, drop_dev_writes=drop_writes,
            dropped_mask=valid & drop_u[co.inverse_idx.to(torch.int64)])
        return st, token

    def _submit_empty(self, st: BamState, req: IORequest
                      ) -> Tuple[BamState, IOToken]:
        """Zero-length wavefront: no commands, no cache traffic, no metrics;
        a zero-shaped token keeps the submit/wait pairing uniform."""
        dev = self.device
        nd = self.ssd.n_devices

        def z(dt=torch.int32, fill=0):
            return torch.full((0,), fill, dtype=dt, device=dev)

        zh = torch.zeros((nd,), dtype=torch.int32, device=dev)
        token = IOToken(
            kind=req.kind, valid=z(torch.bool), off=z(), inverse=z(),
            ukeys=z(fill=-1), pin_slots=z(fill=-1),
            values=req.values if req.kind == "write" else None,
            drop_dev_reads=zh, drop_dev_writes=zh.clone(),
            dropped_mask=z(torch.bool))
        return st, token

    def _fetch_gated(self, store, keys: torch.Tensor,
                     need: torch.Tensor) -> torch.Tensor:
        """Fetch ``keys`` (-1 rows give zeros).  Host-side branch in place
        of the reference's lax.cond on any(need) (a device sync): a wait
        with nothing to fetch never pays the host round trip."""
        if isinstance(store, SimStorage) and not bool(need.any()):
            return torch.zeros((keys.shape[0], self.block_elems),
                               dtype=store.dtype, device=self.device)
        return store.fetch_blocks(keys)

    def wait(self, st: BamState, token: IOToken
             ) -> Tuple[BamState, torch.Tensor]:
        """Complete a pending token: drain, fetch, fill, gather, unpin.
        Returns ``(state, values)``; a second wait of a token raises."""
        st, vals, _ = self.wait_ex(st, token)
        return st, vals

    def wait_ex(self, st: BamState, token: IOToken
                ) -> Tuple[BamState, torch.Tensor, torch.Tensor]:
        """:meth:`wait` returning ``(state, values, error_mask)``; with the
        fault model disabled the mask is all False."""
        _mark_redeemed(token)
        self._check_channels(st)
        dev = self.device
        if token.ukeys.shape[0] == 0:
            return (st, torch.zeros((0,), dtype=self.dtype, device=dev),
                    torch.zeros((0,), dtype=torch.bool, device=dev))
        ukeys = token.ukeys
        uvalid = ukeys >= 0
        valid = token.valid
        off = token.off
        charge_qs = (st.queues.group_size, st.queues.depth)

        # 1) drain the rings with closed-form accounting, in place
        qs, dr = Q.drain_accounting(st.queues)
        reads_charge = dr.reads_dev + token.drop_dev_reads
        writes_charge = dr.writes_dev + token.drop_dev_writes

        # 2) fresh probe through the cache_probe kernel
        pr2 = C.probe(st.cache, ukeys, uvalid)
        pend = pr2.hit & pr2.inflight
        need = uvalid & (~pr2.hit | pend)

        # 3) the deferred fetch DMA + completion fill
        store = self._store(st)
        lines = self._fetch_gated(store, torch.where(need, ukeys, -1), need)
        cache = C.fill_complete(st.cache, pr2.slot, pend, lines)
        n_fetch = need.sum(dtype=torch.int32)

        # 4) op-specific completion
        u = token.inverse.to(torch.int64)
        hit_u = pr2.hit[u]
        slot_u = torch.where(hit_u, pr2.slot[u], -1)
        if token.kind == "read":
            hit_vals = K.gather_blocks(cache.data, slot_u, off=off)
            miss_vals = lines.view(-1)[u * self.block_elems + off]
            vals = torch.where(hit_u, hit_vals, miss_vals)
            vals = torch.where(valid, vals, torch.zeros((), dtype=self.dtype,
                                                        device=dev))
        else:
            values = token.values.to(self.dtype)
            # scatter the new element values into resident lines...
            in_cache = valid & (slot_u >= 0)
            sel = torch.nonzero(in_cache).squeeze(1)
            if sel.numel() > 0:  # bamlint: ignore[BAM104] -- host branch
                cache.data[slot_u[sel].to(torch.int64),
                           off[sel].to(torch.int64)] = values[sel]
            C.mark_dirty(cache, torch.where(in_cache, slot_u, -1))
            # ...and write through the lines that have no slot (bypass)
            byp_u = ~hit_u & valid
            byp_lines = lines.clone()
            sel = torch.nonzero(byp_u).squeeze(1)
            if sel.numel() > 0:  # bamlint: ignore[BAM104] -- host branch
                byp_lines[u[sel], off[sel].to(torch.int64)] = values[sel]
            bt_keys = torch.where(uvalid & ~pr2.hit, ukeys, -1)
            store.write_blocks(bt_keys, byp_lines)
            vals = torch.where(valid, values,
                               torch.zeros((), dtype=self.dtype, device=dev))

        # 5) release the pins taken at submit
        C.release(cache, token.pin_slots)

        # 6) completion-side metrics
        mt = st.metrics
        tok_done = valid.any().to(F64)
        mt.bytes_from_storage += n_fetch.to(F64) * self.block_bytes
        mt.tokens_waited += tok_done
        mt.tokens_in_flight -= tok_done
        self._charge_wait(mt, charge_qs, reads_charge, writes_charge)
        err = torch.zeros(valid.shape, dtype=torch.bool, device=dev)
        return st, vals, err

    def _charge_wait(self, mt: IOMetrics, qs_geom, reads_hist: torch.Tensor,
                     writes_hist: torch.Tensor) -> None:
        """Device-time charge for a drain, in place: each channel retires
        its share at its own Little's-law rate, the straggler gates the
        batch.  The charge is float32 (as in the reference), accumulated in
        float64."""
        group_size, depth = qs_geom
        limit = group_size * depth
        t_read, t_read_dev = self.ssd.service_time_per_device(
            reads_hist, self.block_bytes, queue_depth_limit=limit)
        t_write, t_write_dev = self.ssd.service_time_per_device(
            writes_hist, self.block_bytes, write=True,
            queue_depth_limit=limit)
        mt.sim_time_s += t_read
        mt.sim_time_s += t_write
        mt.read_time_s += t_read
        mt.write_time_s += t_write
        mt.dev_reads += reads_hist
        mt.dev_writes += writes_hist
        mt.dev_bytes += (reads_hist + writes_hist).to(F64) * self.block_bytes
        mt.dev_time_s += t_read_dev
        mt.dev_time_s += t_write_dev

    # ----------------------------------------------- synchronous shims
    def read(self, st: BamState, idx: torch.Tensor,
             valid: torch.Tensor | None = None
             ) -> Tuple[torch.Tensor, BamState]:
        """Gather ``flat[idx]``: ``submit`` + ``wait`` back to back.
        Returns ``(values, state)`` as the reference does."""
        st, tok = self.submit(st, IORequest.read(idx, valid))
        st, vals = self.wait(st, tok)
        return vals, st

    def write(self, st: BamState, idx: torch.Tensor, values: torch.Tensor,
              valid: torch.Tensor | None = None) -> BamState:
        """Element writes (read-modify-write with write-allocate)."""
        st, tok = self.submit(st, IORequest.write(idx, values, valid))
        st, _ = self.wait(st, tok)
        return st

    def flush(self, st: BamState) -> BamState:
        """Write back every dirty resident line through the SQ rings:
        enqueue, doorbell, drain."""
        self._check_channels(st)
        cache = st.cache
        tags = cache.tags.view(-1)
        dirty = cache.dirty.view(-1)
        mine = cache.owner.view(-1) == 0
        keys = torch.where(dirty & mine & (tags >= 0), tags, -1)
        charge_qs = (st.queues.group_size, st.queues.depth)
        qs, rec_w = Q.enqueue(st.queues, keys,
                              is_write=torch.ones(keys.shape,
                                                  dtype=torch.bool,
                                                  device=keys.device))
        depth_now = Q.in_flight(qs)
        depth_dev = Q.in_flight_per_device(qs)
        qs, dr = Q.drain_accounting(qs)
        reads_charge = dr.reads_dev
        writes_charge = dr.writes_dev + self._hist(keys, ~rec_w.accepted)
        self._store(st).write_blocks(keys, cache.data)
        flushed = keys >= 0
        n_wb = flushed.sum(dtype=torch.int32)
        cache.dirty &= ~flushed.reshape(cache.dirty.shape)
        mt = st.metrics
        mt.write_ops += n_wb
        mt.bytes_to_storage += n_wb.to(F64) * self.block_bytes
        mt.doorbells += rec_w.n_doorbells
        mt.dropped += rec_w.n_dropped
        mt.max_queue_depth = torch.maximum(mt.max_queue_depth, depth_now)
        mt.dev_max_depth = torch.maximum(mt.dev_max_depth, depth_dev)
        self._charge_wait(mt, charge_qs, reads_charge, writes_charge)
        recheck_token_watermark(mt)
        return st
