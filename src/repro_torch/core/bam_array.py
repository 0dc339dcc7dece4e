"""``BamArray``, ``BamKVStore`` and the shared multi-tenant ``BamRuntime``:
BaM's high-level abstractions (§III-E) and the paper's §I claim that one
cache and one queue pool serve several GPU applications.

Port of ``repro.core.bam_array``.  The primitive surface is ``submit(st,
req) -> (st, token)`` / ``wait(st, token) -> (st, values)``, with the
``read`` / ``write`` shims and ``flush`` on top:

    submit: coalesce -> fused probe+allocate -> bookkeeping
            -> readahead claim -> SQ enqueue
    wait:   drain accounting (+ fault status) -> re-probe -> fetch
            -> fill or invalidate -> readahead fill -> gather -> unpin

A ``PrefetchConfig(enabled=True)`` array extrapolates each read wavefront's
stride and claims the predicted lines as speculative, in-flight residents
(the low-priority lane), filled by the token's wait; ``IORequest.prefetch``
warms lines the same way without pinning them.  An enabled ``FaultModel``
decides each command's fate from its ``(device, ticket)`` stamp: errored
lanes read 0 and are flagged in ``wait_ex``'s error mask, and a line is
never filled from a failed fetch.

``fused_rounds=False`` is the reference's legacy step-by-step path, kept as
its differential oracle: sequential cache bookkeeping, one ``enqueue`` per
command segment, the drain through ``service_all`` with device histograms
over its completion stream, and ``fill`` then ``clear_inflight``.  It gives
the fused path's state and values bit for bit.

``BamRuntime`` registers several tenants, each a ``BamArray`` with its own
storage and a ``TenantCtx`` (tenant id and cache way window), against one
``CacheState`` and one ``QueueState``.  Under ``drain="deferred"`` the
tenants' ops leave their commands in the shared rings and
``BamRuntime.drain`` retires the mixed stream once a round, weighted-fair
across tenants.

Differences from the reference, none of which changes a value:

* state is updated in place (the returned state is the one passed in);
* ``lax.cond`` fast paths are host-side branches on a synced bool;
* after coalescing, ``unique_keys`` is cut to ``num_unique`` rows (one host
  read per submit) and every per-line buffer is sized by that count, where
  the reference sizes them by the wavefront width.  The -1 padding rows are
  inert, so cache, rings and metrics are identical; at BFS/CC wavefronts of
  2^28 lanes the reference's fetch buffer would not fit in device memory.

* ``BamRuntime.tenant_view`` hands out a copy of the tenant's
  ``IOMetrics`` (the cache and rings stay the shared objects), so that
  ``absorb`` can fold the op's delta into the global metrics; take a fresh
  view for each op.

Not ported: the bucketed ops, the ``*_jit`` family and ``kernel_impl``
(dispatch goes by tensor device).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import cache as C
from repro_torch.core import queues as Q
from repro_torch.core.coalescer import coalesce
from repro_torch.core.metrics import (ADDITIVE_FIELDS, IOMetrics,
                                      metrics_accumulate, metrics_delta,
                                      metrics_sum, recheck_token_watermark)
from repro_torch.core.prefetch import PrefetchConfig, readahead_keys
from repro_torch.core.ssd import (ArrayOfSSDs, INTEL_OPTANE_P5800X,
                                  device_histogram, device_of_block,
                                  mul_u32)
from repro_torch.core.storage import HBMStorage, SimStorage
from repro_torch.kernels import ops as K
from repro_torch.utils import resolve_device, round_up

__all__ = ["BamArray", "BamState", "BamKVStore", "BamRuntime", "IORequest",
           "IOToken", "PrefetchConfig", "RuntimeState", "TenantCtx",
           "TenantSpec"]

F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class TenantCtx:
    """Static multi-tenant context of one :class:`BamArray`: ``tenant``
    namespaces its cache tags and queue commands, ``[way_lo, way_hi)`` is
    its cache way quota (``way_hi=None``: all ways).  The default is the
    single tenant: tenant 0 over the whole cache."""

    tenant: int = 0
    way_lo: int = 0
    way_hi: int | None = None


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
    """Unified op descriptor: ``kind`` is "read", "write" or "prefetch";
    ``idx`` a wavefront of element indices; ``valid`` a lane mask (``None``
    = bounds check); ``values`` the write payload."""

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
    :meth:`BamArray.wait`.  ``ukeys``, ``pin_slots`` and ``ticket`` have one
    row per unique line (``num_unique`` rows, at least one).  The per-device
    command histograms ``dev_reads`` / ``dev_writes`` (ring-dropped commands
    included) are the deferred drain's charge basis; arrays that drain at
    every wait leave them ``None``."""

    kind: str
    valid: torch.Tensor           # (n,) request lanes
    off: torch.Tensor             # (n,) element offset within its line
    inverse: torch.Tensor         # (n,) lane -> unique-line row
    ukeys: torch.Tensor           # (u,) coalesced block keys
    pin_slots: torch.Tensor       # (u,) slots pinned at submit (-1 none)
    values: Optional[torch.Tensor]  # (n,) write payload
    # (u,) fault-hash ordinal of the row's own fetch command, -1 for rows
    # that enqueued none (hits, riders on another token's fetch, drops)
    ticket: torch.Tensor
    ra_keys: Optional[torch.Tensor]    # (window,) readahead keys claimed
    ra_ticket: Optional[torch.Tensor]  # (window,) their command ordinals
    drop_dev_reads: torch.Tensor  # (nd,) read commands the rings rejected
    drop_dev_writes: torch.Tensor  # (nd,) write commands the rings rejected
    dropped_mask: torch.Tensor    # (n,) lanes whose command was dropped
    dev_reads: Optional[torch.Tensor] = None   # (nd,) read commands issued
    dev_writes: Optional[torch.Tensor] = None  # (nd,) write commands issued
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
    prefetch_cfg: PrefetchConfig = dataclasses.field(
        default_factory=PrefetchConfig)
    tenant_ctx: TenantCtx = dataclasses.field(default_factory=TenantCtx)
    # Deferred drain (multi-tenant): ops leave their commands in the rings
    # and the runtime drains once per round (BamRuntime.drain).
    defer_drain: bool = False
    # False: the legacy step-by-step path (the fused path's oracle).
    fused_rounds: bool = True

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
        ``fused_rounds=False`` runs the legacy step-by-step path.
        """
        import numpy as np

        dev = resolve_device(device)
        ssd = ssd or ArrayOfSSDs(INTEL_OPTANE_P5800X, 1)
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
                       block_elems=block_elems, device=dev, ssd=ssd,
                       prefetch_cfg=prefetch or PrefetchConfig(),
                       fused_rounds=fused_rounds)
        st = BamState(
            cache=C.make_cache(num_sets, ways, block_elems, dtype, dev),
            queues=Q.make_queues(num_queues, queue_depth,
                                 n_devices=ssd.n_devices,
                                 stripe_blocks=ssd.stripe_blocks,
                                 failed_devices=ssd.fault.failed_devices,
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

    def with_prefetch(self, cfg: PrefetchConfig) -> "BamArray":
        """The same array under another readahead policy."""
        return dataclasses.replace(self, prefetch_cfg=cfg)

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
        # bamlint: ignore[BAM104] -- both sides are static host tuples
        if qs.failed_devices != self.ssd.fault.failed_devices:
            raise ValueError(
                f"queue failed_devices {qs.failed_devices} do not match the "
                f"SSD fault model's {self.ssd.fault.failed_devices}")

    def _split(self, idx: torch.Tensor):
        return (torch.div(idx, self.block_elems, rounding_mode="floor")
                .to(torch.int32),
                torch.remainder(idx, self.block_elems).to(torch.int32))

    def _hist(self, keys, mask=None):
        return device_histogram(keys, self.ssd.n_devices, mask,
                                self.ssd.stripe_blocks,
                                self.ssd.fault.failed_devices)

    def _enqueue(self, qs: Q.QueueState, segs):
        """The SQ enqueue of a submission: one fused pass, or on the legacy
        path one ``enqueue`` per segment (bit-identical)."""
        tenant = self.tenant_ctx.tenant
        if self.fused_rounds:
            return Q.enqueue_segments(qs, segs, tenant=tenant)
        recs = []
        for keys, dst, is_write, valid, prio in segs:  # bamlint: ignore[BAM104]
            qs, rec = Q.enqueue(qs, keys, dst=dst, is_write=is_write,
                                valid=valid, prio=prio, tenant=tenant)
            recs.append(rec)
        return qs, recs

    def _drain(self, qs: Q.QueueState):
        """Drain the rings, in place: ``(reads_dev, writes_dev, fstats)``,
        the per-device completions and (fault model on) the drain's fault
        counts.  Closed-form accounting on the fused path; on the legacy
        path ``service_all`` and device histograms over its stream."""
        fault = self.ssd.fault
        fm = fault if fault.enabled else None
        if self.fused_rounds:
            _, dr = Q.drain_accounting(qs, fault=fm)
            fstats = None if fm is None else dict(
                err_reads=dr.err_reads_dev, err_writes=dr.err_writes_dev,
                retry_reads=dr.retry_reads_dev,
                retry_writes=dr.retry_writes_dev,
                transient=dr.transient_errors)
            return dr.reads_dev, dr.writes_dev, fstats
        _, comps = Q.service_all(qs, fault=fm)
        cvalid = comps.valid
        reads = self._hist(comps.keys, cvalid & ~comps.is_write)
        writes = self._hist(comps.keys, cvalid & comps.is_write)
        fstats = None if fm is None else dict(
            err_reads=comps.err_reads_dev, err_writes=comps.err_writes_dev,
            retry_reads=comps.retry_reads_dev,
            retry_writes=comps.retry_writes_dev, transient=comps.transient)
        return reads, writes, fstats

    def _write_back(self, st: BamState, ok: torch.Tensor, slots, keys
                    ) -> None:
        """Persist the evicted dirty lines ``cache.data[slots[ok]]`` under
        ``keys``.  Host-side branch in place of the reference's lax.cond
        on any(ok) (a device sync): a wavefront that evicted nothing dirty
        never touches the line store."""
        if bool(ok.any()):
            lines = st.cache.data[torch.where(ok, slots, 0).to(torch.int64)]
            self._store(st).write_blocks(keys, lines)

    # ----------------------------------------------------------- async core
    def submit(self, st: BamState, req: IORequest
               ) -> Tuple[BamState, IOToken]:
        """Issue a wavefront of storage commands without draining them:
        coalesce -> fused probe+allocate -> pin (+ mark in flight) -> write
        back evicted dirty lines -> readahead claim -> enqueue SQ
        commands."""
        self._check_channels(st)
        kind = req.kind
        if kind not in ("read", "write", "prefetch"):
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
        if kind == "prefetch":
            return self._submit_prefetch(st, co.inverse_idx, ukeys, off,
                                         valid)
        uvalid = ukeys >= 0
        mt = st.metrics
        ctx = self.tenant_ctx
        win = dict(tenant=ctx.tenant, way_lo=ctx.way_lo, way_hi=ctx.way_hi)

        # 2+3) fused probe + victim allocate: one probe_allocate kernel pass
        cache, pr, alloc = C.probe_allocate(st.cache, ukeys, uvalid, **win)
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
        if self.fused_rounds:
            C.grant_bookkeeping(cache, n_hit, promote_slots, pin_slots,
                                grant_slots)
        else:
            C.count_hits(cache, n_hit)
            C.promote(cache, promote_slots)
            C.acquire(cache, pin_slots)
            C.mark_inflight(cache, grant_slots)

        # 4) evicted dirty lines -> write-back commands (persisted in 6).
        wb = alloc.ok & alloc.evicted_dirty & (alloc.evicted_key >= 0)
        wb_keys = torch.where(wb, alloc.evicted_key, -1)

        # 4b) readahead (read ops): extrapolate the wavefront's stride and
        #     claim the predicted lines as speculative, in-flight residents,
        #     never a line this wavefront just evicted.  This wavefront's
        #     hit and granted slots are protected, the probe's hits are not.
        cfg = self.prefetch_cfg
        ra_on = kind == "read" and cfg.enabled and cfg.window > 0
        ra_keys = ra_alloc = None
        if ra_on:
            ra_cand = readahead_keys(
                ukeys, uvalid, window=cfg.window, num_blocks=self.num_blocks,
                min_support=cfg.min_support, max_stride=cfg.max_stride,
                raw_keys=blk, raw_valid=valid)
            evk = torch.where(alloc.ok & (alloc.evicted_key >= 0),
                              alloc.evicted_key, -2)
            cache, _, ra_alloc = C.probe_allocate(
                cache, ra_cand, ra_cand >= 0,
                alloc_mask=~torch.isin(ra_cand, evk),
                protect_slots=torch.cat([pr.slot, alloc.slot]),
                protect_hits=False, speculative=True, **win)
            ra_keys = torch.where(ra_alloc.ok, ra_cand, -1)
            ra_wb = ra_alloc.ok & ra_alloc.evicted_dirty \
                & (ra_alloc.evicted_key >= 0)
            ra_wb_keys = torch.where(ra_wb, ra_alloc.evicted_key, -1)
            C.mark_inflight(cache, torch.where(ra_alloc.ok, ra_alloc.slot,
                                               -1))

        # 5) enqueue reads + write-backs (+ write-through of bypassed lines,
        #    + readahead last, in the low-priority lane)
        read_keys = torch.where(miss, ukeys, -1)
        segs = [(read_keys, alloc.slot, None, None, Q.PRIO_DEMAND),
                (wb_keys, None, torch.ones_like(wb), None, Q.PRIO_DEMAND)]
        if kind == "write":
            byp = miss & ~alloc.ok
            bt_keys = torch.where(byp, ukeys, -1)
            segs.append((bt_keys, None, torch.ones_like(byp), None,
                         Q.PRIO_DEMAND))
        if ra_on:
            segs.append((ra_wb_keys, None, torch.ones_like(ra_wb), None,
                         Q.PRIO_DEMAND))
            segs.append((ra_keys, ra_alloc.slot, None, None,
                         Q.PRIO_READAHEAD))
        qs, recs = self._enqueue(st.queues, segs)
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
        ra_ticket = None
        if ra_on:
            rec_rw, rec_ra = recs[2], recs[3]
            n_doorbells = n_doorbells + rec_rw.n_doorbells \
                + rec_ra.n_doorbells
            n_dropped = n_dropped + rec_rw.n_dropped + rec_ra.n_dropped
            drop_reads = drop_reads + self._hist(ra_keys, ~rec_ra.accepted)
            drop_writes = drop_writes + self._hist(ra_wb_keys,
                                                   ~rec_rw.accepted)
            ra_ticket = rec_ra.ticket
        depth_now = Q.in_flight(qs)
        depth_dev = Q.in_flight_per_device(qs)
        dev_reads = dev_writes = None
        if self.defer_drain:        # the deferred drain's charge basis
            dev_reads = self._hist(ukeys, miss)
            dev_writes = self._hist(wb_keys)
            if kind == "write":
                dev_writes = dev_writes + self._hist(bt_keys)
            if ra_on:
                dev_reads = dev_reads + self._hist(ra_keys)
                dev_writes = dev_writes + self._hist(ra_wb_keys)

        # 6) persist evicted dirty lines (submit does not change the data
        #    array, so the lines are read as they were evicted)
        self._write_back(st, wb, alloc.slot, wb_keys)
        if ra_on:
            self._write_back(st, ra_wb, ra_alloc.slot, ra_wb_keys)

        # 7) submission-side metrics, in place
        n_valid = valid.sum(dtype=torch.int32)
        n_miss = miss.sum(dtype=torch.int32)
        n_wb = wb.sum(dtype=torch.int32)
        if kind == "write":
            n_wb = n_wb + byp.sum(dtype=torch.int32)
        if ra_on:
            n_wb = n_wb + ra_wb.sum(dtype=torch.int32)
            mt.prefetch_issued += ra_alloc.ok.sum(dtype=torch.int32)
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
            ticket=rec_r.ticket, ra_keys=ra_keys, ra_ticket=ra_ticket,
            drop_dev_reads=drop_reads, drop_dev_writes=drop_writes,
            dropped_mask=valid & drop_u[co.inverse_idx.to(torch.int64)],
            dev_reads=dev_reads, dev_writes=dev_writes)
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
            ticket=z(fill=-1), ra_keys=None, ra_ticket=None,
            drop_dev_reads=zh, drop_dev_writes=zh.clone(),
            dropped_mask=z(torch.bool))
        return st, token

    def _submit_prefetch(self, st: BamState, inverse, ukeys, off, valid
                         ) -> Tuple[BamState, IOToken]:
        """Prefetch submission: speculative insert through the readahead
        lane.  The granted lines are not pinned (a hint that never
        materialises is the clock hand's first victim) but carry the
        in-flight bit, so demand submissions coalesce against them."""
        mt = st.metrics
        ctx = self.tenant_ctx
        uvalid = ukeys >= 0
        cache, pr, alloc = C.probe_allocate(
            st.cache, ukeys, uvalid, speculative=True, tenant=ctx.tenant,
            way_lo=ctx.way_lo, way_hi=ctx.way_hi)
        n_cross = pr.inflight.sum(dtype=torch.int32)
        wb = alloc.ok & alloc.evicted_dirty & (alloc.evicted_key >= 0)
        wb_keys = torch.where(wb, alloc.evicted_key, -1)
        keys = torch.where(alloc.ok, ukeys, -1)
        C.mark_inflight(cache, torch.where(alloc.ok, alloc.slot, -1))
        qs, (rec_w, rec_r) = self._enqueue(st.queues, [
            (wb_keys, None, torch.ones_like(wb), None, Q.PRIO_DEMAND),
            (keys, alloc.slot, None, None, Q.PRIO_READAHEAD)])
        depth_now = Q.in_flight(qs)
        depth_dev = Q.in_flight_per_device(qs)
        self._write_back(st, wb, alloc.slot, wb_keys)

        n_wb = wb.sum(dtype=torch.int32)
        tok_new = valid.any().to(F64)
        window_now = (mt.tokens_in_flight + tok_new).to(torch.int32)
        mt.write_ops += n_wb
        mt.bytes_to_storage += n_wb.to(F64) * self.block_bytes
        mt.doorbells += rec_r.n_doorbells + rec_w.n_doorbells
        mt.dropped += rec_r.n_dropped + rec_w.n_dropped
        mt.prefetch_issued += alloc.ok.sum(dtype=torch.int32)
        mt.max_queue_depth = torch.maximum(mt.max_queue_depth, depth_now)
        mt.dev_max_depth = torch.maximum(mt.dev_max_depth, depth_dev)
        mt.tokens_submitted += tok_new
        mt.tokens_in_flight += tok_new
        mt.cross_op_coalesced += n_cross
        mt.max_tokens_in_flight = torch.maximum(mt.max_tokens_in_flight,
                                                window_now)
        token = IOToken(
            kind="prefetch", valid=valid, off=off, inverse=inverse,
            ukeys=ukeys, pin_slots=torch.full_like(ukeys, -1), values=None,
            ticket=rec_r.ticket, ra_keys=None, ra_ticket=None,
            drop_dev_reads=self._hist(keys, ~rec_r.accepted),
            drop_dev_writes=self._hist(wb_keys, ~rec_w.accepted),
            dropped_mask=valid & (alloc.ok & ~rec_r.accepted)[
                inverse.to(torch.int64)],
            dev_reads=self._hist(keys) if self.defer_drain else None,
            dev_writes=self._hist(wb_keys) if self.defer_drain else None)
        return st, token

    def _fetch_gated(self, store, keys: torch.Tensor,
                     need: torch.Tensor) -> torch.Tensor:
        """Fetch ``keys`` (-1 rows give zeros).  Host-side branch in place
        of the reference's lax.cond on any(need) (a device sync): a fused
        wait with nothing to fetch never pays the host round trip.  The
        legacy path always fetches, as in the reference."""
        if self.fused_rounds and isinstance(store, SimStorage) \
                and not bool(need.any()):
            return torch.zeros((keys.shape[0], self.block_elems),
                               dtype=store.dtype, device=self.device)
        return store.fetch_blocks(keys)

    def _status(self, keys: torch.Tensor, ticket: torch.Tensor):
        """``ok`` of each row's own command under the fault model, from
        its ``(device, ticket)`` stamp: the function the drain applies."""
        ssd = self.ssd
        dev = device_of_block(keys, ssd.n_devices, ssd.stripe_blocks,
                              ssd.fault.failed_devices)
        return ssd.fault.command_status(dev, ticket)[0]

    def wait(self, st: BamState, token: IOToken
             ) -> Tuple[BamState, torch.Tensor]:
        """Complete a pending token: drain, fetch, fill, gather, unpin.
        Returns ``(state, values)``; a second wait of a token raises."""
        st, vals, _ = self.wait_ex(st, token)
        return st, vals

    def wait_ex(self, st: BamState, token: IOToken
                ) -> Tuple[BamState, torch.Tensor, torch.Tensor]:
        """:meth:`wait` returning ``(state, values, error_mask)``.  The mask
        is True on a lane whose line's own fetch command errored past the
        fault model's retry budget (or went to a hard-failed device): the
        lane reads 0, its write payload is withheld and the line is
        invalidated, never filled.  With the fault model disabled the mask
        is all False.

        Under ``defer_drain`` the rings are left for the runtime's round
        drain, and the token's own command histograms (and, fault model
        on, its own commands' fates) are charged instead."""
        _mark_redeemed(token)
        self._check_channels(st)
        dev = self.device
        fault = self.ssd.fault
        if token.ukeys.shape[0] == 0:
            return (st, torch.zeros((0,), dtype=self.dtype, device=dev),
                    torch.zeros((0,), dtype=torch.bool, device=dev))
        ctx = self.tenant_ctx
        ukeys = token.ukeys
        uvalid = ukeys >= 0
        valid = token.valid
        off = token.off
        charge_qs = (st.queues.group_size, st.queues.depth)

        # 1) drain the rings, in place, and pick the device-time charge
        #    basis: the drained batch plus this token's ring-rejected
        #    commands (still served read/write-through), or under the
        #    deferred drain this token's own commands
        if self.defer_drain:
            reads_charge, writes_charge = token.dev_reads, token.dev_writes
            fstats = self._token_fault_stats(token) if fault.enabled \
                else None
        else:
            reads_charge, writes_charge, fstats = self._drain(st.queues)
            reads_charge = reads_charge + token.drop_dev_reads
            writes_charge = writes_charge + token.drop_dev_writes

        # 2) fresh probe through the cache_probe kernel (owner-matched), and
        #    this token's command fates from their (device, ticket) stamps
        pr2 = C.probe(st.cache, ukeys, uvalid, tenant=ctx.tenant)
        pend = pr2.hit & pr2.inflight
        if fault.enabled:
            ok_u = self._status(ukeys, token.ticket)
            failed_u = uvalid & ~ok_u
        else:
            ok_u = failed_u = None
        if token.kind == "prefetch":
            need = pend
        else:
            need = uvalid & (~pr2.hit | pend)
        if failed_u is not None:
            need = need & ~failed_u

        # 3) the deferred fetch DMA + completion fill (failed commands
        #    invalidate their pending line instead)
        store = self._store(st)
        lines = self._fetch_gated(store, torch.where(need, ukeys, -1), need)
        cache = st.cache
        self._complete(cache, pr2.slot, pend, lines, ok_u)
        n_fetch = need.sum(dtype=torch.int32)

        # 3b) the readahead lines this token's submit claimed; a failed
        #     speculative fetch is invalidated and errors no lane
        if token.ra_keys is not None:
            ra = token.ra_keys
            ra_pr = C.probe(cache, ra, ra >= 0, tenant=ctx.tenant)
            ra_pend = ra_pr.hit & ra_pr.inflight
            ra_need = ra_pend
            ra_ok = None
            if fault.enabled:
                ra_ok = self._status(ra, token.ra_ticket)
                ra_need = ra_pend & ((ra < 0) | ra_ok)
            lines_ra = self._fetch_gated(store, torch.where(ra_need, ra, -1),
                                         ra_need)
            self._complete(cache, ra_pr.slot, ra_pend, lines_ra, ra_ok)
            n_fetch = n_fetch + ra_need.sum(dtype=torch.int32)

        # 4) op-specific completion; lines are stored in the cache's dtype
        #    and values come back in this array's
        u = token.inverse.to(torch.int64)
        zero = torch.zeros((), dtype=self.dtype, device=dev)
        err = valid & failed_u[u] if failed_u is not None \
            else torch.zeros(valid.shape, dtype=torch.bool, device=dev)
        hit_u = pr2.hit[u]
        slot_u = torch.where(hit_u, pr2.slot[u], -1)
        if token.kind == "read":
            hit_vals = K.gather_blocks(cache.data, slot_u, off=off)
            miss_vals = lines.view(-1)[u * self.block_elems + off]
            vals = torch.where(hit_u, hit_vals, miss_vals).to(self.dtype)
            vals = torch.where(valid & ~err, vals, zero)
        elif token.kind == "write":
            values = token.values.to(self.dtype)
            wr = valid & ~err
            # scatter the new element values into resident lines...
            in_cache = wr & (slot_u >= 0)
            sel = torch.nonzero(in_cache).squeeze(1)
            if sel.numel() > 0:  # bamlint: ignore[BAM104] -- host branch
                cache.data[slot_u[sel].to(torch.int64),
                           off[sel].to(torch.int64)] = values[sel].to(
                    cache.data.dtype)
            C.mark_dirty(cache, torch.where(in_cache, slot_u, -1))
            # ...and write through the lines that have no slot (bypass); a
            # bypassed row whose fetch errored writes nothing
            byp_u = ~hit_u & wr
            byp_lines = lines.clone()
            sel = torch.nonzero(byp_u).squeeze(1)
            if sel.numel() > 0:  # bamlint: ignore[BAM104] -- host branch
                byp_lines[u[sel], off[sel].to(torch.int64)] = values[sel]
            bt = uvalid & ~pr2.hit
            if failed_u is not None:
                bt = bt & ~failed_u
            store.write_blocks(torch.where(bt, ukeys, -1), byp_lines)
            vals = torch.where(wr, values, zero)
        else:                                   # prefetch: no values
            vals = torch.zeros(off.shape, dtype=self.dtype, device=dev)

        # 5) release the pins taken at submit
        C.release(cache, token.pin_slots)

        # 6) completion-side metrics
        mt = st.metrics
        tok_done = valid.any().to(F64)
        mt.bytes_from_storage += n_fetch.to(F64) * self.block_bytes
        mt.tokens_waited += tok_done
        mt.tokens_in_flight -= tok_done
        if fstats is not None:
            self._charge_faults(mt, fstats)
            mt.degraded_reads += err.sum(dtype=torch.int32)
        self._charge_wait(mt, charge_qs, reads_charge, writes_charge, fstats)
        return st, vals, err

    def _complete(self, cache: C.CacheState, slots, pend, lines, ok) -> None:
        """Completion fill, in place: fill the ``pend`` slots and clear
        their in-flight bit, invalidating those whose command failed
        (``ok``, fault model on).  The legacy path without a fault model
        runs ``fill`` then ``clear_inflight``, as the reference does."""
        if self.fused_rounds or ok is not None:
            C.fill_complete(cache, slots, pend, lines, ok)
        else:
            C.fill(cache, slots, pend, lines)
            C.clear_inflight(cache, torch.where(pend, slots, -1))

    def _token_fault_stats(self, token: IOToken) -> dict:
        """Fault accounting from a token's own command tickets (deferred
        drain: the shared rings are not drained here).  Read commands only;
        write-backs carry no token ticket, their errors surface at the
        round drain."""
        ssd = self.ssd
        nd = ssd.n_devices

        def per_dev(keys, ticket):
            dev = device_of_block(keys, nd, ssd.stripe_blocks,
                                  ssd.fault.failed_devices)
            ok, retry, trans = ssd.fault.command_status(dev, ticket)
            d64 = dev.to(torch.int64)
            err = torch.zeros((nd,), dtype=torch.int32, device=dev.device)
            err.index_add_(0, d64, (~ok).to(torch.int32))
            rty = torch.zeros_like(err).index_add_(0, d64, retry)
            return err, rty, trans.sum(dtype=torch.int32)

        err_reads, retry_reads, transient = per_dev(token.ukeys, token.ticket)
        if token.ra_ticket is not None:
            e, r, t = per_dev(token.ra_keys, token.ra_ticket)
            err_reads, retry_reads = err_reads + e, retry_reads + r
            transient = transient + t
        zero = torch.zeros_like(err_reads)
        return dict(err_reads=err_reads, err_writes=zero,
                    retry_reads=retry_reads, retry_writes=zero,
                    transient=transient)

    @staticmethod
    def _charge_faults(mt: IOMetrics, fstats: dict) -> None:
        """A drain's fault counters, in place."""
        n_err = fstats["err_reads"] + fstats["err_writes"]
        mt.transient_errors += fstats["transient"]
        mt.retries += (fstats["retry_reads"] + fstats["retry_writes"]).sum(
            dtype=torch.int32)
        mt.failed_commands += n_err.sum(dtype=torch.int32)
        mt.dev_errors += n_err

    def _charge_wait(self, mt: IOMetrics, qs_geom, reads_hist: torch.Tensor,
                     writes_hist: torch.Tensor, fstats: dict | None) -> None:
        """Device-time charge for a drain, in place: each channel retires
        its share at its own Little's-law rate, the straggler gates the
        batch.  With fault accounting (``fstats``) every re-issue costs
        ``tail_latency_mult`` commands of service time on its device, and
        the data counters count only the commands that completed.  The
        charge is float32 (as in the reference), accumulated in float64."""
        group_size, depth = qs_geom
        limit = group_size * depth
        t_reads, t_writes = reads_hist, writes_hist
        ok_reads, ok_writes = reads_hist, writes_hist
        if fstats is not None:
            mult = self.ssd.fault.tail_latency_mult
            t_reads = reads_hist + mult * fstats["retry_reads"]
            t_writes = writes_hist + mult * fstats["retry_writes"]
            ok_reads = reads_hist - fstats["err_reads"]
            ok_writes = writes_hist - fstats["err_writes"]
        t_read, t_read_dev = self.ssd.service_time_per_device(
            t_reads, self.block_bytes, queue_depth_limit=limit)
        t_write, t_write_dev = self.ssd.service_time_per_device(
            t_writes, self.block_bytes, write=True,
            queue_depth_limit=limit)
        mt.sim_time_s += t_read
        mt.sim_time_s += t_write
        mt.read_time_s += t_read
        mt.write_time_s += t_write
        mt.dev_reads += ok_reads
        mt.dev_writes += ok_writes
        mt.dev_bytes += (ok_reads + ok_writes).to(F64) * self.block_bytes
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

    def prefetch(self, st: BamState, idx: torch.Tensor,
                 valid: torch.Tensor | None = None) -> BamState:
        """Warm the cache for a future wavefront, no values: the lines are
        brought in as speculative, unpinned residents through the readahead
        lane, whatever ``PrefetchConfig.enabled`` says.  Demand counters
        are untouched.  ``submit`` + ``wait`` of an ``IORequest.prefetch``."""
        st, tok = self.submit(st, IORequest.prefetch(idx, valid))
        st, _ = self.wait(st, tok)
        return st

    def write(self, st: BamState, idx: torch.Tensor, values: torch.Tensor,
              valid: torch.Tensor | None = None) -> BamState:
        """Element writes (read-modify-write with write-allocate)."""
        st, tok = self.submit(st, IORequest.write(idx, values, valid))
        st, _ = self.wait(st, tok)
        return st

    def flush(self, st: BamState) -> BamState:
        """Write back every dirty resident line of this tenant through the
        SQ rings: enqueue, doorbell, drain (under ``defer_drain`` the
        drain is the runtime's).  Under the fault model an errored flush
        command costs its attempts in the counters, but the line is
        persisted all the same.  Another tenant's dirty lines are left as
        they are: their write-back belongs to its own storage."""
        self._check_channels(st)
        cache = st.cache
        tags = cache.tags.view(-1)
        dirty = cache.dirty.view(-1)
        mine = cache.owner.view(-1) == self.tenant_ctx.tenant
        keys = torch.where(dirty & mine & (tags >= 0), tags, -1)
        charge_qs = (st.queues.group_size, st.queues.depth)
        qs, rec_w = Q.enqueue(st.queues, keys,
                              is_write=torch.ones(keys.shape,
                                                  dtype=torch.bool,
                                                  device=keys.device),
                              tenant=self.tenant_ctx.tenant)
        depth_now = Q.in_flight(qs)
        depth_dev = Q.in_flight_per_device(qs)
        if self.defer_drain:
            reads_charge = torch.zeros_like(depth_dev)
            writes_charge = self._hist(keys)
            fstats = None
        else:
            reads_charge, writes_charge, fstats = self._drain(qs)
            writes_charge = writes_charge + self._hist(keys, ~rec_w.accepted)
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
        if fstats is not None:
            self._charge_faults(mt, fstats)
        self._charge_wait(mt, charge_qs, reads_charge, writes_charge, fstats)
        recheck_token_watermark(mt)
        return st


@dataclasses.dataclass
class BamKVStore:
    """Key-value store: a device-resident open-addressed index (one int32
    key per capacity slot) over storage-resident fixed-width values behind
    a :class:`BamArray`."""

    array: BamArray                 # values: (capacity, value_elems)
    capacity: int
    value_elems: int
    probes: int = 8

    @staticmethod
    def _hash_host(key: int, capacity: int) -> int:
        """Knuth multiply with a uint32 wrap, then mod: the slot a key's
        probe starts at.  The wrap comes before the modulo on both sides
        (:meth:`_hash_traced` is the device form), and there is no ``abs``
        (``abs(INT32_MIN)`` is negative in int32)."""
        return ((int(key) & 0xFFFFFFFF) * 2654435761 & 0xFFFFFFFF) % capacity

    def _hash_traced(self, keys: torch.Tensor) -> torch.Tensor:
        """:meth:`_hash_host` of a key wavefront -> int32 slots in [0,
        capacity).  Torch has no uint32 multiply: the product is reduced
        mod 2^32 by ``mul_u32`` in int64, then taken mod the capacity."""
        h = mul_u32(keys.to(torch.int64) & 0xFFFFFFFF, 2654435761)
        return torch.remainder(h, self.capacity).to(torch.int32)

    @staticmethod
    def build_table(keys, values, *, capacity: int | None = None,
                    probes: int = 8):
        """Host-side open-addressing placement, a loop in key order (the
        placement under collisions depends on it): ``(table, store_vals,
        capacity)``, where ``store_vals[(hash(k)+j) % capacity]`` holds key
        ``k``'s value row."""
        import numpy as np

        keys = np.asarray(keys, np.int32)
        values = np.asarray(values)
        n, value_elems = values.shape
        capacity = capacity or max(2 * n, 16)
        table = np.full((capacity,), -1, np.int32)
        store_vals = np.zeros((capacity, value_elems), values.dtype)
        for i, k in enumerate(keys.tolist()):
            if k == -1:
                raise ValueError(
                    "key -1 is reserved as the empty-slot sentinel")
            h = BamKVStore._hash_host(k, capacity)
            # place within lookup's probe window only: a key parked further
            # out could never be found
            for j in range(min(probes, capacity)):
                s = (h + j) % capacity
                if table[s] == -1 or table[s] == k:
                    table[s] = k
                    store_vals[s] = values[i]
                    break
            else:
                raise ValueError(
                    f"kv store: key {int(k)} cannot be placed within "
                    f"probes={probes} slots of its home slot; raise "
                    "capacity or probes")
        return table, store_vals, capacity

    @staticmethod
    def build(keys, values, *, capacity: int | None = None, probes: int = 8,
              **bam_kw):
        """Host-side bulk build: ``(kv, index_table, BamState)``; the table
        lies on the array's device (``device=`` in ``bam_kw``, default
        CUDA)."""
        import numpy as np

        values = np.asarray(values)
        _, value_elems = values.shape
        table, store_vals, capacity = BamKVStore.build_table(
            keys, values, capacity=capacity, probes=probes)
        bam_kw.setdefault("block_elems", value_elems)
        arr, st = BamArray.build(store_vals, **bam_kw)
        kv = BamKVStore(array=arr, capacity=capacity,
                        value_elems=value_elems, probes=probes)
        return kv, torch.from_numpy(table).to(arr.device), st

    def lookup_submit(self, st: BamState, table: torch.Tensor,
                      keys: torch.Tensor
                      ) -> Tuple[BamState, IOToken, torch.Tensor]:
        """Probe the index and submit the value gather: ``(state, token,
        found)``.  ``found`` is ready at once; the values come with
        :meth:`lookup_wait`."""
        keys = keys.to(table.device)
        h = self._hash_traced(keys).to(torch.int64)
        slot = torch.full(keys.shape, -1, dtype=torch.int64,
                          device=keys.device)
        for j in range(self.probes):
            s = torch.remainder(h + j, self.capacity)
            match = (table[s] == keys) & (slot < 0)
            slot = torch.where(match, s, slot)
        # key -1 would match every empty slot (the sentinel): never found
        found = (slot >= 0) & (keys != -1)
        base = torch.where(found, slot, 0).to(torch.int32) * self.value_elems
        idx = (base[:, None] + torch.arange(
            self.value_elems, dtype=torch.int32,
            device=keys.device)[None, :]).reshape(-1)
        vmask = found.repeat_interleave(self.value_elems)
        st, tok = self.array.submit(st, IORequest.read(idx, vmask))
        return st, tok, found

    def lookup_wait(self, st: BamState, token: IOToken
                    ) -> Tuple[BamState, torch.Tensor]:
        """Redeem a :meth:`lookup_submit` token: ``(state, values)``, the
        values shaped ``(n_keys, value_elems)``."""
        st, flat = self.array.wait(st, token)
        return st, flat.reshape(-1, self.value_elems)

    def lookup(self, st: BamState, table: torch.Tensor, keys: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, BamState]:
        """``(values, found, state)`` for a wavefront of keys."""
        st, tok, found = self.lookup_submit(st, table, keys)
        st, vals = self.lookup_wait(st, tok)
        return vals, found, st


# ===================================================================== runtime
@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's registration against a :class:`BamRuntime`: ``ways`` is
    its way quota under ``isolation="partitioned"`` (``None``: an equal
    split of the ways left), ``weight`` its service weight in the
    weighted-fair drain."""

    name: str
    data: Any                      # host array backing this tenant
    block_elems: int
    ways: int | None = None
    weight: float = 1.0
    prefetch: Optional[PrefetchConfig] = None


@dataclasses.dataclass
class RuntimeState:
    """All mutable state of a shared runtime: one cache and one queue pool
    for every tenant, metrics per tenant and global.  Every additive
    counter of ``metrics`` equals the sum of the tenants' counters
    (:meth:`BamRuntime.assert_metrics_consistent`)."""

    cache: C.CacheState
    queues: Q.QueueState
    metrics: IOMetrics             # global accumulator
    tenant_metrics: tuple          # per-tenant IOMetrics, by tenant id
    storages: tuple                # per-tenant device store (None: sim)


def _mantissa_bits(dtype: torch.dtype) -> int:
    return int(round(-math.log2(torch.finfo(dtype).eps)))


@dataclasses.dataclass
class BamRuntime:
    """The shared multi-tenant BaM runtime: several tenants, each a
    :class:`BamArray` over its own storage, against one ``CacheState`` and
    one ``QueueState``.

    * Cache isolation is way partitioning: under ``isolation="partitioned"``
      each tenant's clock sweep stays inside its way quota; ``"shared"``
      lets tenants evict each other's clean lines.
    * The rings are shared under weighted-fair arbitration: commands carry
      their tenant id and the drain serves tenants in proportion to their
      weights within each priority class.
    * Metrics are kept per tenant and globally; additive counters sum
      exactly.

    Tenants share the cache line geometry and the cache's dtype: lines are
    stored in ``cache_dtype`` and cast back to each tenant's dtype on read
    (exact for integer tenants within the dtype's integer range, 2^24 for
    float32).
    """

    tenants: Dict[str, BamArray]
    tenant_ids: Dict[str, int]
    isolation: str
    ways: int
    drain_mode: str = "per_op"

    # ---------------------------------------------------------------- build
    @staticmethod
    def build(specs: Sequence[TenantSpec], *, num_sets: int, ways: int = 8,
              num_queues: int = 8, queue_depth: int = 1024,
              ssd: Optional[ArrayOfSSDs] = None,
              isolation: str = "partitioned", drain: str = "per_op",
              backend: str = "sim", cache_dtype=torch.float32,
              device=None) -> Tuple["BamRuntime", RuntimeState]:
        """``drain="per_op"`` drains the rings inside every tenant op, as a
        standalone array does; ``drain="deferred"`` leaves the commands
        pending, and the caller drains once per round with :meth:`drain`.
        Values are the same either way.  ``device`` defaults to
        ``"cuda"``."""
        import numpy as np

        if isolation not in ("partitioned", "shared"):
            raise ValueError(f"isolation must be 'partitioned' or 'shared', "
                             f"got {isolation!r}")
        if drain not in ("per_op", "deferred"):
            raise ValueError(
                f"drain must be 'per_op' or 'deferred', got {drain!r}")
        if not specs:
            raise ValueError("need at least one TenantSpec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        block_elems = specs[0].block_elems
        for s in specs:
            if s.block_elems != block_elems:
                raise ValueError(
                    "all tenants must share the cache line geometry: "
                    f"{s.name} wants block_elems={s.block_elems}, "
                    f"{specs[0].name} has {block_elems}")
        nt = len(specs)

        # way quotas: explicit quotas are honoured, the rest split equally
        if isolation == "partitioned":
            fixed = sum(s.ways for s in specs if s.ways is not None)
            free = [i for i, s in enumerate(specs) if s.ways is None]
            rest = ways - fixed
            if rest < len(free) or (not free and fixed != ways):
                raise ValueError(
                    f"way quotas don't fit: ways={ways}, explicit={fixed}, "
                    f"{len(free)} tenants left to split the remainder")
            share = {i: rest // len(free) for i in free}
            for i in free[:rest % len(free) if free else 0]:
                share[i] += 1
            lo, windows = 0, []
            for i, s in enumerate(specs):
                q = s.ways if s.ways is not None else share[i]
                if q < 1:
                    raise ValueError(f"tenant {s.name} got a zero way quota")
                windows.append((lo, lo + q))
                lo += q
        else:
            windows = [(0, ways)] * nt

        dev = resolve_device(device)
        ssd = ssd or ArrayOfSSDs(INTEL_OPTANE_P5800X, 1)
        num_queues = round_up(num_queues, ssd.n_devices)
        tenants: Dict[str, BamArray] = {}
        tenant_ids: Dict[str, int] = {}
        storages = []
        for tid, s in enumerate(specs):
            host = np.asarray(s.data)
            if backend == "sim":
                store = SimStorage.from_array(host, block_elems, dev)
                state_store, dtype = None, store.dtype
            elif backend == "hbm":
                state_store = HBMStorage.from_array(host, block_elems, dev)
                store, dtype = None, state_store.dtype
            else:
                raise ValueError(f"unknown backend {backend!r}")
            # integer tenants round-trip through the cache's float dtype:
            # refuse values outside its exact-integer range
            if np.issubdtype(host.dtype, np.integer) \
                    and cache_dtype.is_floating_point:
                exact = 1 << (_mantissa_bits(cache_dtype) + 1)
                peak = int(np.abs(host).max()) if host.size else 0
                if peak > exact:
                    raise ValueError(
                        f"tenant {s.name!r} holds integer values up to "
                        f"{peak}, beyond the exact-integer range "
                        f"(+/-{exact}) of the shared cache dtype "
                        f"{cache_dtype}; pass a wider cache_dtype to "
                        "BamRuntime.build")
            lo, hi = windows[tid]
            tenants[s.name] = BamArray(
                storage=store, shape=tuple(host.shape), dtype=dtype,
                block_elems=block_elems, device=dev, ssd=ssd,
                prefetch_cfg=s.prefetch or PrefetchConfig(),
                tenant_ctx=TenantCtx(tenant=tid, way_lo=lo, way_hi=hi),
                defer_drain=(drain == "deferred"))
            tenant_ids[s.name] = tid
            storages.append(state_store)
        rst = RuntimeState(
            cache=C.make_cache(num_sets, ways, block_elems, cache_dtype, dev),
            queues=Q.make_queues(num_queues, queue_depth,
                                 n_devices=ssd.n_devices,
                                 stripe_blocks=ssd.stripe_blocks,
                                 n_tenants=nt,
                                 tenant_weights=tuple(float(s.weight)
                                                      for s in specs),
                                 failed_devices=ssd.fault.failed_devices,
                                 device=dev),
            metrics=IOMetrics.zeros(ssd.n_devices, dev),
            tenant_metrics=tuple(IOMetrics.zeros(ssd.n_devices, dev)
                                 for _ in specs),
            storages=tuple(storages))
        return BamRuntime(tenants=tenants, tenant_ids=tenant_ids,
                          isolation=isolation, ways=ways,
                          drain_mode=drain), rst

    # ------------------------------------------------------------- plumbing
    def array(self, name: str) -> BamArray:
        """The tenant's :class:`BamArray` (its ``TenantCtx`` rides along),
        for scenario code (``BamGraph``, ``BamKVStore``) together with a
        :meth:`tenant_view`."""
        return self.tenants[name]

    def tenant_view(self, rst: RuntimeState, name: str) -> BamState:
        """The per-tenant :class:`BamState` the array ops consume: the
        shared cache and rings, and a copy of the tenant's metrics (the ops
        update it in place; :meth:`absorb` folds its change back).  Take a
        fresh view for each op."""
        tid = self.tenant_ids[name]
        return BamState(cache=rst.cache, queues=rst.queues,
                        metrics=rst.tenant_metrics[tid].clone(),
                        storage=rst.storages[tid])

    def absorb(self, rst: RuntimeState, name: str,
               st: BamState) -> RuntimeState:
        """Fold a tenant op's :class:`BamState` back into the runtime state,
        in place: the cache and rings replace the shared ones, the tenant's
        metrics replace its own, and their change since the view
        accumulates into the global metrics."""
        tid = self.tenant_ids[name]
        delta = metrics_delta(st.metrics, rst.tenant_metrics[tid])
        tm = list(rst.tenant_metrics)
        tm[tid] = st.metrics
        stores = list(rst.storages)
        stores[tid] = st.storage
        # the global token window is the sum of the tenants' windows, but
        # accumulate only maxes their watermarks: re-check after every fold
        metrics = metrics_accumulate(rst.metrics, delta)
        recheck_token_watermark(metrics)
        rst.cache, rst.queues, rst.metrics = st.cache, st.queues, metrics
        rst.tenant_metrics, rst.storages = tuple(tm), tuple(stores)
        return rst

    # ------------------------------------------------------------------ ops
    def read(self, rst: RuntimeState, name: str, idx: torch.Tensor,
             valid: torch.Tensor | None = None
             ) -> Tuple[torch.Tensor, RuntimeState]:
        vals, st = self.tenants[name].read(self.tenant_view(rst, name),
                                           idx, valid)
        return vals, self.absorb(rst, name, st)

    def write(self, rst: RuntimeState, name: str, idx: torch.Tensor,
              values: torch.Tensor, valid: torch.Tensor | None = None
              ) -> RuntimeState:
        st = self.tenants[name].write(self.tenant_view(rst, name), idx,
                                      values, valid)
        return self.absorb(rst, name, st)

    def submit(self, rst: RuntimeState, name: str, req: IORequest
               ) -> Tuple[RuntimeState, IOToken]:
        """Submit one tenant's op against the shared state; tokens of
        different tenants interleave freely."""
        st, tok = self.tenants[name].submit(self.tenant_view(rst, name), req)
        return self.absorb(rst, name, st), tok

    def wait(self, rst: RuntimeState, name: str, token: IOToken
             ) -> Tuple[RuntimeState, torch.Tensor]:
        """Complete one tenant's token; ``name`` must be the tenant that
        submitted it."""
        st, vals = self.tenants[name].wait(self.tenant_view(rst, name), token)
        return self.absorb(rst, name, st), vals

    def wait_ex(self, rst: RuntimeState, name: str, token: IOToken
                ) -> Tuple[RuntimeState, torch.Tensor, torch.Tensor]:
        """:meth:`wait` with the per-lane error mask; the token's fault
        counters land in the tenant's metrics and, through
        :meth:`absorb`, in the global ones."""
        st, vals, err = self.tenants[name].wait_ex(
            self.tenant_view(rst, name), token)
        return self.absorb(rst, name, st), vals, err

    def prefetch(self, rst: RuntimeState, name: str, idx: torch.Tensor,
                 valid: torch.Tensor | None = None) -> RuntimeState:
        st = self.tenants[name].prefetch(self.tenant_view(rst, name), idx,
                                         valid)
        return self.absorb(rst, name, st)

    def flush(self, rst: RuntimeState,
              name: str | None = None) -> RuntimeState:
        """Flush one tenant's dirty lines, or every tenant's (None)."""
        for n in ([name] if name is not None else list(self.tenants)):
            rst = self.absorb(rst, n, self.tenants[n].flush(
                self.tenant_view(rst, n)))
        return rst

    def drain(self, rst: RuntimeState
              ) -> Tuple[RuntimeState, Q.Completions]:
        """Drain the shared rings once (the deferred mode's round barrier):
        the :class:`~repro_torch.core.queues.Completions` stream is
        priority-major and weighted-fair across tenants, with per-command
        status under the tenants' (shared) fault model.  A no-op on empty
        rings, so callers may drain unconditionally."""
        fault = next(iter(self.tenants.values())).ssd.fault
        rst.queues, comps = Q.service_all(
            rst.queues, fault=fault if fault.enabled else None)
        return rst, comps

    # -------------------------------------------------------------- metrics
    def tenant_summary(self, rst: RuntimeState, name: str) -> dict:
        return rst.tenant_metrics[self.tenant_ids[name]].summary()

    def assert_metrics_consistent(self, rst: RuntimeState,
                                  time_rtol: float = 1e-4) -> None:
        """Per-tenant metrics sum to the global counters: exactly for the
        integer-valued counters, within ``time_rtol`` for the time
        accumulators (the summation order differs)."""
        import numpy as np

        total = metrics_sum(rst.tenant_metrics)
        for f in ADDITIVE_FIELDS:
            a = getattr(total, f).detach().cpu().double().numpy()
            b = getattr(rst.metrics, f).detach().cpu().double().numpy()
            if f.endswith("_time_s"):
                ok = np.allclose(a, b, rtol=time_rtol, atol=1e-12)
            else:
                ok = np.array_equal(a, b)
            if not ok:
                raise AssertionError(
                    f"tenant metrics do not sum to global for {f}: "
                    f"sum(tenants)={a}, global={b}")
