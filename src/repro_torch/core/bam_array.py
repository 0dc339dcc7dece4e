"""``BamArray``: BaM's array abstraction (§III-E), single tenant, fused path.

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

Differences from the reference, none of which changes a value:

* state is updated in place (the returned state is the one passed in);
* ``lax.cond`` fast paths are host-side branches on a synced bool;
* after coalescing, ``unique_keys`` is cut to ``num_unique`` rows (one host
  read per submit) and every per-line buffer is sized by that count, where
  the reference sizes them by the wavefront width.  The -1 padding rows are
  inert, so cache, rings and metrics are identical; at BFS/CC wavefronts of
  2^28 lanes the reference's fetch buffer would not fit in device memory.

Not ported yet: ``fused_rounds=False`` (``NotImplementedError``), the
deferred drain and multi-tenant sharing (``BamRuntime``), the bucketed ops
and the ``*_jit`` family.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core import cache as C
from repro_torch.core import queues as Q
from repro_torch.core.coalescer import coalesce
from repro_torch.core.metrics import IOMetrics, recheck_token_watermark
from repro_torch.core.prefetch import PrefetchConfig, readahead_keys
from repro_torch.core.ssd import (ArrayOfSSDs, INTEL_OPTANE_P5800X,
                                  device_histogram, device_of_block)
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
    row per unique line (``num_unique`` rows, at least one).  The
    reference's per-token command histograms serve its deferred drain,
    which belongs to ``BamRuntime`` and is not ported yet."""

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
        if not fused_rounds:
            raise NotImplementedError("the legacy fused_rounds=False path is "
                                      "not ported")
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
                       prefetch_cfg=prefetch or PrefetchConfig())
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
                protect_hits=False, speculative=True)
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
        uvalid = ukeys >= 0
        cache, pr, alloc = C.probe_allocate(st.cache, ukeys, uvalid,
                                            speculative=True)
        n_cross = pr.inflight.sum(dtype=torch.int32)
        wb = alloc.ok & alloc.evicted_dirty & (alloc.evicted_key >= 0)
        wb_keys = torch.where(wb, alloc.evicted_key, -1)
        keys = torch.where(alloc.ok, ukeys, -1)
        C.mark_inflight(cache, torch.where(alloc.ok, alloc.slot, -1))
        qs, (rec_w, rec_r) = Q.enqueue_segments(st.queues, [
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
                inverse.to(torch.int64)])
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
        is all False."""
        _mark_redeemed(token)
        self._check_channels(st)
        dev = self.device
        fault = self.ssd.fault
        if token.ukeys.shape[0] == 0:
            return (st, torch.zeros((0,), dtype=self.dtype, device=dev),
                    torch.zeros((0,), dtype=torch.bool, device=dev))
        ukeys = token.ukeys
        uvalid = ukeys >= 0
        valid = token.valid
        off = token.off
        charge_qs = (st.queues.group_size, st.queues.depth)

        # 1) drain the rings with closed-form accounting, in place
        qs, dr = Q.drain_accounting(st.queues,
                                    fault=fault if fault.enabled else None)
        reads_charge = dr.reads_dev + token.drop_dev_reads
        writes_charge = dr.writes_dev + token.drop_dev_writes

        # 2) fresh probe through the cache_probe kernel, and this token's
        #    command fates from their (device, ticket) stamps
        pr2 = C.probe(st.cache, ukeys, uvalid)
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
        C.fill_complete(cache, pr2.slot, pend, lines, ok_u)
        n_fetch = need.sum(dtype=torch.int32)

        # 3b) the readahead lines this token's submit claimed; a failed
        #     speculative fetch is invalidated and errors no lane
        if token.ra_keys is not None:
            ra = token.ra_keys
            ra_pr = C.probe(cache, ra, ra >= 0)
            ra_pend = ra_pr.hit & ra_pr.inflight
            ra_need = ra_pend
            ra_ok = None
            if fault.enabled:
                ra_ok = self._status(ra, token.ra_ticket)
                ra_need = ra_pend & ((ra < 0) | ra_ok)
            lines_ra = self._fetch_gated(store, torch.where(ra_need, ra, -1),
                                         ra_need)
            C.fill_complete(cache, ra_pr.slot, ra_pend, lines_ra, ra_ok)
            n_fetch = n_fetch + ra_need.sum(dtype=torch.int32)

        # 4) op-specific completion
        u = token.inverse.to(torch.int64)
        zero = torch.zeros((), dtype=self.dtype, device=dev)
        err = valid & failed_u[u] if failed_u is not None \
            else torch.zeros(valid.shape, dtype=torch.bool, device=dev)
        hit_u = pr2.hit[u]
        slot_u = torch.where(hit_u, pr2.slot[u], -1)
        if token.kind == "read":
            hit_vals = K.gather_blocks(cache.data, slot_u, off=off)
            miss_vals = lines.view(-1)[u * self.block_elems + off]
            vals = torch.where(hit_u, hit_vals, miss_vals)
            vals = torch.where(valid & ~err, vals, zero)
        elif token.kind == "write":
            values = token.values.to(self.dtype)
            wr = valid & ~err
            # scatter the new element values into resident lines...
            in_cache = wr & (slot_u >= 0)
            sel = torch.nonzero(in_cache).squeeze(1)
            if sel.numel() > 0:  # bamlint: ignore[BAM104] -- host branch
                cache.data[slot_u[sel].to(torch.int64),
                           off[sel].to(torch.int64)] = values[sel]
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
        if fault.enabled:
            self._charge_faults(mt, dr)
            mt.degraded_reads += err.sum(dtype=torch.int32)
        self._charge_wait(mt, charge_qs, reads_charge, writes_charge, dr)
        return st, vals, err

    @staticmethod
    def _charge_faults(mt: IOMetrics, dr: Q.DrainReceipt) -> None:
        """The drain's fault counters, in place."""
        n_err = dr.err_reads_dev + dr.err_writes_dev
        mt.transient_errors += dr.transient_errors
        mt.retries += (dr.retry_reads_dev + dr.retry_writes_dev).sum(
            dtype=torch.int32)
        mt.failed_commands += n_err.sum(dtype=torch.int32)
        mt.dev_errors += n_err

    def _charge_wait(self, mt: IOMetrics, qs_geom, reads_hist: torch.Tensor,
                     writes_hist: torch.Tensor,
                     dr: Q.DrainReceipt) -> None:
        """Device-time charge for a drain, in place: each channel retires
        its share at its own Little's-law rate, the straggler gates the
        batch.  Where the drain's receipt ``dr`` carries fault fields,
        every re-issue costs ``tail_latency_mult`` commands of service time
        on its device, and the data counters count only the commands that
        completed.  The charge is float32 (as in the reference),
        accumulated in float64."""
        group_size, depth = qs_geom
        limit = group_size * depth
        t_reads, t_writes = reads_hist, writes_hist
        ok_reads, ok_writes = reads_hist, writes_hist
        if dr.retry_reads_dev is not None:
            mult = self.ssd.fault.tail_latency_mult
            t_reads = reads_hist + mult * dr.retry_reads_dev
            t_writes = writes_hist + mult * dr.retry_writes_dev
            ok_reads = reads_hist - dr.err_reads_dev
            ok_writes = writes_hist - dr.err_writes_dev
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
        """Write back every dirty resident line through the SQ rings:
        enqueue, doorbell, drain.  Under the fault model an errored flush
        command costs its attempts in the counters, but the line is
        persisted all the same."""
        self._check_channels(st)
        fault = self.ssd.fault
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
        qs, dr = Q.drain_accounting(qs,
                                    fault=fault if fault.enabled else None)
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
        if fault.enabled:
            self._charge_faults(mt, dr)
        self._charge_wait(mt, charge_qs, reads_charge, writes_charge, dr)
        recheck_token_watermark(mt)
        return st
