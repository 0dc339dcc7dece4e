"""BaM software cache (§III-D): set-associative, clock replacement.

Port of ``repro.core.cache``.  Where the reference rebuilds a ``CacheState`` after every op, the
port updates the state's tensors in place and returns the same object; the
values are the reference's, bit for bit.

Writes that the reference drops for masked rows (``.at[].set(mode="drop")``)
go through :func:`_put_`, which sends masked rows to a spare entry, so no
host sync is needed to select the rows.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops as _ops
from repro_torch.utils import mix_hash, resolve_device, segment_rank

__all__ = [
    "CacheState", "make_cache", "probe", "allocate", "probe_allocate",
    "fill", "count_hits", "acquire", "release", "pin_keys", "mark_dirty",
    "promote", "mark_inflight", "clear_inflight", "write_line",
    "grant_bookkeeping", "fill_complete", "invalidate_failed",
]


@dataclasses.dataclass
class CacheState:
    num_sets: int
    ways: int
    line_elems: int
    tags: torch.Tensor        # (num_sets, ways) int32 block key, -1 invalid
    owner: torch.Tensor       # (num_sets, ways) int32 tenant id of the line
    refcount: torch.Tensor    # (num_sets, ways) int32, pinned lines > 0
    dirty: torch.Tensor       # (num_sets, ways) bool
    speculative: torch.Tensor  # (num_sets, ways) bool
    inflight: torch.Tensor    # (num_sets, ways) bool, tag claimed, fill pending
    clock_hand: torch.Tensor  # (num_sets,) int32 in [0, ways)
    data: torch.Tensor        # (num_sets*ways, line_elems)
    hits: torch.Tensor        # () int32
    misses: torch.Tensor      # () int32
    bypasses: torch.Tensor    # () int32

    @property
    def num_lines(self) -> int:
        return self.num_sets * self.ways


def make_cache(num_sets: int, ways: int, line_elems: int,
               dtype=torch.float32, device=None) -> CacheState:
    """An empty directory and line store on ``device`` (CUDA unless the
    caller asks for another)."""
    device = resolve_device(device)
    def d2(fill, dt):
        return torch.full((num_sets, ways), fill, dtype=dt, device=device)

    def z():
        return torch.zeros((), dtype=torch.int32, device=device)

    return CacheState(
        num_sets=num_sets, ways=ways, line_elems=line_elems,
        tags=d2(-1, torch.int32), owner=d2(0, torch.int32),
        refcount=d2(0, torch.int32), dirty=d2(False, torch.bool),
        speculative=d2(False, torch.bool), inflight=d2(False, torch.bool),
        clock_hand=torch.zeros((num_sets,), dtype=torch.int32, device=device),
        data=torch.zeros((num_sets * ways, line_elems), dtype=dtype,
                         device=device),
        hits=z(), misses=z(), bypasses=z())


def _put_(flat: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor,
          vals) -> None:
    """In place ``flat[idx[ok]] = vals[ok]`` with no host sync: rows with
    ``ok=False`` write a spare entry of a one-longer copy, which is cut off.
    Meant for directory-sized arrays; the ``ok`` indices are distinct or
    write equal values, so the result does not depend on write order."""
    n = flat.shape[0]
    ext = torch.cat([flat, flat.new_zeros(1)])
    vals = torch.as_tensor(vals, dtype=flat.dtype, device=flat.device)
    ext.index_put_((torch.where(ok, idx.to(torch.int64), n),),
                   vals.expand(idx.shape))
    flat.copy_(ext[:n])


@dataclasses.dataclass
class ProbeResult:
    hit: torch.Tensor          # (m,) bool
    slot: torch.Tensor         # (m,) int32 flat slot, -1 on miss
    set_idx: torch.Tensor      # (m,) int32
    speculative: torch.Tensor  # (m,) bool, hit on a prefetched line
    inflight: torch.Tensor     # (m,) bool, hit on a not-yet-filled line


@dataclasses.dataclass
class AllocResult:
    slot: torch.Tensor           # (m,) int32 granted slot, -1 if none
    ok: torch.Tensor             # (m,) bool
    evicted_key: torch.Tensor    # (m,) int32, -1 none
    evicted_dirty: torch.Tensor  # (m,) bool


def _set_of(cache: CacheState, keys: torch.Tensor) -> torch.Tensor:
    return (mix_hash(keys) % cache.num_sets).to(torch.int32)


def probe(cache: CacheState, keys: torch.Tensor,
          valid: torch.Tensor | None = None, tenant: int = 0) -> ProbeResult:
    """Set-associative lookup of a wavefront of unique keys, through the
    ``cache_probe`` kernel on CUDA tensors."""
    if valid is None:
        valid = keys >= 0
    sets = _set_of(cache, keys)
    hit, slot = _ops.cache_probe(cache.tags, torch.where(valid, keys, -1),
                                 owner=cache.owner, tenant=tenant)
    safe = torch.where(hit, slot, 0).to(torch.int64)
    return ProbeResult(
        hit=hit, slot=slot, set_idx=sets,
        speculative=hit & cache.speculative.view(-1)[safe],
        inflight=hit & cache.inflight.view(-1)[safe])


def _apply_grants(cache: CacheState, keys, sets, way, ok, n_valid,
                  speculative: bool, tenant: int) -> None:
    """Commit a wavefront of victim grants in place: claim tags and flags,
    advance each touched set's clock hand past the granted way, bump the
    miss/bypass counters.  Granted (set, way) pairs are distinct."""
    ways = cache.ways
    flat_idx = sets.to(torch.int64) * ways + torch.where(ok, way, 0)
    _put_(cache.tags.view(-1), flat_idx, ok, keys)
    _put_(cache.owner.view(-1), flat_idx, ok, tenant)
    _put_(cache.dirty.view(-1), flat_idx, ok, False)
    _put_(cache.speculative.view(-1), flat_idx, ok, speculative)
    _put_(cache.inflight.view(-1), flat_idx, ok, False)
    hand = cache.clock_hand[sets.to(torch.int64)]
    clock_pos = torch.remainder(way - hand, ways)
    adv = torch.zeros((cache.num_sets,), dtype=torch.int32,
                      device=keys.device)
    adv.scatter_reduce_(0, torch.where(ok, sets, 0).to(torch.int64),
                        torch.where(ok, clock_pos + 1, 0).to(torch.int32),
                        reduce="amax")
    cache.clock_hand.copy_(torch.remainder(cache.clock_hand + adv, ways))
    if not speculative:   # speculative fills are not demand traffic
        n_ok = ok.sum(dtype=torch.int32)
        cache.misses += n_valid
        cache.bypasses += n_valid - n_ok


def _way_window(ways: int, way_lo: int, way_hi: int | None) -> int:
    way_hi = ways if way_hi is None else way_hi
    if not (0 <= way_lo < way_hi <= ways):
        raise ValueError(
            f"way window [{way_lo}, {way_hi}) invalid for ways={ways}")
    return way_hi


def allocate(cache: CacheState, keys: torch.Tensor, valid: torch.Tensor,
             protect_slots: torch.Tensor | None = None,
             speculative: bool = False, tenant: int = 0, way_lo: int = 0,
             way_hi: int | None = None):
    """Grant a victim slot per missed key, in place: the two-step path's
    clock sweep, rank-disambiguated within each set (plain PyTorch, as in
    the reference).  Eligible ways are unpinned, not another tenant's
    dirty line, inside ``[way_lo, way_hi)``, not a pending speculative
    line under ``speculative`` and not in ``protect_slots``; they are
    swept by class (invalid, speculative, resident) and then clock order
    from the hand.  Returns ``(cache, AllocResult)``."""
    m = keys.shape[0]
    ways = cache.ways
    way_hi = _way_window(ways, way_lo, way_hi)
    dev = keys.device
    sets = _set_of(cache, keys)
    sets64 = sets.to(torch.int64)
    elig = (cache.refcount == 0) & ~((cache.owner != tenant)
                                     & (cache.tags >= 0) & cache.dirty)
    if way_lo != 0 or way_hi != ways:
        w = torch.arange(ways, device=dev)
        elig = elig & ((w >= way_lo) & (w < way_hi))[None, :]
    if speculative:
        elig = elig & ~(cache.speculative & (cache.tags >= 0))
    if protect_slots is not None:
        overlay = torch.zeros((cache.num_lines,), dtype=torch.bool,
                              device=dev)
        _put_(overlay, protect_slots, protect_slots >= 0, True)
        elig = elig & ~overlay.view(cache.num_sets, ways)

    rank = segment_rank(sets, valid)
    hand = cache.clock_hand[sets64]
    way_order = torch.remainder(
        hand[:, None] + torch.arange(ways, dtype=torch.int32,
                                     device=dev)[None, :], ways).to(
        torch.int64)
    vclass = torch.where(cache.tags < 0, 0,
                         torch.where(cache.speculative, 1, 2))
    pref = torch.sort(vclass[sets64[:, None], way_order], dim=1,
                      stable=True).indices
    way_order = torch.gather(way_order, 1, pref)
    elig_rot = elig[sets64[:, None], way_order]
    csum = torch.cumsum(elig_rot.to(torch.int32), 1, dtype=torch.int32)
    sel = elig_rot & (csum == (rank + 1)[:, None])
    ok = valid & (csum[:, -1] >= rank + 1) if m else valid
    way_pos = torch.argmax(sel.to(torch.int32), dim=1) if m \
        else torch.zeros((0,), dtype=torch.int64, device=dev)
    way = torch.gather(way_order, 1, way_pos[:, None])[:, 0].to(torch.int32)
    slot = (sets * ways + way).to(torch.int32)
    evicted_key = torch.where(ok, cache.tags[sets64, way.to(torch.int64)],
                              -1).to(torch.int32)
    evicted_dirty = ok & cache.dirty[sets64, way.to(torch.int64)]
    _apply_grants(cache, keys, sets, way, ok, valid.sum(dtype=torch.int32),
                  speculative, tenant)
    return cache, AllocResult(slot=torch.where(ok, slot, -1), ok=ok,
                              evicted_key=evicted_key,
                              evicted_dirty=evicted_dirty)


def probe_allocate(cache: CacheState, keys: torch.Tensor,
                   valid: torch.Tensor | None = None, *,
                   alloc_mask: torch.Tensor | None = None,
                   protect_slots: torch.Tensor | None = None,
                   protect_hits: bool = True, speculative: bool = False,
                   tenant: int = 0, way_lo: int = 0,
                   way_hi: int | None = None):
    """Fused probe + victim allocate, the submission hot path: one
    ``probe_allocate`` kernel pass on CUDA tensors, then the grant commit.
    Returns ``(cache, ProbeResult, AllocResult)``; ``cache`` is the same
    object, updated in place."""
    ways = cache.ways
    way_hi = _way_window(ways, way_lo, way_hi)
    if valid is None:
        valid = keys >= 0
    sets = _set_of(cache, keys)
    hit, hslot, way, ok, evicted_key, evicted_dirty = _ops.probe_allocate(
        cache.tags, cache.owner, cache.refcount, cache.dirty,
        cache.speculative, cache.clock_hand, keys, valid=valid,
        alloc_mask=alloc_mask, protect_slots=protect_slots, tenant=tenant,
        way_lo=way_lo, way_hi=way_hi, spec_insert=speculative,
        protect_hits=protect_hits)
    safe = torch.where(hit, hslot, 0).to(torch.int64)
    pr = ProbeResult(
        hit=hit, slot=hslot, set_idx=sets,
        speculative=hit & cache.speculative.view(-1)[safe],
        inflight=hit & cache.inflight.view(-1)[safe])
    slot = (sets * ways + torch.where(ok, way, 0)).to(torch.int32)
    miss = valid & ~hit
    if alloc_mask is not None:
        miss = miss & alloc_mask
    _apply_grants(cache, keys, sets, way, ok, miss.sum(dtype=torch.int32),
                  speculative, tenant)
    return cache, pr, AllocResult(
        slot=torch.where(ok, slot, -1), ok=ok,
        evicted_key=evicted_key, evicted_dirty=evicted_dirty)


def fill(cache: CacheState, slots: torch.Tensor, ok: torch.Tensor,
         lines: torch.Tensor) -> CacheState:
    """Scatter fetched lines into their slots, in place.  The rows are
    selected on the host (a device sync); an empty selection skips the
    scatter, as the reference's ``lax.cond`` does."""
    sel = torch.nonzero(ok).squeeze(1)
    if sel.numel() > 0:
        cache.data.index_copy_(0, slots[sel].to(torch.int64),
                               lines[sel].to(cache.data.dtype))
    return cache


def count_hits(cache: CacheState, n_hits: torch.Tensor) -> CacheState:
    cache.hits += n_hits
    return cache


def acquire(cache: CacheState, slots: torch.Tensor) -> CacheState:
    """refcount++ on the given flat slots (slot < 0 ignored)."""
    ok = slots >= 0
    cache.refcount.view(-1).index_add_(
        0, torch.where(ok, slots, 0).to(torch.int64), ok.to(torch.int32))
    return cache


def release(cache: CacheState, slots: torch.Tensor) -> CacheState:
    ok = slots >= 0
    cache.refcount.view(-1).index_add_(
        0, torch.where(ok, slots, 0).to(torch.int64), -ok.to(torch.int32))
    cache.refcount.clamp_(min=0)
    return cache


def pin_keys(cache: CacheState, keys: torch.Tensor,
             tenant: int = 0) -> CacheState:
    """Pin the resident lines of ``keys`` (user-directed residency
    control), through the ``cache_probe`` kernel on CUDA tensors."""
    return acquire(cache, probe(cache, keys, tenant=tenant).slot)


def _set_flag(flag: torch.Tensor, slots: torch.Tensor, value: bool) -> None:
    _put_(flag.view(-1), slots, slots >= 0, value)


def promote(cache: CacheState, slots: torch.Tensor) -> CacheState:
    """Clear the speculative bit on the given flat slots."""
    _set_flag(cache.speculative, slots, False)
    return cache


def mark_inflight(cache: CacheState, slots: torch.Tensor) -> CacheState:
    _set_flag(cache.inflight, slots, True)
    return cache


def clear_inflight(cache: CacheState, slots: torch.Tensor) -> CacheState:
    _set_flag(cache.inflight, slots, False)
    return cache


def mark_dirty(cache: CacheState, slots: torch.Tensor) -> CacheState:
    _set_flag(cache.dirty, slots, True)
    return cache


def write_line(cache: CacheState, slots: torch.Tensor, ok: torch.Tensor,
               lines: torch.Tensor) -> CacheState:
    """Overwrite resident lines and mark them dirty (the write-hit path)."""
    fill(cache, slots, ok, lines)
    return mark_dirty(cache, torch.where(ok, slots, -1))


def grant_bookkeeping(cache: CacheState, n_hits: torch.Tensor,
                      promote_slots: torch.Tensor, pin_slots: torch.Tensor,
                      inflight_slots: torch.Tensor) -> CacheState:
    """Submission-side bookkeeping: hit count, promote, pin and in-flight
    mark.  The four steps touch disjoint fields."""
    cache.hits += n_hits
    promote(cache, promote_slots)
    mark_inflight(cache, inflight_slots)
    return acquire(cache, pin_slots)


def fill_complete(cache: CacheState, slots: torch.Tensor,
                  pend: torch.Tensor, lines: torch.Tensor,
                  ok: torch.Tensor | None = None) -> CacheState:
    """Completion, in place: fill the ``pend`` slots with ``lines`` and
    clear their in-flight bit.  Under the fault model ``ok`` is each row's
    command status: a ``pend & ~ok`` slot is not filled but
    :func:`invalidate_failed`.  The rows are selected on the host; a wait
    with nothing pending skips it all."""
    sel = torch.nonzero(pend).squeeze(1)
    if sel.numel() == 0:
        return cache
    good = sel if ok is None else sel[ok[sel]]
    if good.numel() > 0:
        cache.data.index_copy_(0, slots[good].to(torch.int64),
                               lines[good].to(cache.data.dtype))
    cache.inflight.view(-1)[slots[sel].to(torch.int64)] = False
    if ok is not None:
        invalidate_failed(cache, slots, pend & ~ok)
    return cache


def invalidate_failed(cache: CacheState, slots: torch.Tensor,
                      mask: torch.Tensor) -> CacheState:
    """Free the granted, never-filled lines whose fetch errored past its
    retry budget, in place: tag -1, in-flight, speculative and dirty bits
    cleared, the data left as it is (a line is never filled from a failed
    fetch).  Pins stay with their ``release``."""
    live = mask & (slots >= 0)
    # bamlint: ignore[BAM104] -- a host loop over four directory fields
    for flag, value in ((cache.tags, -1), (cache.inflight, False),
                        (cache.speculative, False), (cache.dirty, False)):
        _put_(flag.view(-1), slots, live, value)
    return cache
