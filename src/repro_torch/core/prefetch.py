"""Readahead for the BaM cache: the stride detector and its configuration.

Port of ``repro.core.prefetch``.  ``modal_stride`` finds the most common
gap between a wavefront's sorted unique block keys (sort, run-length,
argmax); ``readahead_keys`` extrapolates it ``window`` lines past the
wavefront, down from its smallest key when the raw wavefront runs
descending, clamped to the array.  ``BamArray.submit`` claims the
predicted lines as speculative, in-flight residents and enqueues them in
the low-priority lane; the token's wait fills them.

Differences in how, not in what: the run-length counts are
``scatter_add_`` and ``scatter_reduce_(amin)`` on int32 (deterministic), a
reversed lane order is ``flip``, and ``argmax`` runs on int32 (CUDA has no
``argmax`` of a bool tensor); ties go to the first index, as in
``jnp.argmax``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.utils import INT32_MAX

__all__ = ["PrefetchConfig", "modal_stride", "readahead_keys"]


@dataclasses.dataclass(frozen=True)
class PrefetchConfig:
    """Static readahead knobs (see ``repro.core.prefetch``): ``enabled``,
    ``window`` lines of readahead a wavefront, the ``min_support`` share of
    key gaps that must agree on the stride, and the ``max_stride`` in
    blocks that readahead follows."""

    enabled: bool = False
    window: int = 8
    min_support: float = 0.75
    max_stride: int = 64

    def __post_init__(self):
        if self.window < 0:
            raise ValueError("window must be >= 0")
        if not (0.0 < self.min_support <= 1.0):
            raise ValueError("min_support must be in (0, 1]")


def modal_stride(keys: torch.Tensor, valid: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(stride, support, n_deltas)`` int32 scalars of a wavefront of
    unique block keys: the most common gap between consecutive sorted valid
    keys, how many gaps equal it, and how many gaps there were (all zero
    with fewer than two keys)."""
    n = keys.shape[0]
    zero = torch.zeros((), dtype=torch.int32, device=keys.device)
    if n < 2:
        return zero, zero, zero
    big = INT32_MAX
    skeys = torch.sort(torch.where(valid, keys, big).to(torch.int32)).values
    d = skeys[1:] - skeys[:-1]
    dvalid = (skeys[1:] != big) & (skeys[:-1] != big)
    ds = torch.sort(torch.where(dvalid, d, big)).values

    # run-length encode the sorted gaps; the longest run is the mode
    is_first = torch.ones_like(dvalid)
    is_first[1:] = ds[1:] != ds[:-1]
    run_id = (torch.cumsum(is_first, 0, dtype=torch.int32) - 1).to(
        torch.int64)
    m = ds.shape[0]
    counts = torch.zeros((m,), dtype=torch.int32, device=keys.device)
    counts.scatter_add_(0, run_id, (ds != big).to(torch.int32))
    run_val = torch.full((m,), big, dtype=torch.int32, device=keys.device)
    run_val.scatter_reduce_(0, run_id, ds, reduce="amin")
    counts = torch.where(run_val == big, 0, counts)
    best = torch.argmax(counts)
    n_deltas = dvalid.sum(dtype=torch.int32)
    stride = torch.where(n_deltas > 0, run_val[best], 0).to(torch.int32)
    return stride, counts[best].to(torch.int32), n_deltas


def readahead_keys(keys: torch.Tensor, valid: torch.Tensor, *,
                   window: int, num_blocks: int,
                   min_support: float = 0.75, max_stride: int = 64,
                   raw_keys: torch.Tensor | None = None,
                   raw_valid: torch.Tensor | None = None) -> torch.Tensor:
    """The next ``window`` block keys of the wavefront's pattern, ``(window,)``
    int32: ``stride * (1..window)`` past the wavefront's extreme key when the
    modal stride clears ``min_support``, -1 for candidates outside
    ``[0, num_blocks)``.  ``raw_keys``/``raw_valid`` (the pre-coalesce block
    keys) give the direction: when the last valid raw key is below the
    first, the pattern runs down from the smallest key."""
    dev = keys.device
    if window == 0:
        return torch.full((0,), -1, dtype=torch.int32, device=dev)
    stride, support, n_deltas = modal_stride(keys, valid)
    need = torch.clamp(torch.ceil(min_support * n_deltas.to(torch.float32))
                       .to(torch.int32), min=1)
    confident = (n_deltas > 0) & (support >= need) \
        & (stride > 0) & (stride <= max_stride)
    descending = torch.zeros((), dtype=torch.bool, device=dev)
    if raw_keys is not None:
        rv = raw_valid if raw_valid is not None else raw_keys >= 0
        rvi = rv.to(torch.int32)
        first = torch.argmax(rvi)
        last = raw_keys.shape[0] - 1 - torch.argmax(torch.flip(rvi, (0,)))
        descending = rv.any() & (raw_keys[last] < raw_keys[first])
    base = torch.where(descending,
                       torch.where(valid, keys, INT32_MAX).min(),
                       torch.where(valid, keys, -1).max()).to(torch.int32)
    step = torch.where(descending, -stride, stride)
    steps = torch.arange(1, window + 1, dtype=torch.int32, device=dev)
    cand = base + step * steps
    ok = confident & (base >= 0) & (base < num_blocks) \
        & (cand >= 0) & (cand < num_blocks)
    return torch.where(ok, cand, -1).to(torch.int32)
