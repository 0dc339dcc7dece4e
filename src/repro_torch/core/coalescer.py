"""Wavefront coalescer: the analogue of BaM's warp coalescing (§III-D).

Port of ``repro.core.coalescer``: a sort-based vectorised ``unique``.  A
stable sort puts each key's lowest original index first (the elected
leader), an inclusive prefix sum over leader flags is BaM's ticket counter,
and an inverse permutation maps every requester to its leader's slot.

``unique_keys`` keeps the reference's ``(n,)`` shape padded with -1; the
caller (``BamArray.submit``) slices it to ``num_unique`` rows.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils import INT32_MAX


@dataclasses.dataclass
class CoalesceResult:
    unique_keys: torch.Tensor   # (n,) int32, first num_unique valid, rest -1
    num_unique: torch.Tensor    # () int32
    inverse_idx: torch.Tensor   # (n,) int32: position -> slot (invalid -> 0)
    leader_mask: torch.Tensor   # (n,) bool: one requester per line


def coalesce(keys: torch.Tensor,
             valid: torch.Tensor | None = None) -> CoalesceResult:
    """Deduplicate a wavefront of int32 block keys (invalid: ``< 0`` or
    ``~valid``)."""
    n = keys.shape[0]
    dev = keys.device
    if n == 0:
        return CoalesceResult(
            unique_keys=torch.full((0,), -1, dtype=torch.int32, device=dev),
            num_unique=torch.zeros((), dtype=torch.int32, device=dev),
            inverse_idx=torch.zeros((0,), dtype=torch.int32, device=dev),
            leader_mask=torch.zeros((0,), dtype=torch.bool, device=dev))
    valid = keys >= 0 if valid is None else valid & (keys >= 0)

    masked = torch.where(valid, keys, INT32_MAX).to(torch.int32)
    sorted_keys, order = torch.sort(masked, stable=True)
    prev = torch.cat([torch.full((1,), -2, dtype=torch.int32, device=dev),
                      sorted_keys[:-1]])
    is_first = (sorted_keys != prev) & (sorted_keys != INT32_MAX)
    slot_sorted = torch.cumsum(is_first, 0, dtype=torch.int32) - 1
    # all-invalid wavefront: slot_sorted[-1] is -1, so num_unique is 0
    num_unique = torch.clamp(slot_sorted[-1] + 1, min=0).to(torch.int32)

    # Dump-row scatter in place of ``.at[].set(mode="drop")``: non-leaders
    # write into row n, which is sliced off.
    dump = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    scatter_pos = torch.where(is_first, slot_sorted, n).to(torch.int64)
    unique_keys = dump.scatter_(
        0, scatter_pos, torch.where(is_first, sorted_keys, -1))[:n]

    inverse = torch.zeros((n,), dtype=torch.int32, device=dev)
    inverse.scatter_(0, order, torch.clamp(slot_sorted, min=0))
    leader_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
    leader_mask.scatter_(0, order, is_first)
    return CoalesceResult(unique_keys=unique_keys, num_unique=num_unique,
                          inverse_idx=inverse, leader_mask=leader_mask)
