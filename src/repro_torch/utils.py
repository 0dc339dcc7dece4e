"""Small shared utilities: device resolution, hashing, segment ranks.

Own copies of ``repro.utils``'s helpers: the port never imports ``repro``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

INT32_MAX = 2 ** 31 - 1


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller asks
    for another.  Raises when CUDA is asked for and absent, so a missing
    card never turns silently into a CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev


def mix_hash(key: torch.Tensor) -> torch.Tensor:
    """Knuth multiplicative hash for cache set selection, bit-identical to
    the uint32 arithmetic of ``repro.utils.mix_hash``.

    Torch has no uint32 multiply, so the product is taken in int64 and
    masked to 32 bits (the operands are < 2^32, so the int64 product of the
    masked key and the constant never overflows 2^63).
    """
    k = key.to(torch.int64) & 0xFFFFFFFF
    k = (k * 2654435761) & 0xFFFFFFFF
    k = k ^ (k >> 16)
    return (k & 0x7FFFFFFF).to(torch.int32)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def segment_rank(ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Rank of each element among same-id elements (0-based), in index
    order: a stable sort plus a cumulative max of run starts.  Invalid
    elements share one sentinel id and are ranked among themselves, as in
    the reference."""
    m = ids.shape[0]
    keyed = torch.where(valid, ids.to(torch.int32),
                        torch.full_like(ids, INT32_MAX, dtype=torch.int32))
    ss, order = torch.sort(keyed, stable=True)
    prev = torch.cat([torch.full((1,), -2, dtype=ss.dtype, device=ss.device),
                      ss[:-1]])
    start = ss != prev
    pos = torch.arange(m, dtype=torch.int32, device=ids.device)
    start_pos = torch.cummax(torch.where(start, pos, 0), dim=0).values
    rank_sorted = (pos - start_pos).to(torch.int32)
    out = torch.zeros((m,), dtype=torch.int32, device=ids.device)
    return out.scatter_(0, order, rank_sorted)


@dataclasses.dataclass
class Tagged:
    """A value tagged with a kind string (decode-cache entries: ``"paged"``
    for a BaM-paged pool).  The reference's pytree of the same name."""

    kind: str
    value: Any
