"""Fused cache probe + victim select: the CUDA kernel's wrapper, its plain
version, and its launch count.  Kernel source: ``csrc/probe_allocate.cu``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import probe_allocate_ref

__all__ = ["probe_allocate_cuda", "probe_allocate_ref", "launches"]

launches = _build.LaunchCount("probe_allocate")

MAX_WAYS = 32


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"probe_allocate: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def probe_allocate_cuda(tags, owner, refcount, dirty, speculative,
                        clock_hand, keys, valid, alloc_mask=None,
                        protect_slots=None, *, tenant=0, way_lo=0,
                        way_hi=None, spec_insert=False, protect_hits=True):
    """Launch the fused probe + victim select on CUDA tensors.  Same
    arguments and results as :func:`probe_allocate_ref`."""
    if keys.device.type != "cuda":
        raise ValueError("probe_allocate_cuda needs CUDA tensors")
    dev = keys.device
    num_sets, ways = tags.shape
    way_hi = ways if way_hi is None else way_hi
    if ways > MAX_WAYS:
        raise ValueError(f"probe_allocate: at most {MAX_WAYS} ways")
    m = keys.shape[0]
    d2 = (num_sets, ways)
    _check("tags", tags, torch.int32, d2, dev)
    _check("owner", owner, torch.int32, d2, dev)
    _check("refcount", refcount, torch.int32, d2, dev)
    _check("dirty", dirty, torch.bool, d2, dev)
    _check("speculative", speculative, torch.bool, d2, dev)
    _check("clock_hand", clock_hand, torch.int32, (num_sets,), dev)
    _check("keys", keys, torch.int32, (m,), dev)
    _check("valid", valid, torch.bool, (m,), dev)
    if alloc_mask is not None:
        _check("alloc_mask", alloc_mask, torch.bool, (m,), dev)
    if protect_slots is not None:
        _check("protect_slots", protect_slots, torch.int32,
               (protect_slots.shape[0],), dev)
    keys_eff = torch.where(valid, keys, -1)

    def out(dtype):
        return torch.empty((m,), dtype=dtype, device=dev)

    hit, hslot, way, ok = out(torch.bool), out(torch.int32), \
        out(torch.int32), out(torch.bool)
    evk, evd = out(torch.int32), out(torch.bool)
    # scratch: per-key set and miss flag, the protect overlay, and the
    # per-set bucket counts / offsets / fill cursors / bucket entries
    sets, miss, bucket = out(torch.int32), out(torch.bool), out(torch.int32)
    prot = torch.empty((num_sets * ways,), dtype=torch.uint8, device=dev)
    count, offsets, cursor = (torch.empty((num_sets,), dtype=torch.int32,
                                          device=dev) for _ in range(3))
    p = 0 if protect_slots is None else protect_slots.shape[0]
    status = _build.lib().probe_allocate_launch(
        tags.data_ptr(), owner.data_ptr(), refcount.data_ptr(),
        dirty.data_ptr(), speculative.data_ptr(), clock_hand.data_ptr(),
        keys_eff.data_ptr(),
        alloc_mask.data_ptr() if alloc_mask is not None else None, m,
        protect_slots.data_ptr() if protect_slots is not None else None, p,
        num_sets, ways, int(tenant), int(way_lo), int(way_hi),
        int(bool(spec_insert)), int(bool(protect_hits)),
        hit.data_ptr(), hslot.data_ptr(), way.data_ptr(), ok.data_ptr(),
        evk.data_ptr(), evd.data_ptr(), sets.data_ptr(), miss.data_ptr(),
        prot.data_ptr(), count.data_ptr(), offsets.data_ptr(),
        cursor.data_ptr(), bucket.data_ptr(), _build.stream_ptr(keys))
    _build.check(status, "probe_allocate")
    launches.n += 1
    return hit, hslot, way, ok, evk, evd
