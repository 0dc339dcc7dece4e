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
    if t.dtype is not dtype or t.shape != shape or t.device != device \
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
    p = 0 if protect_slots is None else protect_slots.shape[0]
    lib = _build.lib()
    # one buffer: hit_slot, way and evicted key as int32, then hit, ok and
    # evicted dirty as one byte each, then the kernel's scratch (16-byte
    # aligned; the kernel resets what it needs itself)
    off = -(-15 * m // 16) * 16
    words = lib.probe_allocate_scratch_words(m, num_sets, ways)
    buf = torch.empty((off + 4 * words,), dtype=torch.uint8, device=dev)
    base = buf.data_ptr()
    status = lib.probe_allocate_launch(
        tags.data_ptr(), owner.data_ptr(), refcount.data_ptr(),
        dirty.data_ptr(), speculative.data_ptr(), clock_hand.data_ptr(),
        keys.data_ptr(), valid.data_ptr(),
        alloc_mask.data_ptr() if alloc_mask is not None else None,
        protect_slots.data_ptr() if protect_slots is not None else None, p,
        m, num_sets, ways, int(tenant), int(way_lo), int(way_hi),
        int(bool(spec_insert)), int(bool(protect_hits)), base, base + off,
        words, _build.stream_ptr(keys))
    _build.check(status, "probe_allocate")
    launches.n += 1
    hslot, way, evk, hit, ok, evd, _ = buf.split_with_sizes(
        [4 * m] * 3 + [m] * 3 + [buf.numel() - 15 * m])
    return (hit.view(torch.bool), hslot.view(torch.int32),
            way.view(torch.int32), ok.view(torch.bool),
            evk.view(torch.int32), evd.view(torch.bool))
