"""Cache tag probe: the CUDA kernel's wrapper, its plain version, and its
launch count.  Kernel source: ``csrc/cache_probe.cu``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import cache_probe_ref

__all__ = ["cache_probe_cuda", "cache_probe_ref", "launches"]

launches = _build.LaunchCount("cache_probe")


def _check(name, t, dtype, ndim, device):
    if t.device != device:
        raise ValueError(f"cache_probe: {name} on {t.device}, expected {device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"cache_probe: {name} must be a contiguous {ndim}-d "
                         f"{dtype} tensor, got {t.dtype} {tuple(t.shape)}")


def cache_probe_cuda(tags: torch.Tensor, keys: torch.Tensor,
                     owner: torch.Tensor | None = None, tenant: int = 0):
    """Launch the probe kernel on CUDA tensors: ``(hit bool, slot int32)``."""
    if keys.device.type != "cuda":
        raise ValueError("cache_probe_cuda needs CUDA tensors")
    dev = keys.device
    _check("tags", tags, torch.int32, 2, dev)
    _check("keys", keys, torch.int32, 1, dev)
    if owner is not None:
        _check("owner", owner, torch.int32, 2, dev)
        if owner.shape != tags.shape:
            raise ValueError("cache_probe: owner and tags shapes differ")
    num_sets, ways = tags.shape
    m = keys.shape[0]
    hit = torch.empty((m,), dtype=torch.bool, device=dev)
    slot = torch.empty((m,), dtype=torch.int32, device=dev)
    status = _build.lib().cache_probe_launch(
        tags.data_ptr(), owner.data_ptr() if owner is not None else None,
        keys.data_ptr(), m, num_sets, ways, int(tenant), hit.data_ptr(),
        slot.data_ptr(), _build.stream_ptr(keys))
    _build.check(status, "cache_probe")
    launches.n += 1
    return hit, slot
