"""Carry BaM state across packages as numpy: a ``BamState`` as a flat dict
of arrays, keyed ``"cache.<field>"``, ``"queues.<field>"`` and
``"metrics.<field>"``.

:func:`state_from_numpy` builds the port's ``BamState`` on a device from
such a dict (for example one made from the JAX package's state, which has
the same field names), so a run can resume where another left off;
:func:`state_to_numpy` goes back.  Float counters become float64 and the
rest keep their dtypes (int32, bool, and the cache line dtype).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.bam_array import BamState
from repro_torch.core.cache import CacheState
from repro_torch.core.metrics import IOMetrics
from repro_torch.core.queues import QueueState

_STATIC = {
    "cache": ("num_sets", "ways", "line_elems"),
    "queues": ("num_queues", "depth", "n_devices", "stripe_blocks",
               "n_tenants"),
}


def _tensor_fields(cls, group):
    return [f.name for f in dataclasses.fields(cls)
            if f.name not in _STATIC.get(group, ())]


def _to_torch(a, device, widen: bool = False) -> torch.Tensor:
    """A device tensor from a numpy array; ``widen`` turns float32 into
    float64 (the metric counters)."""
    a = np.array(a, order="C")       # a copy; keeps 0-d arrays 0-d
    if a.dtype.name == "bfloat16":   # numpy has no bf16: move the bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    if widen and a.dtype == np.float32:
        a = a.astype(np.float64)
    return torch.from_numpy(a).to(device)


def state_from_numpy(d: dict, device="cpu", *, stripe_blocks: int = 1
                     ) -> BamState:
    """A port ``BamState`` on ``device`` from a dict of numpy arrays.

    Static sizes come from the arrays' shapes.  Float32 metric counters
    are widened to float64; cache line data keeps its dtype."""
    def group(prefix, cls):
        return {f: d[f"{prefix}.{f}"] for f in _tensor_fields(cls, prefix)}

    c = group("cache", CacheState)
    tags = np.asarray(c["tags"])
    cache = CacheState(
        num_sets=tags.shape[0], ways=tags.shape[1],
        line_elems=np.asarray(c["data"]).shape[1],
        **{k: _to_torch(v, device) for k, v in c.items()})
    q = group("queues", QueueState)
    sq_key = np.asarray(q["sq_key"])
    queues = QueueState(
        num_queues=sq_key.shape[0], depth=sq_key.shape[1],
        n_devices=np.asarray(q["rr_ptr"]).shape[0],
        stripe_blocks=stripe_blocks,
        n_tenants=np.asarray(q["tenant_enqueued"]).shape[0],
        **{k: _to_torch(v, device) for k, v in q.items()})
    m = group("metrics", IOMetrics)
    metrics = IOMetrics(**{k: _to_torch(v, device, widen=True)
                           for k, v in m.items()})
    return BamState(cache=cache, queues=queues, metrics=metrics)


def state_to_numpy(st: BamState) -> dict:
    """The inverse of :func:`state_from_numpy` (bf16 data comes back as
    float32, which holds every bf16 value exactly)."""
    out = {}
    groups = (("cache", st.cache), ("queues", st.queues),
              ("metrics", st.metrics))
    # host loops over dataclass fields (eager torch, nothing is traced)
    for prefix, obj in groups:  # bamlint: ignore[BAM104]
        for f in _tensor_fields(type(obj), prefix):  # bamlint: ignore[BAM104]
            t = getattr(obj, f).detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.float()
            out[f"{prefix}.{f}"] = t.numpy()
    return out
