"""Carry state across packages as numpy.

A ``BamState`` travels as a flat dict of arrays, keyed ``"cache.<field>"``,
``"queues.<field>"`` and ``"metrics.<field>"``; a transformer's parameters
travel as the reference's nested dict, blocks stacked on a leading layer
axis (:func:`params_from_numpy`, :func:`params_to_numpy`).

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
from repro_torch.models.transformer import TransformerLM
from repro_torch.utils import resolve_device

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


def _tree_pairs(model: TransformerLM):
    """(path in the reference's parameter tree, module parameter) pairs;
    block paths start with ``("blocks", i)``."""
    def dense(path, d):
        out = [(path + ("w",), d.w)]
        if d.b is not None:
            out.append((path + ("b",), d.b))
        return out

    def norm(path, n):
        out = [(path + ("scale",), n.scale)]
        if n.bias is not None:
            out.append((path + ("bias",), n.bias))
        return out

    pairs = [(("embed", "table"), model.embed.table)]
    for i, bp in enumerate(model.blocks):
        pre = ("blocks", i)
        pairs += norm(pre + ("ln1",), bp.ln1) + norm(pre + ("ln2",), bp.ln2)
        a = bp.attn
        for name in ("wq", "wk", "wv", "wo"):
            pairs += dense(pre + ("attn", name), getattr(a, name))
        if a.q_norm is not None:
            pairs += [(pre + ("attn", "q_norm"), a.q_norm),
                      (pre + ("attn", "k_norm"), a.k_norm)]
        for name in ("w1", "w2", "w3"):
            d = getattr(bp.mlp, name)
            if d is not None:
                pairs += dense(pre + ("mlp", name), d)
    pairs += norm(("ln_f",), model.ln_f)
    if model.head is not None:
        pairs += dense(("head",), model.head)
    return pairs


def _leaf(tree, path):
    """The array at ``path``; ``("blocks", i, ...)`` indexes layer i of the
    stacked block arrays."""
    if path[0] == "blocks":
        node = tree["blocks"]
        for key in path[2:]:
            node = node[key]
        return np.asarray(node)[path[1]]
    node = tree
    for key in path:
        node = node[key]
    return np.asarray(node)


@torch.no_grad()
def params_from_numpy(cfg, tree: dict, device=None,
                      dtype: torch.dtype | None = None) -> TransformerLM:
    """The port's transformer from the reference's parameter tree (numpy
    arrays; blocks stacked on a leading layer axis), on ``device`` (default
    CUDA, as :func:`repro_torch.models.model.build_model`), its weights cast
    to ``dtype`` (default: the config's compute dtype)."""
    model = TransformerLM(cfg, dtype=dtype, device=resolve_device(device))
    for path, param in _tree_pairs(model):
        a = _leaf(tree, path)
        if tuple(a.shape) != tuple(param.shape):
            raise ValueError(f"{'/'.join(map(str, path))}: shape {a.shape} "
                             f"!= {tuple(param.shape)}")
        param.copy_(_to_torch(a.astype(np.float32), "cpu"))
    return model


def params_to_numpy(model: TransformerLM) -> dict:
    """The inverse of :func:`params_from_numpy`: the reference's nested
    tree of float32 numpy arrays, blocks stacked on axis 0."""
    tree: dict = {}
    stacked: dict = {}
    for path, param in _tree_pairs(model):
        a = param.detach().float().cpu().numpy()
        if path[0] == "blocks":
            stacked.setdefault(path[2:], []).append(a)
            continue
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = a
    for sub, arrs in stacked.items():
        node = tree.setdefault("blocks", {})
        for key in sub[:-1]:
            node = node.setdefault(key, {})
        node[sub[-1]] = np.stack(arrs)
    return tree
