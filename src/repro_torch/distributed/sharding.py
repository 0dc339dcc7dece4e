"""Logical-axis sharding: one rule table maps model-space axis names onto
the axes of a ``DeviceMesh``.

Port of ``repro.distributed.sharding``.  Model code names each parameter's
dimensions with *logical* axes (``("w_embed", "heads")``); the active
:class:`AxisRules` resolves them against the active mesh into a spec, a
plain tuple with one entry per dimension (``None``, a mesh axis name, or a
tuple of mesh axis names), equal to ``tuple(PartitionSpec)`` of the
reference.  :func:`to_placements` turns a spec into DTensor placements, and
:func:`local_slice` cuts a full tensor to the slice a rank holds, the one
the reference's ``NamedSharding`` gives the rank's mesh coordinate.

Default placement on the production mesh (pod, data, model):

=============  =====================  =============================
logical axis   mesh axes              gives
=============  =====================  =============================
batch          ("pod", "data")        DP over pods x data groups
w_embed        "data"                 ZeRO-3/FSDP weight sharding
heads/kv/ffn   "model"                Megatron TP
vocab          "model"                TP'd embedding + logits
experts        "model"                expert parallelism (EP)
kv_pages       "model"                BaM-paged KV pool striping
long_seq       "model"                SP for 500k decode state
=============  =====================  =============================

A tuple rule (``batch -> ("pod", "data")``) splits one dimension over
several mesh axes, the first the slowest; DTensor splits it over the mesh
dimensions in the mesh's order, so a tuple whose order is not the mesh's
raises rather than being reordered.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Mapping, Optional, Sequence, Tuple, Union

import torch

Rule = Union[None, str, Tuple[str, ...]]

__all__ = ["AxisRules", "DEFAULT_RULES", "NamedSharding", "activate",
           "axes_to_spec", "constrain", "current_mesh", "current_rules",
           "full", "local_slice", "param_shardings", "shard",
           "spec_for", "spec_of", "to_placements"]

DEFAULT_RULES: dict[str, Rule] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "act_embed": None,
    "act_heads": "model",
    "act_kv_heads": "model",
    "head_dim": None,
    "act_ffn": "model",
    "enc_seq": None,
    # weights
    "w_embed": "data",          # ZeRO-3: shard the d_model dim of weights
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "experts": "model",
    "expert_cap": None,
    "w_inner": "model",         # xlstm/mamba inner dim
    "conv": None,
    # serving state
    "kv_pages": "model",        # paged KV pool striped over chips
    "kv_seq": "model",          # dense long-context KV sharded on seq (SP)
    "state_head": "model",      # recurrent state heads
    # data pipeline
    "host_batch": ("pod", "data"),
}


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def _size(mesh, axis: str) -> int:
    return mesh.shape[_names(mesh).index(axis)]


@dataclasses.dataclass(frozen=True)
class AxisRules:
    rules: Mapping[str, Rule]

    def resolve(self, name: Optional[str], mesh) -> Rule:
        """The mesh axis (or axes) ``name`` maps to on ``mesh``; axes the
        mesh lacks are left out, and ``None`` when none is left."""
        if name is None:
            return None
        rule = self.rules.get(name, None)
        if rule is None or mesh is None:
            return None
        axes = _names(mesh)
        if isinstance(rule, str):
            return rule if rule in axes else None
        picked = tuple(a for a in rule if a in axes)
        return picked if picked else None


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: AxisRules = AxisRules(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def activate(mesh, rules: Mapping[str, Rule] | None = None):
    """Enter a mesh and rule context for this thread."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    if rules is not None:
        _CTX.rules = AxisRules(dict(rules))
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return _CTX.mesh


def current_rules() -> AxisRules:
    return _CTX.rules


def _entry(rule: Rule) -> Rule:
    """A spec entry as ``PartitionSpec`` keeps it: one axis as its name."""
    return rule[0] if isinstance(rule, tuple) and len(rule) == 1 else rule


def axes_to_spec(axes: Sequence[Optional[str]], mesh=None,
                 rules: Optional[AxisRules] = None) -> tuple:
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    return tuple(_entry(rules.resolve(a, mesh)) for a in axes)


def spec_for(axes, mesh=None, rules=None) -> tuple:
    return axes_to_spec(axes, mesh, rules)


def _axis_size(mesh, rule: Rule) -> int:
    if rule is None:
        return 1
    if isinstance(rule, str):
        return _size(mesh, rule)
    n = 1
    for a in rule:
        n *= _size(mesh, a)
    return n


def _spec_for_shape(axes, shape, mesh, rules) -> tuple:
    """Resolve axes -> spec, dropping mesh axes that don't divide the dim
    (hymba's 25 query heads over a 16-way model axis: the weight's
    flattened 1600 dim shards; the (B, 25, S, hd) activation skips it)."""
    parts = []
    for a, d in zip(axes, shape):
        rule = rules.resolve(a, mesh)
        if rule is not None and d % _axis_size(mesh, rule) != 0:
            rule = None
        parts.append(_entry(rule))
    return tuple(parts)


def _as_tuple(rule: Rule) -> tuple:
    return () if rule is None else (rule,) if isinstance(rule, str) \
        else tuple(rule)


def to_placements(spec: Sequence[Rule], mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dimension that splits tensor dimension d, ``Replicate()`` on the rest.
    Raises when a mesh axis splits two dimensions, or when a tuple rule
    lists its axes in another order than the mesh (DTensor would split in
    the mesh's order and give ranks other slices than the reference)."""
    from torch.distributed.tensor import Replicate, Shard

    names = _names(mesh)
    placements = [Replicate() for _ in names]
    seen = set()
    for d, rule in enumerate(spec):
        axes = _as_tuple(rule)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(spec)}: dimension {d} splits over "
                             f"{axes}, not in the mesh's order {names}")
        for a, i in zip(axes, idx):
            if a in seen:
                raise ValueError(f"spec {tuple(spec)}: mesh axis {a!r} "
                                 "splits two dimensions")
            seen.add(a)
            placements[i] = Shard(d)
    return tuple(placements)


def spec_of(x) -> tuple:
    """The spec of a DTensor's placements on its mesh (the inverse of
    :func:`to_placements`: a dimension split over one axis names it, over
    several a tuple of them in mesh order); ``()`` for a plain tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return ()
    names = _names(x.device_mesh)
    parts = [[] for _ in range(x.ndim)]
    for i, pl in enumerate(x.placements):
        if pl.is_shard():
            parts[pl.dim].append(names[i])
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in parts)


def local_slice(x: torch.Tensor, mesh, spec: Sequence[Rule],
                coord: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The slice of the full tensor ``x`` that the rank at mesh coordinate
    ``coord`` (default: this rank's) holds under ``spec``: along each split
    dimension the block at index ``c_1 n_2 ... n_k + ... + c_k`` of the axes
    ``(a_1, ..., a_k)`` that split it.  Raises when a split does not
    divide the dimension."""
    names = _names(mesh)
    coord = mesh.get_coordinate() if coord is None else coord
    for d, rule in enumerate(spec):
        axes = _as_tuple(rule)
        if not axes:
            continue
        idx, n = 0, 1
        for a in axes:
            i = names.index(a)
            idx, n = idx * mesh.shape[i] + coord[i], n * mesh.shape[i]
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(x.shape)} does not "
                             f"split {n} ways ({axes})")
        c = x.shape[d] // n
        x = x.narrow(d, idx * c, c)
    return x


def shard(x: torch.Tensor, sharding: NamedSharding):
    """A DTensor of the full tensor ``x`` (the same on every rank) placed
    as ``sharding`` says; nothing is sent.  This rank keeps a copy of its
    slice, or ``x`` itself (contiguous) when the slice is all of it, so a
    caller that drops ``x`` keeps one copy on the device."""
    from torch.distributed.tensor import DTensor

    loc = local_slice(x, sharding.mesh, sharding.spec)
    loc = loc.contiguous() if loc.numel() == x.numel() else loc.clone()
    return DTensor.from_local(loc, sharding.mesh, sharding.placements,
                              run_check=False, shape=x.shape,
                              stride=x.contiguous().stride())


def full(x):
    """The full tensor of a DTensor (gathered over the mesh), else ``x``."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]]):
    """Lay out an activation by its logical axes.  A plain tensor, or any
    tensor outside a mesh, comes back unchanged; a DTensor is
    redistributed to the spec of ``axes`` on its own mesh (axes that do not
    divide their dimension dropped).  Values never change."""
    from torch.distributed.tensor import DTensor

    mesh = _CTX.mesh
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = _spec_for_shape(axes, x.shape, x.device_mesh, _CTX.rules)
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))


def param_shardings(axes: dict, mesh=None,
                    rules: Optional[AxisRules] = None,
                    shapes: Optional[dict] = None) -> dict:
    """Parameter name -> :class:`NamedSharding` from name -> logical axes
    (``repro_torch.interop.param_axes`` gives a model's).  With ``shapes``
    (name -> tensor or shape) mesh axes that don't divide a dim are
    dropped per parameter."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None:
        raise ValueError("param_shardings requires a mesh")

    def spec(name, a):
        if a is None:
            return ()
        if shapes is None:
            return axes_to_spec(a, mesh, rules)
        s = shapes[name]
        return _spec_for_shape(a, getattr(s, "shape", s), mesh, rules)

    return {n: NamedSharding(mesh, spec(n, a)) for n, a in axes.items()}
