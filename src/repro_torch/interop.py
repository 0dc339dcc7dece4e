"""Carry state across packages as numpy.

A ``BamState`` travels as a flat dict of arrays, keyed ``"cache.<field>"``,
``"queues.<field>"`` and ``"metrics.<field>"``; a model's parameters
travel as the reference's nested dict, blocks stacked on a leading layer
axis, or for xLSTM a tuple of per-layer trees (:func:`params_from_numpy`,
:func:`params_to_numpy`); gradients and the AdamW state in the same layout
(:func:`named_to_numpy`, :func:`named_from_numpy`,
:func:`opt_state_to_numpy`, :func:`opt_state_from_numpy`).

:func:`state_from_numpy` builds the port's ``BamState`` on a device from
such a dict (for example one made from the JAX package's state, which has
the same field names), so a run can resume where another left off;
:func:`state_to_numpy` goes back.  Float counters become float64 and the
rest keep their dtypes (int32, bool, and the cache line dtype).

A ``RuntimeState`` travels the same way, with the per-tenant metrics under
``"tenant_metrics.<tid>.<field>"`` and each device-resident tenant store
under ``"storages.<tid>.data"`` (:func:`runtime_state_from_numpy`,
:func:`runtime_state_to_numpy`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.core.bam_array import BamState, RuntimeState
from repro_torch.core.cache import CacheState
from repro_torch.core.metrics import IOMetrics
from repro_torch.core.queues import QueueState
from repro_torch.core.storage import HBMStorage
from repro_torch.models import hymba, transformer, xlstm
from repro_torch.models.model import family_module
from repro_torch.utils import resolve_device

_STATIC = {
    "cache": ("num_sets", "ways", "line_elems"),
    "queues": ("num_queues", "depth", "n_devices", "stripe_blocks",
               "n_tenants", "tenant_weights", "failed_devices"),
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


def _group(d, prefix, cls):
    return {f: d[f"{prefix}.{f}"] for f in _tensor_fields(cls, prefix)}


def _metrics_from(d, prefix, device) -> IOMetrics:
    return IOMetrics(**{k: _to_torch(v, device, widen=True)
                        for k, v in _group(d, prefix, IOMetrics).items()})


def _put(out: dict, prefix: str, obj, group: str) -> None:
    """Copies of ``obj``'s tensor fields into ``out`` under ``prefix``."""
    for f in _tensor_fields(type(obj), group):
        t = getattr(obj, f).detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[f"{prefix}.{f}"] = t.numpy().copy()


def state_from_numpy(d: dict, device=None, *, stripe_blocks: int = 1,
                     failed_devices=(), tenant_weights=None) -> BamState:
    """A port ``BamState`` on ``device`` (``"cuda"`` unless the caller asks
    for another) from a dict of numpy arrays.

    Static sizes come from the arrays' shapes; ``stripe_blocks`` and
    ``failed_devices`` are the SSD array's, ``tenant_weights`` the rings'
    (default all 1).  Float32 metric counters are widened to float64;
    cache line data keeps its dtype."""
    device = resolve_device(device)

    def group(prefix, cls):
        return _group(d, prefix, cls)

    c = group("cache", CacheState)
    tags = np.asarray(c["tags"])
    cache = CacheState(
        num_sets=tags.shape[0], ways=tags.shape[1],
        line_elems=np.asarray(c["data"]).shape[1],
        **{k: _to_torch(v, device) for k, v in c.items()})
    q = group("queues", QueueState)
    sq_key = np.asarray(q["sq_key"])
    n_tenants = np.asarray(q["tenant_enqueued"]).shape[0]
    queues = QueueState(
        num_queues=sq_key.shape[0], depth=sq_key.shape[1],
        n_devices=np.asarray(q["rr_ptr"]).shape[0],
        stripe_blocks=stripe_blocks, n_tenants=n_tenants,
        tenant_weights=tuple(float(w) for w in (
            tenant_weights or (1.0,) * n_tenants)),
        failed_devices=tuple(sorted({int(x) for x in failed_devices})),
        **{k: _to_torch(v, device) for k, v in q.items()})
    return BamState(cache=cache, queues=queues,
                    metrics=_metrics_from(d, "metrics", device))


def state_to_numpy(st: BamState) -> dict:
    """The inverse of :func:`state_from_numpy` (bf16 data comes back as
    float32, which holds every bf16 value exactly).  The arrays are copies:
    the port updates a state in place, so a view of a CPU state would
    change with it."""
    out = {}
    # host loops over the state's parts (eager torch, nothing is traced)
    for prefix, obj in (("cache", st.cache), ("queues", st.queues),  # bamlint: ignore[BAM104]
                        ("metrics", st.metrics)):
        _put(out, prefix, obj, prefix)
    return out


def runtime_state_from_numpy(d: dict, device=None, *,
                             stripe_blocks: int = 1, failed_devices=(),
                             tenant_weights=None) -> RuntimeState:
    """A port ``RuntimeState`` on ``device`` (``"cuda"`` unless the caller
    asks for another) from a dict of numpy arrays (see
    :func:`state_from_numpy`): the shared cache and rings, the global
    metrics, one ``IOMetrics`` per tenant and the device-resident tenant
    stores (``None`` where the dict holds none)."""
    device = resolve_device(device)
    base = state_from_numpy(d, device, stripe_blocks=stripe_blocks,
                            failed_devices=failed_devices,
                            tenant_weights=tenant_weights)
    nt = base.queues.n_tenants
    return RuntimeState(
        cache=base.cache, queues=base.queues, metrics=base.metrics,
        tenant_metrics=tuple(_metrics_from(d, f"tenant_metrics.{i}", device)
                             for i in range(nt)),
        storages=tuple(
            HBMStorage(_to_torch(d[f"storages.{i}.data"], device))
            if f"storages.{i}.data" in d else None for i in range(nt)))


def runtime_state_to_numpy(rst: RuntimeState) -> dict:
    """The inverse of :func:`runtime_state_from_numpy`; the arrays are
    copies, as in :func:`state_to_numpy`."""
    out = state_to_numpy(BamState(cache=rst.cache, queues=rst.queues,
                                  metrics=rst.metrics))
    # host loops over the tenants (eager torch, nothing is traced)
    for i, m in enumerate(rst.tenant_metrics):  # bamlint: ignore[BAM104]
        _put(out, f"tenant_metrics.{i}", m, "metrics")
    for i, s in enumerate(rst.storages):  # bamlint: ignore[BAM104]
        if s is not None:
            out[f"storages.{i}.data"] = s.data.detach().cpu().numpy().copy()
    return out


STACKED = ("blocks", "enc_blocks")     # groups of per-layer parameters
MAMBA = ("w_in", "conv", "w_bc", "w_dt", "dt_bias", "a_log", "d_skip",
         "w_out")


def _dense(path, d):
    out = [(path + ("w",), d.w)]
    if d.b is not None:
        out.append((path + ("b",), d.b))
    return out


def _norm(path, n):
    out = [(path + ("scale",), n.scale)]
    if n.bias is not None:
        out.append((path + ("bias",), n.bias))
    return out


def _attention(path, a):
    out = []
    for name in ("wq", "wk", "wv", "wo"):
        out += _dense(path + (name,), getattr(a, name))
    if a.q_norm is not None:
        out += [(path + ("q_norm",), a.q_norm),
                (path + ("k_norm",), a.k_norm)]
    return out


def _mlp(path, m):
    out = []
    for name in ("w1", "w2", "w3"):
        d = getattr(m, name)
        if d is not None:
            out += _dense(path + (name,), d)
    return out


def _transformer_block(pre, bp):
    out = _norm(pre + ("ln1",), bp.ln1) + _norm(pre + ("ln2",), bp.ln2)
    out += _attention(pre + ("attn",), bp.attn)
    if bp.mlp is not None:
        out += _mlp(pre + ("mlp",), bp.mlp)
    if bp.moe is not None:
        out += [(pre + ("moe", name), getattr(bp.moe, name))
                for name in ("router", "w1", "w2", "w3")]
    if bp.xattn is not None:
        out += _norm(pre + ("ln_x",), bp.ln_x)
        out += _attention(pre + ("xattn",), bp.xattn)
    return out


def _hymba_block(pre, bp):
    out = _norm(pre + ("ln1",), bp.ln1) + _norm(pre + ("ln2",), bp.ln2)
    out += _attention(pre + ("attn",), bp.attn)
    out += [(pre + ("mamba", name), getattr(bp.mamba, name))
            for name in MAMBA]
    out += [(pre + ("n_attn",), bp.n_attn), (pre + ("n_ssm",), bp.n_ssm)]
    return out + _mlp(pre + ("mlp",), bp.mlp)


def _xlstm_block(pre, bp):
    out = _norm(pre + ("ln",), bp.ln)
    if isinstance(bp, xlstm.SLSTMBlock):
        out += _dense(pre + ("w_in",), bp.w_in) + [(pre + ("r",), bp.r)]
    else:
        out += _dense(pre + ("w_up",), bp.w_up)
        out += [(pre + (name,), getattr(bp, name))
                for name in ("wq", "wk", "wv", "hn")]
        out += _dense(pre + ("w_if",), bp.w_if)
    return out + _dense(pre + ("w_down",), bp.w_down)


def _tree_pairs(model: nn.Module):
    """(path in the reference's parameter tree, module parameter) pairs;
    the paths of layer i of a group of ``STACKED`` start with
    ``(group, i)``."""
    if isinstance(model, xlstm.XLSTMLM):
        block = _xlstm_block
    elif isinstance(model, hymba.HymbaLM):
        block = _hymba_block
    else:
        block = _transformer_block
    pairs = [(("embed", "table"), model.embed.table)]
    if isinstance(model, hymba.HymbaLM):
        pairs.append((("meta",), model.meta))
    for i, bp in enumerate(model.blocks):
        pairs += block(("blocks", i), bp)
    pairs += _norm(("ln_f",), model.ln_f)
    if model.head is not None:
        pairs += _dense(("head",), model.head)
    if getattr(model, "pos", None) is not None:
        pairs.append((("pos",), model.pos.table))
    if getattr(model, "enc_blocks", None) is not None:
        for i, bp in enumerate(model.enc_blocks):
            pairs += block(("enc_blocks", i), bp)
        pairs.append((("enc_pos",), model.enc_pos.table))
        pairs += _norm(("enc_ln_f",), model.enc_ln_f)
    return pairs


def _leaf(tree, path):
    """The array at ``path``.  A group of ``STACKED`` is either stacked on
    a leading layer axis (``(group, i, ...)`` indexes layer i of its
    arrays) or a tuple of per-layer trees (xLSTM's blocks)."""
    node = tree
    if path[0] in STACKED and not isinstance(tree[path[0]], (tuple, list)):
        for key in (path[0],) + path[2:]:
            node = node[key]
        return np.asarray(node)[path[1]]
    for key in path:
        node = node[key]
    return np.asarray(node)


def _set_leaf(tree: dict, path, a) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = a


@torch.no_grad()
def params_from_numpy(cfg, tree: dict, device=None,
                      dtype: torch.dtype | None = None) -> nn.Module:
    """The port's model of ``cfg``'s family from the reference's parameter
    tree (numpy arrays; transformer and hymba blocks stacked on a leading
    layer axis, xLSTM blocks a tuple of per-layer trees), on ``device``
    (default CUDA, as :func:`repro_torch.models.model.build_model`), its
    weights cast to ``dtype`` (default: the config's compute dtype; the
    parameters the reference applies in float32 stay float32).  A learned
    position table takes its length from the tree."""
    _, cls = family_module(cfg)
    max_seq = np.shape(tree["pos"])[0] if "pos" in tree else 0
    model = cls(cfg, max_seq=max_seq, dtype=dtype,
                device=resolve_device(device))
    return load_params_(model, tree)


@torch.no_grad()
def load_params_(model: nn.Module, tree: dict) -> nn.Module:
    """Copy the reference's parameter tree (numpy arrays, the layout of
    :func:`params_to_numpy`) into ``model``'s parameters in place, each
    cast to its parameter's dtype; raises on a shape that differs."""
    for path, param in _tree_pairs(model):
        a = _leaf(tree, path)
        if tuple(a.shape) != tuple(param.shape):
            raise ValueError(f"{'/'.join(map(str, path))}: shape {a.shape} "
                             f"!= {tuple(param.shape)}")
        param.copy_(_to_torch(a.astype(np.float32), "cpu"))
    return model


def params_to_numpy(model: nn.Module) -> dict:
    """The inverse of :func:`params_from_numpy`: the reference's nested
    tree of float32 numpy arrays, each stacked group's layers stacked on
    axis 0 (xLSTM's blocks a tuple of per-layer trees)."""
    return _numpy_tree(model, [param for _, param in _tree_pairs(model)])


def _numpy_tree(model: nn.Module, tensors) -> dict:
    """The reference's tree of float32 numpy arrays of ``tensors``, one a
    parameter of ``model`` in ``_tree_pairs`` order."""
    per_layer = isinstance(model, xlstm.XLSTMLM)
    tree: dict = {}
    stacked: dict = {}
    for (path, _), t in zip(_tree_pairs(model), tensors):
        a = t.detach().float().cpu().numpy()
        if path[0] in STACKED and not per_layer:
            stacked.setdefault((path[0],) + path[2:], []).append(a)
        else:
            _set_leaf(tree, path, a)
    for sub, arrs in stacked.items():
        _set_leaf(tree, sub, np.stack(arrs))
    if per_layer:
        tree["blocks"] = tuple(tree["blocks"][i]
                               for i in range(len(tree["blocks"])))
    return tree


# ------------------------------------------------------ optimizer state ----
def reference_paths(model: nn.Module) -> dict:
    """The port's parameter names (``named_parameters``) -> their paths in
    the reference's parameter tree (the layer index second in a group of
    ``STACKED``)."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(param)]: path for path, param in _tree_pairs(model)}


# The reference's logical axes of each parameter (``init_dense``,
# ``init_norm``, ``init_attention``, ``init_mlp``, ``init_moe``,
# ``init_embedding``, ``init_mamba``, the xLSTM blocks), keyed by the last
# names of its path.  A dense layer's weight is ``(parent, "w")`` and its
# bias ``(parent, "b")``, the bias taking the weight's last axis.
_DENSE_AXES = {
    "wq": ("w_embed", "heads"), "wk": ("w_embed", "kv_heads"),
    "wv": ("w_embed", "kv_heads"), "wo": ("heads", "w_embed"),
    "w1": ("w_embed", "ffn"), "w2": ("ffn", "w_embed"),
    "w3": ("w_embed", "ffn"), "head": ("w_embed", "vocab"),
    "w_up": ("w_embed", "w_inner"), "w_in": ("w_embed", "w_inner"),
    "w_if": ("w_inner", None), "w_down": ("w_inner", "w_embed"),
}
_GROUP_AXES = {
    "moe": {"router": ("w_embed", None), "w1": ("experts", "w_embed", None),
            "w2": ("experts", None, "w_embed"),
            "w3": ("experts", "w_embed", None)},
    "mamba": {"w_in": ("w_embed", "w_inner"), "conv": ("conv", "w_inner"),
              "w_bc": ("w_inner", None), "w_dt": ("w_inner", None),
              "dt_bias": ("w_inner",), "a_log": ("w_inner", None),
              "d_skip": ("w_inner",), "w_out": ("w_inner", "w_embed")},
}
_LEAF_AXES = {
    "table": ("vocab", "w_embed"), "meta": (None, "w_embed"),
    "pos": (None, "w_embed"), "enc_pos": ("enc_seq", "w_embed"),
    "q_norm": ("head_dim",), "k_norm": ("head_dim",),
    "scale": ("act_embed",), "bias": ("act_embed",),
    "n_attn": ("act_embed",), "n_ssm": ("act_embed",),
    # the mLSTM's block-diagonal q/k/v, its output norm; the sLSTM's r
    "wq": ("w_inner", None, None), "wk": ("w_inner", None, None),
    "wv": ("w_inner", None, None), "hn": (None,),
    "r": (None, "state_head", None, None),
}


def _path_axes(path) -> tuple:
    *pre, last = path
    parent = pre[-1] if pre else None
    if last in ("w", "b") and parent in _DENSE_AXES:
        w = _DENSE_AXES[parent]
        return w if last == "w" else (w[-1],)
    if parent in _GROUP_AXES:
        return _GROUP_AXES[parent][last]
    return _LEAF_AXES[last]


def param_axes(model: nn.Module) -> dict:
    """The port's parameter names -> the reference's logical axes of the
    same leaf (``api.init``'s axes tree), without the leading ``None`` of
    the layer axis that the reference's stacked blocks carry: the axes of
    each parameter as the port holds it, one tensor a layer."""
    return {name: _path_axes(path)
            for name, path in reference_paths(model).items()}


def reference_ndim(model: nn.Module) -> dict:
    """The port's parameter names -> the rank of the reference's leaf that
    holds them: one more than the parameter's own in a stacked group
    (transformer and hymba blocks stacked on a leading layer axis), the
    same for xLSTM's per-layer blocks and every other leaf.  A module
    outside the model families is its own layout."""
    params = dict(model.named_parameters())
    if not isinstance(model, (transformer.TransformerLM, hymba.HymbaLM,
                              xlstm.XLSTMLM)):
        return {name: p.ndim for name, p in params.items()}
    per_layer = isinstance(model, xlstm.XLSTMLM)
    return {name: params[name].ndim
            + int(path[0] in STACKED and not per_layer)
            for name, path in reference_paths(model).items()}


def named_to_numpy(model: nn.Module, tensors: dict) -> dict:
    """Tensors keyed by ``model``'s parameter names (gradients, optimizer
    moments) as the reference's tree of float32 numpy arrays, laid out as
    :func:`params_to_numpy` lays out the parameters."""
    names = {id(p): n for n, p in model.named_parameters()}
    return _numpy_tree(model, [tensors[names[id(param)]]
                               for _, param in _tree_pairs(model)])


def named_from_numpy(model: nn.Module, tree: dict, device=None,
                     dtype: torch.dtype = torch.float32) -> dict:
    """The inverse of :func:`named_to_numpy`: tensors of ``dtype`` on
    ``device`` (CUDA unless the caller asks for another) keyed by
    ``model``'s parameter names, from the reference's tree layout."""
    device = resolve_device(device)
    out = {}
    for name, path in reference_paths(model).items():
        a = _leaf(tree, path)
        out[name] = _to_torch(a.astype(np.float32), device).to(dtype)
    return out


def opt_state_to_numpy(model: nn.Module, ostate: dict) -> dict:
    """The port's AdamW state (``repro_torch.training.optimizer``) as the
    reference's: ``step`` an int32 scalar, ``mu``, ``nu`` and (with pod
    compression) ``ef`` trees in the reference's parameter layout."""
    out = {"step": np.asarray(int(ostate["step"]), np.int32)}
    for key in ("mu", "nu", "ef"):
        if key in ostate:
            out[key] = named_to_numpy(model, ostate[key])
    return out


def opt_state_from_numpy(model: nn.Module, d: dict, device=None) -> dict:
    """The inverse of :func:`opt_state_to_numpy`, on ``device`` (CUDA
    unless the caller asks for another): f32 moments keyed by ``model``'s
    parameter names and an int32 ``step``."""
    device = resolve_device(device)
    out = {"step": torch.tensor(int(np.asarray(d["step"])),
                                dtype=torch.int32, device=device)}
    for key in ("mu", "nu", "ef"):
        if key in d:
            out[key] = named_from_numpy(model, d[key], device)
    return out
