"""Tensor-parallel (Megatron) and expert-parallel compute along a mesh's
``model`` axis, with explicit collectives.

The rule table (:mod:`repro_torch.distributed.sharding`) puts ``heads``,
``kv_heads``, ``ffn``, ``vocab`` and ``experts`` on ``model``.  The
reference lets XLA split the compute from its sharding constraints; the
port does it by hand.  Under :func:`activate`, each rank of a ``model``
group computes with its own shard of every weight that the rule table
splits over ``model`` (a *local copy* of the model, :func:`local_copy`,
whose parameters are the rank's state gathered over the other mesh axes
only, :func:`local_of`), and the layers (:mod:`repro_torch.models.layers`)
join the ranks with these pieces:

* :func:`copy_to_model`: identity forward, all-reduce backward.  A tensor
  that every rank holds whole passes it before the ranks consume it in
  parts (the input of a column-parallel product, a replicated parameter
  applied to the rank's heads), so its gradient is the sum of theirs;
* :func:`reduce_from_model`: all-reduce forward, identity backward, for
  the partial sums of a row-parallel product or of the rank's experts;
* :func:`gather_from_model`: all-gather along a dimension, whose backward
  slices the rank's part;
* :func:`reduce_scatter_from_model`: the rank's block of the sum of the
  ranks' partials (an all-reduce), whose backward all-gathers, for a
  row-parallel product consumed by columns (Mamba's ``w_dt``);
* :func:`parts_of_model`: a rank's slice of each part of a dimension made
  of parts side by side (Mamba's and mLSTM's [xm | z], the sLSTM's four
  gates), from weight columns the reference splits into contiguous
  blocks that do not follow the parts;
* :func:`vocab_embed`: a lookup in the rank's rows of a vocab-split table,
  the other rows 0, then :func:`reduce_from_model`;
* :func:`vocab_nll`: the cross-entropy of vocab-split logits in f32, from
  an all-reduce of the rows' max, of their sums of exponentials and of the
  target logit.

A layer finds whether a weight is split by its shape: under
:func:`activate` a dimension smaller than the config's is this rank's
``1 / size`` of it (:func:`split`).  Outside :func:`activate`, or on a
``model`` axis of one rank, :func:`current` is None and every layer runs
its plain path.  The kernels take plain tensors, so nothing here is a
DTensor: DTensor's eager dispatch made a sharded decode 1.58-3.05x slower
at world size 1, and its first use costs seconds a process.  Only
``all_reduce`` and ``all_gather`` (of a list) are used, which gloo takes
on CPU and CUDA tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.distributed import sharding as shd

__all__ = ["ModelGroup", "activate", "copy_to_model", "current",
           "gather_from_model", "local_copy", "local_of", "local_shape",
           "local_size", "model_dims", "model_group", "own_spans",
           "parts_of_model", "reduce_from_model",
           "reduce_scatter_from_model", "split", "vocab_embed", "vocab_nll",
           "without_model"]


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """This rank's ``model`` group: its process group, size and rank."""
    group: object
    size: int
    rank: int


class _Ctx:
    # process-wide, not a thread's: on CUDA the backward (and remat's
    # recompute within it) runs on autograd's device thread
    tp: Optional[ModelGroup] = None


_CTX = _Ctx()


def model_group(mesh) -> Optional[ModelGroup]:
    """The ``model`` group of ``mesh`` for this rank, or None when the mesh
    has no ``model`` axis or it has one rank (nothing is split)."""
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return None
    n = shd._size(mesh, "model")
    if n == 1:
        return None
    return ModelGroup(mesh.get_group("model"), n,
                      mesh.get_local_rank("model"))


@contextlib.contextmanager
def activate(mesh):
    """Within it the layers compute tensor-parallel over ``mesh``'s
    ``model`` axis, on a model made by :func:`local_copy`."""
    prev = _CTX.tp
    _CTX.tp = model_group(mesh)
    try:
        yield
    finally:
        _CTX.tp = prev


def current() -> Optional[ModelGroup]:
    return _CTX.tp


def split(t: torch.Tensor, dim: int, whole: int) -> bool:
    """Whether ``t`` holds this rank's ``1 / size`` of a dimension of
    ``whole`` entries along ``dim`` (checked), under :func:`activate`."""
    tp = _CTX.tp
    if tp is None or t.shape[dim] == whole:
        return False
    if t.shape[dim] * tp.size != whole:
        raise ValueError(f"a dimension of {t.shape[dim]} is neither "
                         f"{whole} nor its 1/{tp.size}")
    return True


def local_size(whole: int) -> int:
    """The entries a local copy holds of a dimension of ``whole`` that the
    rule table puts on ``model`` (a decode state's ``w_inner`` channels):
    this rank's ``1 / size`` where the ranks divide it, as
    ``sharding._spec_for_shape`` splits, else all of them."""
    tp = _CTX.tp
    return whole if tp is None or whole % tp.size else whole // tp.size


# ------------------------------------------------------------ collectives --
def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``x`` of ``group`` joined along ``dim``."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceScatterFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        n = x.shape[dim] // tp.size
        ctx.dim, ctx.tp = dim, tp
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=tp.group)
        return y.narrow(dim, tp.rank * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.tp.group, ctx.tp.size), None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.rank, ctx.n = dim, tp.rank, x.shape[dim]
        return _all_gather(x, dim, tp.group, tp.size)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def _pieces(spans, width: int, block: int):
    """Where the columns ``spans`` of a dimension cut into ``len(spans)``
    equal parts of ``width`` lie in the ranks' blocks of ``block``
    columns: ``(block index, start in the block, length)`` in order,
    part ``p`` taking its columns ``[lo, hi)``."""
    out = []
    for p, (lo, hi) in enumerate(spans):
        a, b = p * width + lo, p * width + hi
        while a < b:
            k = a // block
            e = min(b, (k + 1) * block)
            out.append((k, a - k * block, e - a))
            a = e
    return out


class _PartsOfModel(torch.autograd.Function):
    """Forward: this rank's ``spans`` of each part, from the ranks' blocks
    gathered as a list.  Backward: the ranks' gradients gathered the same
    way (padded to one width), each rank's pieces that fall in this rank's
    block added into its gradient."""

    @staticmethod
    def forward(ctx, t, dim, tp, spans):
        n, block = tp.size, t.shape[dim]
        width = n * block // len(spans[0])
        ctx.dim, ctx.tp, ctx.spans, ctx.width = dim, tp, spans, width
        x = t.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=tp.group)
        parts[tp.rank] = t
        return torch.cat([parts[k].narrow(dim, s, m) for k, s, m in
                          _pieces(spans[tp.rank], width, block)], dim)

    @staticmethod
    def backward(ctx, g):
        dim, tp, width = ctx.dim, ctx.tp, ctx.width
        block = width * len(ctx.spans[0]) // tp.size
        most = max(sum(hi - lo for lo, hi in s) for s in ctx.spans)
        g = g.contiguous()
        if g.shape[dim] < most:
            pad = list(g.shape)
            pad[dim] = most - g.shape[dim]
            g = torch.cat([g, g.new_zeros(pad)], dim)
        gs = [torch.empty_like(g) for _ in range(tp.size)]
        dist.all_gather(gs, g, group=tp.group)
        shape = list(g.shape)
        shape[dim] = block
        out = g.new_zeros(shape)
        for j, gj in enumerate(gs):
            at = 0
            for k, s, m in _pieces(ctx.spans[j], width, block):
                if k == tp.rank:
                    out.narrow(dim, s, m).add_(gj.narrow(dim, at, m))
                at += m
        return out, None, None, None


def own_spans(parts: int, whole: int, rank: int) -> tuple:
    """Rank ``rank``'s ``1 / size`` of each of ``parts`` equal parts of a
    dimension of ``whole`` entries, as ``(lo, hi)`` within each part
    (every column of each part with no ``model`` group)."""
    tp = _CTX.tp
    n = 1 if tp is None else tp.size
    w = whole // parts
    if w % n:
        raise ValueError(f"parts of {w} do not split over {n} ranks")
    c = w // n
    return ((rank * c, (rank + 1) * c),) * parts


def parts_of_model(t: torch.Tensor, whole: int, parts: int, dim: int = -1,
                   spans_of: Optional[Callable] = None) -> torch.Tensor:
    """The columns ``[lo, hi)`` of each of the ``parts`` equal parts of
    ``t``'s dimension ``dim`` of ``whole`` entries ([xm | z] of a Mamba or
    mLSTM up-projection, the sLSTM's [i | f | z | o] gates), joined along
    ``dim`` in part order: ``spans_of(rank)`` gives each part's ``(lo,
    hi)``, by default the rank's own ``1 / size`` of each
    (:func:`own_spans`).

    With no ``model`` group that is every column, ``t`` itself.  ``t``
    whole on every rank of one: its slices, passed through
    :func:`copy_to_model` first (the ranks' gradients are summed).  ``t``
    this rank's block of a dimension split over ``model`` into contiguous
    blocks, as a weight's columns or a product's output columns: the
    reference's layout, which puts whole parts on some ranks (over 2
    ranks rank 0 holds all of xm), so the blocks are gathered as a list
    (no tensor of the whole dimension is made) and the rank's spans cut
    from them.  The backward sends each rank's gradient pieces to the
    blocks' owners: the ranks' gradients are gathered, and each owner adds
    the pieces that fall in its block (ranks whose spans overlap, as ranks
    that share a head do, have their pieces summed), so every rank's spans
    come from ``spans_of``.  Spans that are exactly the rank's own block
    return ``t``."""
    dim %= t.ndim
    tp = _CTX.tp
    if spans_of is None:
        def spans_of(r):
            return own_spans(parts, whole, r)
    spans = tuple(spans_of(0 if tp is None else tp.rank))
    if len(spans) != parts:
        raise ValueError(f"{len(spans)} spans for {parts} parts")
    w = whole // parts
    if not split(t, dim, whole):
        if spans == ((0, w),) * parts:
            return t
        if tp is not None:
            t = copy_to_model(t)
        return torch.cat([t.narrow(dim, p * w + lo, hi - lo)
                          for p, (lo, hi) in enumerate(spans)], dim)
    block = t.shape[dim]
    if _pieces(spans, w, block) == [(tp.rank, 0, block)]:
        return t
    return _PartsOfModel.apply(
        t, dim, tp, tuple(tuple(spans_of(r)) for r in range(tp.size)))


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` (whole on every rank), its gradient summed over the ``model``
    ranks; ``x`` itself outside :func:`activate`."""
    tp = _CTX.tp
    return x if tp is None else _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` (an all-reduce), the gradient
    passed to each unchanged."""
    tp = _CTX.tp
    return x if tp is None else _ReduceFromModel.apply(x, tp.group)


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The ranks' parts of ``x`` joined along ``dim`` in rank order; the
    gradient of the whole sliced back to this rank's part."""
    tp = _CTX.tp
    if tp is None:
        return x
    return _GatherFromModel.apply(x, dim % x.ndim, tp)


def reduce_scatter_from_model(x: torch.Tensor, dim: int = -1
                              ) -> torch.Tensor:
    """This rank's ``1 / size`` block along ``dim`` of the sum of the
    ranks' partial ``x`` (an all-reduce, then the rank's block: a
    row-parallel product whose output the ranks consume by columns); the
    backward gathers the ranks' gradients of their blocks, the whole
    gradient of each one's partial."""
    tp = _CTX.tp
    if tp is None:
        return x
    return _ReduceScatterFromModel.apply(x, dim % x.ndim, tp)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, vocab: int
                ) -> torch.Tensor:
    """``table[tokens]`` of a table of ``vocab`` rows that may be split
    over ``model``: each rank looks up the tokens in its rows, 0 for the
    others, and the ranks' lookups are summed."""
    V = table.shape[0]
    if not split(table, 0, vocab):
        return table[tokens.long()]
    tp = _CTX.tp
    t = tokens.long() - tp.rank * V
    mine = (t >= 0) & (t < V)
    e = table[t.clamp(0, V - 1)].masked_fill(~mine[..., None], 0)
    return reduce_from_model(e)


class _VocabNll(torch.autograd.Function):
    """Per-position ``logsumexp(l) - l[label]`` of logits split over the
    vocabulary (this rank's columns start at ``v0``), f32."""

    @staticmethod
    def forward(ctx, logits, labels, v0, group):
        Vl = logits.shape[-1]
        m = logits.max(-1).values
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m[..., None])
        s = e.sum(-1)
        dist.all_reduce(s, group=group)
        t = labels.long() - v0
        mine = (t >= 0) & (t < Vl)
        t = t.clamp(0, Vl - 1)
        tl = torch.gather(logits, -1, t[..., None])[..., 0] \
            .masked_fill(~mine, 0.0)
        dist.all_reduce(tl, group=group)
        ctx.save_for_backward(e / s[..., None], t, mine)
        return torch.log(s) + m - tl

    @staticmethod
    def backward(ctx, g):
        p, t, mine = ctx.saved_tensors
        grad = p * g[..., None]
        grad.scatter_add_(-1, t[..., None],
                          -(g * mine.to(g.dtype))[..., None])
        return grad, None, None, None


def vocab_nll(logits: torch.Tensor, labels: torch.Tensor, vocab: int
              ) -> torch.Tensor:
    """The next-token NLL of each position, in f32: ``logits`` (..., V) of
    a ``vocab``-word vocabulary or, split over ``model``, this rank's
    columns (..., V / size) of rank-ordered slices; ``labels`` (...)
    int."""
    lf = logits.float()
    tp = _CTX.tp
    if not split(lf, -1, vocab):
        return torch.logsumexp(lf, dim=-1) - torch.gather(
            lf, -1, labels.long()[..., None])[..., 0]
    return _VocabNll.apply(lf, labels, tp.rank * lf.shape[-1], tp.group)


# ------------------------------------------------------- the local copy ----
def model_dims(spec) -> tuple:
    """The dimensions that ``spec`` splits over ``model``.  A dimension
    split over ``model`` and another axis together has no local layout
    here and raises."""
    dims = []
    for d, rule in enumerate(spec):
        axes = shd._as_tuple(rule)
        if "model" in axes:
            if len(axes) > 1:
                raise NotImplementedError(
                    f"spec {tuple(spec)}: dimension {d} splits over {axes}"
                    "; tensor-parallel compute takes 'model' alone")
            dims.append(d)
    return tuple(dims)


def without_model(spec) -> tuple:
    """``spec`` with ``model`` taken out: how a tensor of the local copy's
    shape is split over the other axes."""
    model_dims(spec)
    return tuple(None if shd._as_tuple(r) == ("model",) else r
                 for r in spec)


def local_shape(p, mesh) -> tuple:
    """The shape of a DTensor's local-copy tensor: whole on every
    dimension but those split over ``model``, which hold ``1 / size``."""
    n = shd._size(mesh, "model") if "model" in mesh.mesh_dim_names else 1
    dims = model_dims(shd.spec_of(p))
    return tuple(s // n if d in dims else s for d, s in enumerate(p.shape))


@torch.no_grad()
def local_of(p, mesh) -> torch.Tensor:
    """This rank's local-copy tensor of the DTensor ``p`` (a plain tensor
    comes back as it is): its shard gathered over every mesh axis that
    splits it but ``model`` (ZeRO-3's ``w_embed`` over ``data``), the
    minor axis of a tuple first."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return p
    x = p.to_local()
    for d, rule in enumerate(shd.spec_of(p)):
        for a in reversed(shd._as_tuple(rule)):
            n = shd._size(mesh, a)
            if a != "model" and n > 1:
                x = _all_gather(x, d, mesh.get_group(a), n)
    return x


def local_copy(model: nn.Module, mesh,
               make: Callable[[torch.device], nn.Module],
               shards=frozenset()) -> nn.Module:
    """An empty model of ``model``'s structure whose parameters have the
    local-copy shapes of ``model``'s DTensors (:func:`local_shape`; values
    uninitialised, ``requires_grad`` on), on ``model``'s device:
    ``make(device)`` builds the model's class (here on ``meta``, so no
    whole weight is made).  The parameters named in ``shards`` are the
    DTensors' local tensors themselves (their storage shared, so an
    update of the sharded model shows in the copy)."""
    work = make(torch.device("meta"))
    own = dict(work.named_parameters())
    for name, p in model.named_parameters():
        loc = p.to_local() if hasattr(p, "to_local") else p
        if own[name].shape != p.shape or own[name].dtype != p.dtype:
            raise ValueError(f"the local copy's {name} differs from the "
                             "sharded model's")
        mod, _, leaf = name.rpartition(".")
        owner = work.get_submodule(mod) if mod else work
        setattr(owner, leaf, nn.Parameter(
            loc.detach() if name in shards else torch.empty(
                local_shape(p, mesh), dtype=p.dtype, device=loc.device)))
    return work
