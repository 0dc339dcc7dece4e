"""ZeRO-3 block by block: each block's weights gathered over ``data`` in
the layer loop, each block's gradient reduced to this rank's shard.

The rule table (:mod:`repro_torch.distributed.sharding`) puts every
weight's ``w_embed`` dimension on ``data``, and the reference's sharded
step leaves the rest to XLA: its blocks run in one ``jax.lax.scan`` under
``jax.checkpoint``, and the compiled loop all-gathers a block's weights
over ``data`` at the top of each iteration (again in the backward loop's
recompute) and reduces the block's gradient there, so a rank holds one
block's whole weights and one block's whole gradient at a time.  The port
does the same by hand.  A mesh step's local copy
(:func:`local_copy`) holds each block's parameters as this rank's shards
(the sharded model's own local tensors, split over ``data`` and over
``model``); the models run every block through
:func:`repro_torch.models.layers.remat`, which calls :func:`run_block`
inside the checkpointed function:

* forward: one all-gather over each mesh axis that splits the block's
  weights but ``model`` (``data``; the minor axis of a tuple first, as
  :func:`tensor_parallel.local_of`), of the block's shards of one dtype
  flattened together; the block then runs on the gathered weights, which
  take the parameters' places for the call only;
* backward: the reverse, one ``reduce_scatter`` an axis and dtype: the
  block's gradient summed over the ranks and cut to this rank's shard, the
  whole gradient dropped at once.  gloo (on CPU and CUDA tensors) and NCCL
  both take ``all_gather`` and ``reduce_scatter`` of a list;
* a dimension that ``sharding._spec_for_shape`` left unsplit (one that
  the axis does not divide) is neither gathered nor scattered, and a
  parameter split over no such axis is used as it is.

Under ``remat`` other than ``"none"`` no gathered weight is saved for the
backward: the recompute gathers the block again, as the reference's
backward loop does.  Under ``"none"`` the ops save the gathered weights,
so each block's live until its backward, as the reference's scan
residuals would; with grad off (a prefill) they are freed after the
block.  The sum is the plain one over the ranks: a step that wants a
weighted mean weights each rank's loss before the backward
(``train_loop``'s mesh step scales its seed by the slice's share).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp

__all__ = ["BLOCK_LISTS", "BlockPlan", "block_names", "gather_block",
           "local_copy", "plan_of", "run_block", "scatter_block",
           "shard_names", "split_axes"]

# the models' lists of blocks, each block one call of layers.remat
BLOCK_LISTS = ("blocks", "enc_blocks")


@dataclasses.dataclass(frozen=True)
class _Axis:
    """One mesh axis a block is gathered over: its group, size, and the
    dimension each of the plan's leaves is split on along it (None: not
    split on it)."""
    name: str
    group: object
    size: int
    dims: tuple


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """A block's gather: its leaves ``(owner module, attribute)`` split
    over some axis, and the axes in gather order (minor first)."""
    leaves: tuple
    axes: tuple


def block_names(model: nn.Module) -> frozenset:
    """The names of ``model``'s parameters that lie in its blocks."""
    lists = tuple(f"{b}." for b in BLOCK_LISTS
                  if isinstance(getattr(model, b, None), nn.ModuleList))
    return frozenset(n for n, _ in model.named_parameters()
                     if n.startswith(lists))


def split_axes(spec, mesh) -> tuple:
    """The mesh axes of more than one rank, but ``model``, that split a
    tensor of ``spec``, in mesh order."""
    used = {a for rule in spec for a in shd._as_tuple(rule)}
    return tuple(a for a in mesh.mesh_dim_names
                 if a in used and a != "model" and shd._size(mesh, a) > 1)


def _plan(block: nn.Module, prefix: str, specs: dict, mesh):
    """The :class:`BlockPlan` of ``block`` (its parameters' specs in
    ``specs`` under ``prefix``), or None when nothing of it is split."""
    leaves, split = [], []
    for name, _ in block.named_parameters():
        spec = specs[prefix + name]
        axes = split_axes(spec, mesh)
        if not axes:
            continue
        mod, _, leaf = name.rpartition(".")
        leaves.append((block.get_submodule(mod) if mod else block, leaf))
        split.append(spec)
    if not leaves:
        return None
    gather = []
    for a in reversed(mesh.mesh_dim_names):     # minor first
        dims = tuple(next((d for d, r in enumerate(spec)
                           if a in shd._as_tuple(r)), None)
                     for spec in split)
        if a == "model" or all(d is None for d in dims) \
                or shd._size(mesh, a) == 1:
            continue
        gather.append(_Axis(a, mesh.get_group(a), shd._size(mesh, a), dims))
    return BlockPlan(tuple(leaves), tuple(gather))


def local_copy(model: nn.Module, mesh,
               make: Callable[[torch.device], nn.Module]) -> nn.Module:
    """The tensor-parallel local copy of the sharded ``model``
    (:func:`tensor_parallel.local_copy`) whose block parameters are this
    rank's shards themselves (``to_local()``, no copy), each block given
    its :class:`BlockPlan` (:func:`plan_of`); the other parameters are
    empty, to be gathered over every axis but ``model`` by the caller."""
    names = block_names(model)
    work = tp.local_copy(model, mesh, make, shards=names)
    specs = {n: shd.spec_of(p) for n, p in model.named_parameters()}
    for b in BLOCK_LISTS:
        blocks = getattr(work, b, None)
        if not isinstance(blocks, nn.ModuleList):
            continue
        for i, block in enumerate(blocks):
            plan = _plan(block, f"{b}.{i}.", specs, mesh)
            if plan is not None:
                block._fsdp_plan = plan
    work._fsdp_shards = names
    return work


def shard_names(work: nn.Module) -> frozenset:
    """The parameters of ``work`` that are the rank's shards (those of its
    blocks when :func:`local_copy` made it, else none)."""
    return work.__dict__.get("_fsdp_shards", frozenset())


def plan_of(block: nn.Module):
    """``block``'s :class:`BlockPlan`, or None (a block of a plain model,
    or one whose weights no axis splits)."""
    return block.__dict__.get("_fsdp_plan")


def _bucket(plan_axis: _Axis, xs) -> dict:
    """The leaves split along ``plan_axis``, by dtype: dtype -> indices."""
    out = {}
    for i, d in enumerate(plan_axis.dims):
        if d is not None:
            out.setdefault(xs[i].dtype, []).append(i)
    return out


def gather_block(plan: BlockPlan, shards) -> list:
    """The block's whole-over-``data`` weights from this rank's
    ``shards`` (in the plan's leaf order): one all-gather an axis and
    dtype, of the shards flattened side by side, each then joined along
    its dimension in rank order."""
    xs = list(shards)
    for ax in plan.axes:
        for idx in _bucket(ax, xs).values():
            flat = torch.cat([xs[i].reshape(-1) for i in idx])
            parts = [torch.empty_like(flat) for _ in range(ax.size)]
            dist.all_gather(parts, flat, group=ax.group)
            at = 0
            for i in idx:
                n = xs[i].numel()
                xs[i] = torch.cat([p[at:at + n].view(xs[i].shape)
                                   for p in parts], ax.dims[i])
                at += n
    return xs


def scatter_block(plan: BlockPlan, grads) -> list:
    """The reverse of :func:`gather_block`: each whole gradient of
    ``grads`` summed over the ranks and cut to this rank's shard, one
    ``reduce_scatter`` an axis and dtype (the major axis first)."""
    gs = [g.contiguous() for g in grads]
    for ax in reversed(plan.axes):
        for idx in _bucket(ax, gs).values():
            chunks = [gs[i].chunk(ax.size, ax.dims[i]) for i in idx]
            ins = [torch.cat([c[r].reshape(-1) for c in chunks])
                   for r in range(ax.size)]
            out = torch.empty_like(ins[0])
            dist.reduce_scatter(out, ins, group=ax.group)
            at = 0
            for i, c in zip(idx, chunks):
                n = c[0].numel()
                gs[i] = out[at:at + n].view(c[0].shape)
                at += n
    return gs


class _GatherBlock(torch.autograd.Function):
    """Forward :func:`gather_block`, backward :func:`scatter_block`; saves
    no tensor."""

    @staticmethod
    def forward(ctx, plan, *shards):
        ctx.plan = plan
        return tuple(gather_block(plan, shards))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(scatter_block(ctx.plan, grads))


def run_block(block: nn.Module, fn, *args):
    """``fn(*args)`` with ``block``'s split parameters gathered
    (:class:`BlockPlan`): the gathered tensors stand in the parameters'
    places for the call, and the shards are put back after it.  A block
    with no plan runs as it is."""
    plan = plan_of(block)
    if plan is None:
        return fn(*args)
    shards = [owner._parameters[leaf] for owner, leaf in plan.leaves]
    whole = _GatherBlock.apply(plan, *shards)
    try:
        for (owner, leaf), w in zip(plan.leaves, whole):
            owner._parameters[leaf] = w
        del whole
        return fn(*args)
    finally:
        for (owner, leaf), s in zip(plan.leaves, shards):
            owner._parameters[leaf] = s
