"""The train step: loss and gradients -> (optional pod-compressed
reduction) -> AdamW, with microbatch gradient accumulation, on one device
or over a ``DeviceMesh``.

Port of ``repro.training.train_loop``.  With no mesh the state is
``{"params": model, "opt": adamw state}``; the step turns on
``requires_grad`` for the model's parameters (they are made without it),
takes the gradients with ``torch.autograd.grad`` and updates the model and
the moments in place (``optimizer.adamw_update``).  With no mesh the
reference takes the plain step whatever ``pod_compression`` says, and so
does the port.

Under a mesh (``mesh=`` or the active one) the state is sharded
(:func:`shard_state` with :func:`state_shardings`): the model's parameters
and the moments are DTensors, each rank holding the slice the reference's
``NamedSharding`` gives its mesh coordinate.  Each step computes on a
local copy of the model (:func:`work_copy`; each weight that the rule
table splits over ``model`` holds this rank's ``model`` shard, no rank a
whole copy of it) tensor-parallel under ``tensor_parallel.activate``,
every family alike.  ZeRO-3 block by block, as the reference's compiled
step: the blocks' parameters in the copy are the rank's shards
themselves, each block gathered over ``data`` inside its remat region in
the layer loop and its gradient reduce-scattered back to the shard in the
backward (:mod:`repro_torch.distributed.fsdp`), so a rank holds one
block's whole weights and gradient at a time; the parameters outside the
blocks (the embedding and head, final norms, learned positions, hymba's
meta tokens, the VLM projection) are gathered for the step, as the
reference gathers them outside its loop.  The step takes the gradients
of this rank's slice of the batch (dim 0 split over the mesh axes of
``batch``, :func:`batch_shardings`), each slice's loss weighted by its
share of the loss tokens before the backward (which gives the
reference's global mean once summed), and sums the loss, the metrics
and the gradients over those axes: a block gradient arrives summed over
the axes that split its weight, the others are all-reduced; then AdamW
updates the local shards, the gradient norm that of the whole gradients
(``optimizer.sharded_global_norm``: the squares of each shard summed
over the axes that split it).  With ``pod_compression`` and a ``pod``
axis the step is the reference's ``per_pod``: the exact weighted mean
over ``data`` within a pod, then ``pod_compressed_mean`` over ``pod``
for each rank's shards (``ef`` in the opt state, kept as the rank's
shard, each pod its own residual; the scale the whole tensor's), the
loss and metrics averaged over ``pod``.  MoE's auxiliary losses are
nonlinear in the batch (the router's load statistics), so when the batch
is split the step puts ``moe_ffn``
under :func:`repro_torch.models.layers.moe_batch_stats`: the router's sums
are all-reduced over the split's axes (within a pod when pods compress),
and their backward scales this slice's share by ``1 / w`` so that the
weighted sum of the slices' gradients is the whole batch's.  No count is
read back to the host.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import fsdp
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import layers as L
from repro_torch.models.model import ModelApi, build_model, family_module
from repro_torch.training import optimizer as opt

TrainState = dict  # {"params": model, "opt": adamw state}

__all__ = ["TrainState", "batch_shardings", "load_work", "make_train_step",
           "shard_state", "state_shardings", "work_copy"]


def make_train_step(cfg: ArchConfig, api: Optional[ModelApi] = None, *,
                    adamw: Optional[opt.AdamWConfig] = None,
                    microbatches: int = 1, mesh=None):
    """``train_step(state, batch) -> (state, metrics)``.

    ``microbatches > 1`` cuts every batch tensor along dim 0 into that
    many slices, sums their gradients and divides, averages the loss and
    keeps the last slice's other metrics, as the reference's scan.
    Metrics are detached tensors: the loss's own (``nll`` and, for MoE,
    ``load_balance`` and ``router_z``), ``loss``, ``grad_norm``, ``lr``.
    With a mesh (``mesh`` or the active one) the step takes a sharded
    state and the global batch (the same on every rank) and returns the
    sharded state, every rank the same metrics."""
    api = api or build_model(cfg)
    adamw = adamw or opt.AdamWConfig()
    lr_fn = opt.cosine_schedule(adamw.lr, adamw.warmup, adamw.total_steps)

    def grad_fn(model, params, batch, seed):
        loss, metrics = api.loss(model, batch)
        grads = torch.autograd.grad(loss, params, grad_outputs=seed)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def compute_grads(model, batch, seed=None):
        """The loss, metrics and the gradients of ``seed`` (a scalar, by
        default 1) times the loss."""
        model.requires_grad_(True)
        names, params = zip(*model.named_parameters())
        if microbatches == 1:
            loss, metrics, grads = grad_fn(model, params, batch, seed)
            return loss, metrics, dict(zip(names, grads))
        b = next(iter(batch.values())).shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} is not a multiple of "
                             f"microbatches={microbatches}")
        mb = b // microbatches
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in params]
        loss_sum = torch.zeros((), device=params[0].device)
        for i in range(microbatches):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, metrics, grads = grad_fn(model, params, part, seed)
            for a, g in zip(acc, grads):
                a.add_(g)
            loss_sum = loss_sum + loss
        grads = {n: a / microbatches for n, a in zip(names, acc)}
        return loss_sum / microbatches, metrics, grads

    def train_step(state: TrainState, batch):
        model, ostate = state["params"], state["opt"]
        loss, metrics, grads = compute_grads(model, batch)
        model, ostate, om = opt.adamw_update(grads, ostate, model, adamw,
                                             lr_fn)
        metrics = dict(metrics, loss=loss, **om)
        return {"params": model, "opt": ostate}, metrics

    mesh_ = mesh or shd.current_mesh()
    if mesh_ is None:
        return train_step
    return _mesh_step(cfg, mesh_, compute_grads, adamw, lr_fn)


def _loss_tokens(batch) -> torch.Tensor:
    """The positions that carry loss in ``batch`` (the models' masked
    mean), an f32 scalar on the batch's device that is never read back:
    ``loss_mask``'s sum with ``labels``, else every position but the last
    of each sequence (``layers.shifted_labels``)."""
    if "labels" in batch:
        m = batch.get("loss_mask")
        if m is not None:
            return m.sum().to(torch.float32)
        n, dev = batch["labels"].numel(), batch["labels"].device
    else:
        B, S = batch["tokens"].shape
        n, dev = B * (S - 1), batch["tokens"].device
    return torch.tensor(float(n), device=dev)


class _BatchSum(torch.autograd.Function):
    """``x`` summed over the ranks of ``groups`` (one all-reduce a group).
    Its backward gives this rank's ``x`` the gradient times ``inv_w``: every
    rank takes the same sum into the same loss, and the mesh step weighs
    rank r's gradients by ``w_r``, so ``1 / w_r`` makes their weighted sum
    the gradient of the whole batch's loss."""

    @staticmethod
    def forward(ctx, x, groups, inv_w):
        import torch.distributed as dist

        ctx.save_for_backward(inv_w)
        y = x.detach().clone()
        for g in groups:
            dist.all_reduce(y, group=g)
        return y

    @staticmethod
    def backward(ctx, grad):
        (inv_w,) = ctx.saved_tensors
        return grad * inv_w, None, None


def _empty(cfg: ArchConfig, model: nn.Module, device) -> nn.Module:
    """An empty model of ``cfg``'s class, with ``model``'s learned position
    table's rows, on ``device`` (the parameters uninitialised)."""
    _, cls = family_module(cfg)
    pos = getattr(model, "pos", None)
    return cls(cfg, max_seq=0 if pos is None else pos.table.shape[0],
               device=device)


def work_copy(cfg: ArchConfig, model: nn.Module, mesh, *,
              blocks_sharded: bool = True) -> nn.Module:
    """The model a mesh step computes on for the sharded ``model``: its
    tensor-parallel local copy, ``requires_grad`` on.  Its block
    parameters are this rank's shards themselves, each block gathered
    over ``data`` in the layer loop (:func:`fsdp.local_copy`); with
    ``blocks_sharded=False`` (a serving replica, which keeps its weights
    across steps) every parameter is whole over every axis but ``model``
    (``tensor_parallel.local_copy``).  The other parameters are empty:
    :func:`load_work` fills them."""
    def make(dev):
        return _empty(cfg, model, dev)
    if blocks_sharded:
        return fsdp.local_copy(model, mesh, make)
    return tp.local_copy(model, mesh, make)


@torch.no_grad()
def load_work(cfg: ArchConfig, work: nn.Module, model: nn.Module,
              mesh) -> None:
    """Fill ``work`` (:func:`work_copy`) from the sharded ``model``: each
    parameter gathered over every mesh axis but ``model``, but the block
    parameters of a copy made with ``blocks_sharded``, which are pointed
    at the model's shards again (no copy)."""
    wp = dict(work.named_parameters())
    shards = fsdp.shard_names(work)
    for n, p in model.named_parameters():
        if n in shards:
            wp[n].data = p.to_local()
        else:
            wp[n].copy_(tp.local_of(p, mesh))


def _mesh_step(cfg, mesh, compute_grads, adamw, lr_fn):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    names = tuple(mesh.mesh_dim_names)
    use_pod = adamw.pod_compression and "pod" in names
    rules = shd.current_rules()
    batch_rule = shd._as_tuple(rules.resolve("batch", mesh))
    work = {}

    def split_axes(B: int) -> tuple:
        """The mesh axes that split the batch's dim 0, slowest first."""
        if use_pod:     # the reference's shard_map splits over pod first
            n_pod = shd._size(mesh, "pod")
            if B % n_pod:
                raise ValueError(f"batch {B} does not split over "
                                 f"{n_pod} pods")
            rest = tuple(a for a in batch_rule if a != "pod")
            return ("pod",) + (rest if rest and (B // n_pod)
                               % shd._axis_size(mesh, rest) == 0 else ())
        return shd._as_tuple(shd._spec_for_shape(
            ("batch",), (B,), mesh, rules)[0])

    def local_batch(batch, axes):
        return {k: shd.local_slice(v, mesh, (axes or None,)
                                   + (None,) * (v.ndim - 1))
                for k, v in batch.items()}

    def sum_over(tensors, axes):
        """Each of ``tensors`` summed in place over the ranks of ``axes``
        (one all-reduce an axis, in mesh order)."""
        for a in axes:
            for t in tensors:
                dist.all_reduce(t, group=mesh.get_group(a))
        return tensors

    def weighted_sum(tensors, w, axes):
        """Each of ``tensors`` times ``w`` in place, summed over the ranks
        of ``axes``."""
        for t in tensors:
            t.mul_(w)
        return sum_over(tensors, axes)

    def reduce_grads(grads, data_axes):
        """The gradients of the weighted loss summed over ``data_axes``:
        a block gradient arrives summed over the axes that split its
        weight (its shard, ``fsdp.scatter_block``), so it is summed over
        the rest of ``data_axes`` only, and divided by the ranks of its
        axes that do not split the batch (they computed the same slice);
        every other gradient is summed over all of ``data_axes``."""
        for n, g in grads.items():
            got = work["fsdp"].get(n, ())
            sum_over([g], tuple(a for a in data_axes if a not in got))
            same = shd._axis_size(mesh, tuple(a for a in got
                                              if a not in data_axes))
            if same > 1:
                g.div_(same)

    def shard_of(n, g, p):
        """This rank's shard of the gradient ``g`` of the work copy's
        parameter ``n`` for the sharded ``p``: a block gradient is one
        already."""
        if n in work["blocks"]:
            return g
        return shd.local_slice(g, mesh, tp.without_model(shd.spec_of(p)))

    def train_step(state: TrainState, batch):
        model, ostate = state["params"], state["opt"]
        if not isinstance(next(model.parameters()), DTensor):
            raise ValueError("a mesh step takes a sharded state: lay it out "
                             "with shard_state(state, state_shardings(...))")
        if work.get("src") is not model:
            work["src"], work["model"] = model, work_copy(cfg, model, mesh)
            specs = {n: shd.spec_of(p) for n, p in model.named_parameters()}
            work["blocks"] = fsdp.shard_names(work["model"])
            # the axes each block gradient arrives summed over
            work["fsdp"] = {n: fsdp.split_axes(specs[n], mesh)
                            for n in work["blocks"]}
            if use_pod and any("pod" in a for a in work["fsdp"].values()):
                raise NotImplementedError(
                    "a block weight split over pod under pod compression")
            # the axes whose ranks hold slices of each gradient's shard
            work["split"] = {
                n: a for n, a in ((n, tuple(
                    x for x in names if shd._size(mesh, x) > 1 and any(
                        x in shd._as_tuple(r) for r in spec)))
                    for n, spec in specs.items()) if a}
        load_work(cfg, work["model"], model, mesh)
        axes = split_axes(next(iter(batch.values())).shape[0])
        part = local_batch(batch, axes)
        # the reference's global mean: each slice weighted by its loss
        # tokens; within a pod only over data when pods compress
        data_axes = tuple(a for a in axes if not (use_pod and a == "pod"))
        n_loc = _loss_tokens(part)
        (n_all,) = sum_over([n_loc.clone()], data_axes)
        w = n_loc / n_all
        n_slices = shd._axis_size(mesh, data_axes)
        moe = contextlib.nullcontext()
        if cfg.moe and n_slices > 1:
            groups = [mesh.get_group(a) for a in data_axes]
            moe = L.moe_batch_stats(
                lambda t: _BatchSum.apply(t, groups, 1.0 / w), n_slices)
        # the gradients of w times the loss: the block gradients are
        # summed over data in the backward, each slice already weighted
        with moe, tp.activate(mesh):
            loss, metrics, grads = compute_grads(work["model"], part, w)
        keys = list(metrics)
        vals = weighted_sum([loss.clone()]
                            + [metrics[k].clone() for k in keys], w,
                            data_axes)
        loss, metrics = vals[0], dict(zip(keys, vals[1:]))
        reduce_grads(grads, data_axes)
        shards = {n: shard_of(n, grads[n], p)
                  for n, p in model.named_parameters()}
        del grads
        if use_pod:
            shards, ef = opt.pod_compressed_mean(
                shards, {n: e.to_local() for n, e in ostate["ef"].items()},
                "pod", mesh, split=work["split"])
            with torch.no_grad():
                for n, e in ostate["ef"].items():
                    e.to_local().copy_(ef[n])
            n_pod = shd._size(mesh, "pod")
            vals = weighted_sum([loss] + [metrics[k] for k in keys], 1.0,
                                ("pod",))
            loss = vals[0] / n_pod
            metrics = {k: v / n_pod for k, v in zip(keys, vals[1:])}
        gnorm = opt.sharded_global_norm(shards, work["split"], mesh)
        params = {n: p.to_local() for n, p in model.named_parameters()}
        local = {"step": ostate["step"],
                 "mu": {n: m.to_local() for n, m in ostate["mu"].items()},
                 "nu": {n: v.to_local() for n, v in ostate["nu"].items()}}
        local, om = opt.adamw_apply(shards, local, params,
                                    opt.decay_mask(model), gnorm, adamw,
                                    lr_fn)
        ostate = dict(ostate, step=local["step"])
        metrics = dict(metrics, loss=loss, **om)
        return {"params": model, "opt": ostate}, metrics

    train_step.work = work      # the rank's work copy, for inspection
    return train_step


# ------------------------------------------------------- sharding helpers --
def _shapes(params_shapes) -> dict:
    if isinstance(params_shapes, nn.Module):
        return dict(params_shapes.named_parameters())
    return params_shapes


def state_shardings(cfg: ArchConfig, axes, mesh, params_shapes,
                    adamw: Optional[opt.AdamWConfig] = None):
    """:class:`NamedSharding`s for ``{"params", "opt"}`` from the
    parameters' logical axes (``interop.param_axes``) and shapes (a model,
    or a dict of tensors keyed by parameter name): the moments (and
    ``ef``) as their parameters, the step replicated."""
    adamw = adamw or opt.AdamWConfig()
    p_sh = shd.param_shardings(axes, mesh, shapes=_shapes(params_shapes))
    rep = shd.NamedSharding(mesh, ())
    o_sh = {"step": rep, "mu": p_sh, "nu": p_sh}
    if adamw.pod_compression:
        o_sh["ef"] = p_sh
    return {"params": p_sh, "opt": o_sh}


def batch_shardings(batch_specs, mesh):
    """Shard every batch tensor's dim 0 over (pod, data), where they divide
    it."""
    def one(spec):
        axes = ["batch"] + [None] * (len(spec.shape) - 1)
        return shd.NamedSharding(
            mesh, shd._spec_for_shape(axes, spec.shape, mesh,
                                      shd.current_rules()))
    return {k: one(v) for k, v in batch_specs.items()}


@torch.no_grad()
def shard_state(state: TrainState, shardings) -> TrainState:
    """The plain training state (the same on every rank) laid out as
    ``shardings`` (:func:`state_shardings`) says: the model's parameters
    and the moments become DTensors holding this rank's slices (the model
    changed in place), the step stays a plain tensor.  Sends nothing."""
    model = state["params"]
    for name, p in list(model.named_parameters()):
        mod, _, leaf = name.rpartition(".")
        owner = model.get_submodule(mod) if mod else model
        setattr(owner, leaf, nn.Parameter(
            shd.shard(p.detach(), shardings["params"][name]),
            requires_grad=p.requires_grad))
    ostate = dict(state["opt"])
    for key in ("mu", "nu", "ef"):
        if key in ostate:
            ostate[key] = {n: shd.shard(t, shardings["opt"][key][n])
                           for n, t in ostate[key].items()}
    return {"params": model, "opt": ostate}
