"""AdamW with gradient clipping, a weight-decay mask and a cosine schedule,
and int8 quantisation for the error-feedback gradient compression.

Port of ``repro.training.optimizer``: ``cosine_schedule``, ``global_norm``,
``AdamWConfig``, ``adamw_init`` (with ``ef`` under ``pod_compression``),
``quantize_int8`` and ``adamw_update``.  Parameters are a model's
(``nn.Module``); gradients and the moments ``mu``, ``nu`` (and ``ef``)
are dicts of f32 tensors keyed by its parameter names.  ``adamw_update``
updates the parameters and the moments in place (the reference returns new
trees), which keeps one copy of each on the card.

The decay mask is the reference's ``ndim >= 2`` taken on the reference's
leaves: its transformer and hymba blocks are stacked on a leading layer
axis, so every norm scale and bias inside a block is decayed there, while
``ln_f`` and xLSTM's per-layer blocks' 1-D leaves are not
(:func:`repro_torch.interop.reference_ndim`).

``sharded_global_norm`` is the norm of a tensor-parallel step's
gradients, some of them slices.  ``pod_compressed_mean`` is the cross-pod
gradient mean of the
pod-compressed train step: int8 values with one shared f32 scale a tensor
on the wire, summed exactly in int32 over the ``pod`` axis of a mesh, and
an error-feedback residual that carries each pod's quantisation error into
its next step.  ``adamw_apply`` is the update on given tensors (a sharded
step's local shards) with the gradient norm given.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.interop import reference_ndim

__all__ = ["AdamWConfig", "adamw_apply", "adamw_init", "adamw_update",
           "cosine_schedule", "decay_mask", "global_norm",
           "pod_compressed_mean", "quantize_int8", "sharded_global_norm"]


# --------------------------------------------------------------- schedule ---
def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable:
    """step (an int tensor) -> the f32 learning rate: linear warm-up over
    ``warmup`` steps, then a cosine from ``base_lr`` down to ``min_frac``
    of it at ``total``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def global_norm(tensors) -> torch.Tensor:
    """The f32 L2 norm of all of ``tensors`` (an iterable) together."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


def sharded_global_norm(grads: dict, split, group) -> torch.Tensor:
    """:func:`global_norm` of gradients of which those named in ``split``
    are this rank's slices of tensors split over the ranks of ``group``
    (a tensor-parallel step's): their squares summed over the group, the
    others (whole and the same on every rank) counted once.  With nothing
    split it is :func:`global_norm` itself."""
    import torch.distributed as dist

    if not split:
        return global_norm(grads.values())
    sq = sum(torch.sum(torch.square(g.float()))
             for n, g in grads.items() if n in split)
    dist.all_reduce(sq, group=group)
    return torch.sqrt(sq + sum(torch.sum(torch.square(g.float()))
                               for n, g in grads.items() if n not in split))


# ------------------------------------------------------------------ adamw ---
@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100
    total_steps: int = 10_000
    # int8 error-feedback compression of the cross-pod reduction
    pod_compression: bool = False


def decay_mask(model: nn.Module) -> dict:
    """Parameter name -> whether weight decay applies: the reference's
    leaf has two or more dimensions (norm scales and biases excluded)."""
    return {name: nd >= 2 for name, nd in reference_ndim(model).items()}


def adamw_init(model: nn.Module, cfg: AdamWConfig) -> dict:
    """``step`` (int32 0) and f32 zero moments ``mu``, ``nu`` (and ``ef``
    under ``pod_compression``) keyed by parameter name, on the model's
    device."""
    def zeros():
        return {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in model.named_parameters()}
    dev = next(model.parameters()).device
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
             "mu": zeros(), "nu": zeros()}
    if cfg.pod_compression:
        state["ef"] = zeros()      # error-feedback residual
    return state


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8: (q, scale) with scale = max|x| / 127
    (at least 1e-12 / 127) and q = round(x / scale) clipped to +-127."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def pod_compressed_mean(grads: dict, ef: dict, axis: str = "pod",
                        mesh=None, split=frozenset()):
    """int8 error-feedback mean over the ``axis`` ranks of ``mesh``
    (default: the active mesh).  ``grads`` and ``ef`` are dicts of tensors
    keyed alike (the gradient and residual of this rank's pod); returns
    ``(mean, ef')`` keyed the same, each tensor of ``mean`` equal on every
    rank of the axis.  Per tensor, in the reference's order: ``gf = g + e``
    in f32; ``scale`` the largest of the ranks' ``max(|gf|, 1e-12) / 127``
    (an all-reduce MAX); ``q = round(gf / scale)`` (half to even) clipped
    to +-127 as int8; ``q_sum`` its int32 SUM; ``mean = q_sum * scale / n``
    in the gradient's dtype; ``e' = gf - q * scale``.  The tensors named
    in ``split`` are this rank's slices of tensors split over the mesh's
    ``model`` axis (a tensor-parallel step's), whose scale is the whole
    tensor's: its max is also taken over ``model``."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import current_mesh

    mesh = mesh or current_mesh()
    group = mesh.get_group(axis)
    n = torch.tensor(float(dist.get_world_size(group)))
    mean, ef2 = {}, {}
    for name, g in grads.items():
        gf = g.float() + ef[name]
        # shared scale: one tiny max-reduce, then exact int32 accumulation
        scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        if name in split:
            dist.all_reduce(scale, op=dist.ReduceOp.MAX,
                            group=mesh.get_group("model"))
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        # wire bytes: int8 payload (+ one f32 scale per tensor); gloo and
        # NCCL sum in int32 here, which the int8 range cannot overflow
        q_sum = q.to(torch.int32)
        dist.all_reduce(q_sum, group=group)
        mean[name] = (q_sum.float() * scale / n.to(scale.device)).to(g.dtype)
        ef2[name] = gf - q.float() * scale
    return mean, ef2


@torch.no_grad()
def adamw_update(grads: dict, state: dict, model: nn.Module,
                 cfg: AdamWConfig, lr_fn: Optional[Callable] = None):
    """One AdamW step: the gradients clipped to ``clip_norm`` by their
    global norm, the moments and the bias-corrected update in f32, decay
    on the masked parameters.  Updates ``model``'s parameters and the
    moments in place; returns ``(model, state', metrics)`` with
    ``grad_norm`` and ``lr``."""
    state, metrics = adamw_apply(
        grads, state, dict(model.named_parameters()), decay_mask(model),
        global_norm(grads.values()), cfg, lr_fn)
    return model, state, metrics


@torch.no_grad()
def adamw_apply(grads: dict, state: dict, params: dict, mask: dict,
                gnorm: torch.Tensor, cfg: AdamWConfig,
                lr_fn: Optional[Callable] = None):
    """:func:`adamw_update`'s arithmetic on the tensors of ``params``
    (name -> tensor, updated in place) with the gradient norm ``gnorm``
    given: a sharded step passes each rank's local shards of the
    parameters, gradients and moments, and the norm of the whole
    gradients.  Returns ``(state', metrics)``."""
    lr_fn = lr_fn or cosine_schedule(cfg.lr, cfg.warmup, cfg.total_steps)
    step = state["step"] + 1
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    t = step.float()
    mu_hat_scale = 1.0 / (1 - torch.pow(b1, t))
    nu_hat_scale = 1.0 / (1 - torch.pow(b2, t))
    lr = lr_fn(step)
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = state["mu"][name], state["nu"][name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + cfg.eps)
        if cfg.weight_decay:
            u = u + (cfg.weight_decay if mask[name] else 0.0) * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    new_state = dict(state)
    new_state["step"] = step
    return new_state, {"grad_norm": gnorm, "lr": lr}
