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

``pod_compressed_mean`` (the int8 reduction over a ``pod`` mesh axis) waits
for ``distributed/`` (ROADMAP.md §1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.interop import reference_ndim

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "decay_mask", "global_norm", "quantize_int8"]


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
def adamw_update(grads: dict, state: dict, model: nn.Module,
                 cfg: AdamWConfig, lr_fn: Optional[Callable] = None):
    """One AdamW step: the gradients clipped to ``clip_norm`` by their
    global norm, the moments and the bias-corrected update in f32, decay
    on the masked parameters.  Updates ``model``'s parameters and the
    moments in place; returns ``(model, state', metrics)`` with
    ``grad_norm`` and ``lr``."""
    lr_fn = lr_fn or cosine_schedule(cfg.lr, cfg.warmup, cfg.total_steps)
    step = state["step"] + 1
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    t = step.float()
    mu_hat_scale = 1.0 / (1 - torch.pow(b1, t))
    nu_hat_scale = 1.0 / (1 - torch.pow(b2, t))
    lr = lr_fn(step)
    mask = decay_mask(model)
    for name, p in model.named_parameters():
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
    return model, new_state, {"grad_norm": gnorm, "lr": lr}
