"""The train step: loss and gradients -> AdamW, with microbatch gradient
accumulation.

Port of ``repro.training.train_loop.make_train_step``'s plain step.  The
state is ``{"params": model, "opt": adamw state}``; the step turns on
``requires_grad`` for the model's parameters (they are made without it),
takes the gradients with ``torch.autograd.grad`` and updates the model and
the moments in place (``optimizer.adamw_update``).

Not ported here (ROADMAP.md §1, the ``distributed/`` slice): a mesh, the
pod-compressed step (``pod_compressed_mean`` over a ``pod`` axis),
``state_shardings`` and ``batch_shardings``.  With no mesh the reference
takes the plain step whatever ``pod_compression`` says, and so does the
port; a mesh raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import ModelApi, build_model
from repro_torch.training import optimizer as opt

TrainState = dict  # {"params": model, "opt": adamw state}


def make_train_step(cfg: ArchConfig, api: Optional[ModelApi] = None, *,
                    adamw: Optional[opt.AdamWConfig] = None,
                    microbatches: int = 1, mesh=None):
    """``train_step(state, batch) -> (state, metrics)``.

    ``microbatches > 1`` cuts every batch tensor along dim 0 into that
    many slices, sums their gradients and divides, averages the loss and
    keeps the last slice's other metrics, as the reference's scan.
    Metrics are detached tensors: the loss's own (``nll`` and, for MoE,
    ``load_balance`` and ``router_z``), ``loss``, ``grad_norm``, ``lr``."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step with a mesh (pod-compressed reduction, "
            "state and batch shardings) waits for the distributed/ slice "
            "(ROADMAP.md §1)")
    api = api or build_model(cfg)
    adamw = adamw or opt.AdamWConfig()
    lr_fn = opt.cosine_schedule(adamw.lr, adamw.warmup, adamw.total_steps)

    def grad_fn(model, params, batch):
        loss, metrics = api.loss(model, batch)
        grads = torch.autograd.grad(loss, params)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def compute_grads(model, batch):
        model.requires_grad_(True)
        names, params = zip(*model.named_parameters())
        if microbatches == 1:
            loss, metrics, grads = grad_fn(model, params, batch)
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
            loss, metrics, grads = grad_fn(model, params, part)
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

    return train_step
