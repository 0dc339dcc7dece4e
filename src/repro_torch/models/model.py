"""Model dispatcher: one API over the ported architecture families.

Port of ``repro.models.model`` for the transformer family; the SSM
(xLSTM) and hybrid (Hymba) families raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    device: torch.device
    init: Callable               # (seed) -> model with random weights
    forward: Callable            # (model, batch) -> (logits, aux)
    init_decode_cache: Callable  # (B, max_seq) -> cache
    decode_step: Callable        # (model, cache, tokens) -> (logits, cache)


def build_model(cfg: ArchConfig, device=None) -> ModelApi:
    """The model API on ``device`` (CUDA unless the caller asks for
    another)."""
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"the {cfg.family} family is not ported to repro_torch yet "
            "(ROADMAP.md §1 step 8)")
    transformer.check_supported(cfg)
    dev = resolve_device(device)

    def init(seed: int = 0) -> transformer.TransformerLM:
        model = transformer.TransformerLM(cfg, device=dev)
        L.init_random_(model, torch.Generator(device=dev).manual_seed(seed))
        return model

    return ModelApi(
        cfg=cfg, device=dev, init=init,
        forward=lambda m, b: transformer.forward(cfg, m, b),
        init_decode_cache=lambda B, max_seq: transformer.init_decode_cache(
            cfg, B, max_seq, dev),
        decode_step=lambda m, c, t: transformer.decode_step(cfg, m, c, t),
    )


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
