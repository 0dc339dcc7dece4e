"""Model dispatcher: one API over every architecture family.

Port of ``repro.models.model``: the transformer families (dense, MoE, VLM,
audio), the hybrid family (Hymba, :mod:`repro_torch.models.hymba`) and the
SSM family (xLSTM, :mod:`repro_torch.models.xlstm`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import hymba, transformer, xlstm
from repro_torch.models import layers as L
from repro_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    device: torch.device
    init: Callable               # (seed, max_seq=0) -> model, random weights
    forward: Callable            # (model, batch) -> (logits, aux)
    init_decode_cache: Callable  # (B, max_seq) -> cache
    decode_step: Callable        # (model, cache, tokens) -> (logits, cache)
    prime: Optional[Callable] = None  # (model, cache) -> cache: hymba's
    #                                   meta tokens before any prompt


def family_module(cfg: ArchConfig):
    """The module that implements ``cfg``'s family, and its model class;
    raises for what is not ported (hymba's paged decode shares the
    transformer's, ``flash_decode_shards`` included)."""
    if cfg.family == "ssm":
        return xlstm, xlstm.XLSTMLM
    if cfg.family == "hybrid":
        transformer.check_supported(cfg, ("hybrid",))
        return hymba, hymba.HymbaLM
    transformer.check_supported(cfg)
    return transformer, transformer.TransformerLM


def build_model(cfg: ArchConfig, device=None) -> ModelApi:
    """The model API on ``device`` (CUDA unless the caller asks for
    another)."""
    mod, cls = family_module(cfg)
    dev = resolve_device(device)

    def init(seed: int = 0, max_seq: int = 0) -> nn.Module:
        """Random weights from ``seed``; ``max_seq`` sizes a learned
        position table (at least 1024 rows), as the reference's init."""
        model = cls(cfg, max_seq=max_seq, device=dev)
        L.init_random_(model, torch.Generator(device=dev).manual_seed(seed))
        return model

    prime = None
    if cfg.family == "hybrid" and cfg.n_meta_tokens:
        prime = lambda m, c: hymba.prime_cache(cfg, m, c)   # noqa: E731
    return ModelApi(
        cfg=cfg, device=dev, init=init,
        forward=lambda m, b: mod.forward(cfg, m, b),
        init_decode_cache=lambda B, max_seq: mod.init_decode_cache(
            cfg, B, max_seq, dev),
        decode_step=lambda m, c, t: mod.decode_step(cfg, m, c, t),
        prime=prime,
    )


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
