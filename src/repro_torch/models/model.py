"""Model dispatcher: one API over every architecture family.

Port of ``repro.models.model``: the transformer families (dense, MoE, VLM,
audio), the hybrid family (Hymba, :mod:`repro_torch.models.hymba`) and the
SSM family (xLSTM, :mod:`repro_torch.models.xlstm`), and the parameter
and FLOP counts (``active_params``, ``total_params``,
``model_flops_per_token``).  Parameters are made with
``requires_grad=False``; training turns them on for its own model.
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
    loss: Callable               # (model, batch) -> (loss, metrics)
    init_decode_cache: Callable  # (B, max_seq) -> cache
    decode_step: Callable        # (model, cache, tokens) -> (logits, cache)
    prime: Optional[Callable] = None  # (model, cache) -> cache: hymba's
    #                                   meta tokens before any prompt


def family_module(cfg: ArchConfig):
    """The module that implements ``cfg``'s family, and its model class
    (hymba's paged decode shares the transformer's, ``flash_decode_shards``
    included)."""
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
        loss=lambda m, b: mod.loss_fn(cfg, m, b),
        init_decode_cache=lambda B, max_seq: mod.init_decode_cache(
            cfg, B, max_seq, dev),
        decode_step=lambda m, c, t: mod.decode_step(cfg, m, c, t),
        prime=prime,
    )


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def model_flops_per_token(cfg: ArchConfig, seq_len: int):
    """(N_active, attention FLOPs a token), as the reference: the caller
    takes 6 N_active (training) or 2 N_active (a forward) plus the
    attention term, 2 * 2 * (S_eff / 2) * H * hd a layer (q k^T and p v
    over half the visible context, causal on average)."""
    n = active_params(cfg)
    attn = 0.0
    if cfg.family not in ("ssm",):
        for w in cfg.layer_windows(seq_len):
            s_eff = min(w, seq_len) if w < (1 << 29) else seq_len
            attn += 2 * 2 * (s_eff / 2) * cfg.n_heads * cfg.hd
    return n, attn


def active_params(cfg: ArchConfig) -> float:
    """Parameters touched per token (MoE counts its top_k experts only),
    the reference's count."""
    D, F, V, L_ = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    hd = cfg.hd
    if cfg.family == "ssm":
        inner = int(cfg.proj_factor * D)
        per_m = 2 * D * inner + 3 * inner * 4 + inner * 2 * cfg.n_heads \
            + inner * D
        per_s = 4 * D * inner + 4 * (inner // cfg.n_heads) * inner \
            + inner * D
        n_s = sum(1 for i in range(L_)
                  if cfg.slstm_every and i % cfg.slstm_every
                  == cfg.slstm_every - 1)
        return float((L_ - n_s) * per_m + n_s * per_s + V * D * 2)
    attn = D * cfg.n_heads * hd + 2 * D * cfg.n_kv_heads * hd \
        + cfg.n_heads * hd * D
    if cfg.moe:
        ffn = cfg.top_k * 3 * D * F + D * cfg.n_experts
    elif cfg.gated_mlp:
        ffn = 3 * D * F
    else:
        ffn = 2 * D * F
    per_layer = attn + ffn
    if cfg.family == "hybrid":
        d_inner = 2 * D
        per_layer += 2 * D * d_inner + d_inner * (
            2 * cfg.ssm_state + d_inner) + d_inner * D
    if cfg.enc_dec:
        per_layer += attn  # cross attention
    n = L_ * per_layer
    if cfg.enc_dec:
        enc_ffn = 2 * D * F if not cfg.gated_mlp else 3 * D * F
        n += cfg.n_enc_layers * (attn + enc_ffn)
    n += V * D * (1 if cfg.tie_embeddings else 2)
    return float(n)


def total_params(cfg: ArchConfig) -> float:
    """Every parameter (MoE: all experts), the reference's count."""
    if not cfg.moe:
        return active_params(cfg)
    extra = (cfg.n_experts - cfg.top_k) * 3 * cfg.d_model * cfg.d_ff \
        * cfg.n_layers
    return active_params(cfg) + extra
