"""Layer library: dense projections, norms, RoPE, GQA attention, MLP,
embedding and the logits head.

Port of ``repro.models.layers`` (``dense``, ``norm_apply``,
``rms_norm_simple``, ``rope``, ``attention_qkv``, ``attention``, ``mlp``,
``embed``, ``logits_head``).  Parameters live in ``nn.Module``s that keep
the reference's layouts, so a weight carries across untransposed: a dense
weight is ``(in, out)`` and applies as ``x @ w``.

Parameters are stored in the compute dtype.  The reference keeps float32
master weights and casts them at use (``dense`` casts ``w`` to the compute
dtype before the product); storing the cast weight gives the same numbers,
because the product sees the same rounded values either way, and halves
the weights' memory in bf16.  Attention goes through
:mod:`repro_torch.kernels.ops`: the CUDA flash kernel for tensors on the
card, its plain version on the CPU.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Dense(nn.Module):
    """``w`` (in, out) and an optional bias ``b`` (out,)."""

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = False,
                 dtype=None, device=None):
        super().__init__()
        self.w = _param((in_dim, out_dim), dtype, device)
        self.b = _param((out_dim,), dtype, device) if bias else None


class Norm(nn.Module):
    """RMS norm (``scale``) or layer norm (``scale`` and ``bias``)."""

    def __init__(self, cfg: ArchConfig, dim: int, *, dtype=None,
                 device=None):
        super().__init__()
        self.scale = _param((dim,), dtype, device)
        self.bias = (_param((dim,), dtype, device) if cfg.norm == "layer"
                     else None)


class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype=None, device=None):
        super().__init__()
        hd, kw = cfg.hd, dict(dtype=dtype, device=device)
        self.wq = Dense(cfg.d_model, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wk = Dense(cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                        **kw)
        self.wv = Dense(cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                        **kw)
        self.wo = Dense(cfg.n_heads * hd, cfg.d_model, **kw)
        self.q_norm = _param((hd,), dtype, device) if cfg.qk_norm else None
        self.k_norm = _param((hd,), dtype, device) if cfg.qk_norm else None


class MLP(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.w1 = Dense(cfg.d_model, cfg.d_ff, **kw)
        self.w2 = Dense(cfg.d_ff, cfg.d_model, **kw)
        self.w3 = Dense(cfg.d_model, cfg.d_ff, **kw) if cfg.gated_mlp else None


class Embedding(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype=None, device=None):
        super().__init__()
        self.table = _param((cfg.vocab, cfg.d_model), dtype, device)


@torch.no_grad()
def init_random_(module: nn.Module, gen: torch.Generator) -> None:
    """The reference's initialisation, drawn from ``gen``: dense weights
    normal with scale 1/sqrt(in), embedding tables standard normal, biases
    zero, norm scales one (norm biases zero)."""
    for m in module.modules():
        if isinstance(m, Dense):
            m.w.normal_(0.0, 1.0 / math.sqrt(m.w.shape[0]), generator=gen)
            if m.b is not None:
                m.b.zero_()
        elif isinstance(m, Embedding):
            m.table.normal_(0.0, 1.0, generator=gen)
        elif isinstance(m, Norm):
            m.scale.fill_(1.0)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, Attention) and m.q_norm is not None:
            m.q_norm.fill_(1.0)
            m.k_norm.fill_(1.0)


# ---------------------------------------------------------------- apply ---
def dense(p: Dense, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    y = x.to(dtype) @ p.w.to(dtype)
    if p.b is not None:
        y = y + p.b.to(dtype)
    return y


def norm_apply(cfg: ArchConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layer":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
        y = y * p.scale.float() + p.bias.float()
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * p.scale.float()
    return y.to(x.dtype)


def rms_norm_simple(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, D), D even; positions (S,) or broadcastable.  Rotates the
    two halves of each vector (not interleaved pairs), as the reference."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


def attention_qkv(cfg: ArchConfig, p: Attention, x: torch.Tensor,
                  positions: torch.Tensor, dtype: torch.dtype):
    """Project to (B, H, S, hd) q and (B, Hkv, S, hd) k, v with RoPE."""
    B, S, _ = x.shape
    hd = cfg.hd
    q = dense(p.wq, x, dtype).reshape(B, S, cfg.n_heads, hd)
    k = dense(p.wk, x, dtype).reshape(B, S, cfg.n_kv_heads, hd)
    v = dense(p.wv, x, dtype).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm_simple(q, p.q_norm)
        k = rms_norm_simple(k, p.k_norm)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if cfg.pos_emb == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(cfg: ArchConfig, p: Attention, x: torch.Tensor, *,
              window: int | None = None, positions=None,
              causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (prefill). x: (B, S, D); ``window`` a Python
    int or None (global)."""
    B, S, _ = x.shape
    dtype = cfg.compute_dtype
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = attention_qkv(cfg, p, x, positions, dtype)
    o = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal, window=window)
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.hd)
    return dense(p.wo, o, dtype)


def _act(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if cfg.act == "gelu" else F.silu(x)


def mlp(cfg: ArchConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    dtype = cfg.compute_dtype
    h = dense(p.w1, x, dtype)
    if cfg.gated_mlp:
        h = _act(cfg, h) * dense(p.w3, x, dtype)
    else:
        h = _act(cfg, h)
    return dense(p.w2, h, dtype)


def embed(cfg: ArchConfig, p: Embedding, tokens: torch.Tensor
          ) -> torch.Tensor:
    e = p.table[tokens.long()].to(cfg.compute_dtype)
    if cfg.name.startswith("gemma"):
        e = e * math.sqrt(cfg.d_model)
    return e


def logits_head(cfg: ArchConfig, head: Dense | None, embed_p: Embedding,
                x: torch.Tensor) -> torch.Tensor:
    dtype = cfg.compute_dtype
    if cfg.tie_embeddings:
        out = x @ embed_p.table.to(dtype).T
    else:
        out = x @ head.w.to(dtype)
    if cfg.logit_softcap:
        out = torch.tanh(out / cfg.logit_softcap) * cfg.logit_softcap
    return out
