"""Layer library: dense projections, norms, RoPE, GQA attention, MLP, MoE,
embedding, learned positions and the logits head.

Port of ``repro.models.layers`` (``dense``, ``norm_apply``,
``rms_norm_simple``, ``rope``, ``attention_qkv``, ``attention``, ``mlp``,
``moe_ffn``, ``embed``, ``logits_head``, ``cross_entropy`` and the chunked
``lm_loss_from_hidden``).  Parameters live in
``nn.Module``s that keep the reference's layouts, so a weight carries
across untransposed: a dense weight is ``(in, out)`` and applies as
``x @ w``.

Parameters are stored in the compute dtype.  The reference keeps float32
master weights and casts them at use (``dense`` casts ``w`` to the compute
dtype before the product); storing the cast weight gives the same numbers,
because the product sees the same rounded values either way, and halves
the weights' memory in bf16.  Attention goes through
:mod:`repro_torch.kernels.ops`: the CUDA flash kernel for tensors on the
card, its plain version on the CPU.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.utils import segment_rank


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


class MoE(nn.Module):
    """Router ``(D, E)`` and expert weights ``w1``, ``w3`` ``(E, D, F)`` and
    ``w2`` ``(E, F, D)``, the reference's layouts."""

    def __init__(self, cfg: ArchConfig, *, dtype=None, device=None):
        super().__init__()
        E, D, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = _param((D, E), dtype, device)
        self.w1 = _param((E, D, F_), dtype, device)
        self.w2 = _param((E, F_, D), dtype, device)
        self.w3 = _param((E, D, F_), dtype, device)


class Embedding(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype=None, device=None):
        super().__init__()
        self.table = _param((cfg.vocab, cfg.d_model), dtype, device)


class LearnedPositions(nn.Module):
    """A learned position table ``(rows, D)``."""

    def __init__(self, rows: int, dim: int, *, dtype=None, device=None):
        super().__init__()
        self.table = _param((rows, dim), dtype, device)


@torch.no_grad()
def init_random_(module: nn.Module, gen: torch.Generator) -> None:
    """The reference's initialisation, drawn from ``gen``: dense weights
    and the MoE router and experts normal with scale 1/sqrt(in), embedding
    tables standard normal, learned positions normal with scale 0.02,
    biases zero, norm scales one (norm biases zero).  A module that holds
    parameters of its own outside these classes (hymba's Mamba path, norms
    and meta tokens, the xLSTM blocks' ``wq``/``wk``/``wv``, ``hn`` and
    ``r``) fills them with the reference's values in its
    ``reset_random_(gen)``."""
    for m in module.modules():
        reset = getattr(m, "reset_random_", None)
        if reset is not None:
            reset(gen)
        if isinstance(m, Dense):
            m.w.normal_(0.0, 1.0 / math.sqrt(m.w.shape[0]), generator=gen)
            if m.b is not None:
                m.b.zero_()
        elif isinstance(m, MoE):
            for w in (m.router, m.w1, m.w2, m.w3):
                w.normal_(0.0, 1.0 / math.sqrt(w.shape[-2]), generator=gen)
        elif isinstance(m, Embedding):
            m.table.normal_(0.0, 1.0, generator=gen)
        elif isinstance(m, LearnedPositions):
            m.table.normal_(0.0, 0.02, generator=gen)
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


def _top_k(probs: torch.Tensor, k: int):
    """The k largest of the last axis, largest first, ties to the lower
    index (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    v, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


class _MoeBatch(threading.local):
    batch_sum = None     # local sum -> the sum over the batch's slices
    n_slices = 1


_MOE_BATCH = _MoeBatch()


@contextlib.contextmanager
def moe_batch_stats(batch_sum, n_slices: int):
    """Within it, :func:`moe_ffn`'s aux losses take the router statistics
    of a batch split into ``n_slices`` equal slices, one a rank (a mesh
    step's data parallelism): ``batch_sum(t)`` returns the sum of ``t``
    over the slices, the same on every rank, with the gradient a step needs
    (``train_loop``'s mesh step passes its all-reduce).  The load balance
    ``E * sum(me * ce)`` and the router z-loss are then those of the whole
    batch, ``me``, ``ce`` and the z-loss's mean taken over all its
    tokens."""
    prev = (_MOE_BATCH.batch_sum, _MOE_BATCH.n_slices)
    _MOE_BATCH.batch_sum, _MOE_BATCH.n_slices = batch_sum, n_slices
    try:
        yield
    finally:
        _MOE_BATCH.batch_sum, _MOE_BATCH.n_slices = prev


def moe_ffn(cfg: ArchConfig, p: MoE, x: torch.Tensor, *,
            capacity_factor: float | None = None):
    """Scatter-based top-k MoE with per-sequence dispatch, as the reference.

    Each sequence ranks its (token, expert) choices per expert in token
    order (``segment_rank``) and keeps those ranked below the capacity
    ``C``; a kept choice goes to row ``e * C + rank`` of a
    ``(B, E * C + 1, D)`` buffer, a dropped one to the trash row ``E * C``
    (whose duplicate writes are discarded).  x: (B, S, D) -> (B, S, D) and
    the aux dict: the reference's ``load_balance`` and ``router_z``, and
    ``dropped``, the number of choices past capacity (a float count; the
    reference does not return it).  Under :func:`moe_batch_stats` the
    load balance and z-loss are the whole batch's; ``dropped`` stays this
    slice's."""
    B, S, D = x.shape
    dtype = cfg.compute_dtype
    E, K = cfg.n_experts, cfg.top_k
    cf = capacity_factor or cfg.capacity_factor
    C = max(8, int(math.ceil(S * K * cf / E / 8.0)) * 8)  # per-seq capacity

    logits = x.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)                   # (B, S, E)
    topv, topi = _top_k(probs, K)                           # (B, S, K)
    topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)

    fe = topi.reshape(B, S * K)                             # (B, S*K)
    # one rank over the batch: expert ids offset per sequence keep each
    # sequence's experts apart, and the stable sort keeps token order
    row = torch.arange(B, device=x.device)[:, None] * E
    rank = segment_rank((fe + row).reshape(-1),
                        torch.ones(B * S * K, dtype=torch.bool,
                                   device=x.device)).reshape(B, S * K)
    keep = rank < C
    dest = torch.where(keep, fe * C + rank, E * C)          # (B, S*K)
    tok = torch.arange(S, device=x.device).repeat_interleave(K)
    bidx = torch.arange(B, device=x.device)[:, None]

    buf = torch.zeros((B, E * C + 1, D), dtype=dtype, device=x.device)
    buf[bidx, dest] = x.to(dtype)[:, tok]
    h = buf[:, :E * C].reshape(B, E, C, D)
    up = torch.einsum("becd,edf->becf", h, p.w1.to(dtype))
    gate = torch.einsum("becd,edf->becf", h, p.w3.to(dtype))
    y = torch.einsum("becf,efd->becd", _act(cfg, up) * gate, p.w2.to(dtype))
    y = torch.cat([y.reshape(B, E * C, D),
                   torch.zeros((B, 1, D), dtype=dtype, device=x.device)], 1)
    w = topv.reshape(B, S * K).to(dtype) * keep.to(dtype)   # (B, S*K)
    if cfg.moe_combine == "scatter":
        # each slot's weight and token scattered, then one scatter-add of
        # the weighted slots into the tokens (row S takes the empty slots)
        w_slot = torch.zeros((B, E * C + 1), dtype=dtype, device=x.device)
        w_slot[bidx, dest] = w
        tok_slot = torch.full((B, E * C + 1), S, dtype=torch.long,
                              device=x.device)
        tok_slot[bidx, dest] = tok
        out = torch.zeros((B, S + 1, D), dtype=dtype, device=x.device)
        out.scatter_add_(1, tok_slot[..., None].expand(-1, -1, D),
                         y * w_slot[..., None])
        out = out[:, :S]
    else:
        # "gather" and "allgather" differ only in their sharding
        out = (y[bidx, dest] * w[..., None]).reshape(B, S, K, D).sum(2)

    # aux: load balance (Switch) and router z-loss
    counts = torch.zeros((B, E), device=x.device).scatter_add_(
        1, fe, keep.float())                                # (B, E)
    z2 = torch.logsumexp(logits, dim=-1) ** 2               # (B, S)
    bsum = _MOE_BATCH.batch_sum
    if bsum is None:
        me = probs.mean(dim=(0, 1))                         # (E,)
        ce = counts.mean(0) / max(S * K, 1)
        z = z2.mean()
    else:
        # the whole batch's means: every slice's sums over its tokens
        n = B * S * _MOE_BATCH.n_slices
        me = bsum(probs.sum(dim=(0, 1))) / n
        ce = bsum(counts.sum(0)) / max(n * K, 1)
        z = bsum(z2.sum()) / n
    aux = {"load_balance": E * (me * ce).sum(), "router_z": z,
           "dropped": (~keep).sum().float()}
    return out, aux


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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token NLL in f32; logits (B, S, V), labels (B, S) int,
    mask (B, S) (the mean over the masked positions, at least one)."""
    lf = logits.float()
    nll = torch.logsumexp(lf, dim=-1) - torch.gather(
        lf, -1, labels.long()[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def remat(cfg: ArchConfig, fn, *args):
    """``fn(*args)``, its activations recomputed in the backward when
    ``cfg.remat`` is not ``"none"`` and grad is on (the reference's
    ``jax.checkpoint`` of each layer).  ``"dots_saveable"`` recomputes
    everything too: the reference keeps the products' outputs under it,
    which changes memory and time but not a value."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def shifted_labels(tokens: torch.Tensor):
    """Next-token labels (the last column 0) and their mask (the last
    column 0), as the reference's loss functions build them."""
    B, S = tokens.shape
    labels = torch.cat([tokens[:, 1:], tokens.new_zeros((B, 1))], 1)
    mask = torch.cat([torch.ones((B, S - 1), device=tokens.device),
                      torch.zeros((B, 1), device=tokens.device)], 1)
    return labels, mask


def lm_loss_from_hidden(cfg: ArchConfig, head: Dense | None,
                        embed_p: Embedding, x: torch.Tensor,
                        labels: torch.Tensor, mask: torch.Tensor, *,
                        chunk: int = 512) -> torch.Tensor:
    """Chunked LM cross-entropy that never holds the (B, S, V) logits: the
    positions are padded to a whole number of chunks of ``min(chunk, S)``
    and each chunk's (B, chunk, V) logits are recomputed in the backward
    (``checkpoint``, as the reference's ``jax.checkpoint`` of its scan
    body), so only one chunk's logits exist at a time.  Returns the masked
    mean NLL in f32."""
    B, S, _ = x.shape
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    mask = mask.float()

    def body(xch, lch, mch):
        logits = logits_head(cfg, head, embed_p, xch).float()
        nll = torch.logsumexp(logits, dim=-1) - torch.gather(
            logits, -1, lch.long()[..., None])[..., 0]
        return (nll * mch).sum()

    tot = x.new_zeros((), dtype=torch.float32)
    for i in range(0, x.shape[1], c):
        xs = (x[:, i:i + c], labels[:, i:i + c], mask[:, i:i + c])
        tot = tot + (checkpoint(body, *xs, use_reentrant=False)
                     if torch.is_grad_enabled() else body(*xs))
    return tot / mask.sum().clamp(min=1.0)
