"""Layer library: dense projections, norms, RoPE, GQA attention, MLP, MoE,
embedding, learned positions and the logits head.

Port of ``repro.models.layers`` (``dense``, ``norm_apply``,
``rms_norm_simple``, ``rope``, ``attention``, ``mlp``,
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

Under :func:`repro_torch.distributed.tensor_parallel.activate` the layers
compute tensor-parallel over the mesh's ``model`` axis on a local copy of
the model (each weight the rule table splits over ``model`` holds this
rank's ``1 / size``; the shapes say which): q, k and v and the MLP's
``w1``/``w3`` are column-parallel, ``wo`` and ``w2`` row-parallel with a
reduce over ``model``; attention runs on the rank's q heads (the heads
that cover its rows of ``wo``; a projection whose local columns are not
whole heads, or hold other kv heads than those q heads use, is gathered
to whole heads first); MoE runs the rank's experts on its slots and sums
the partial outputs; the embedding and the logits are vocab-parallel
(the loss takes the cross-entropy of the rank's vocabulary columns).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel as tp
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


def attention(cfg: ArchConfig, p: Attention, x: torch.Tensor, *,
              window: int | None = None, positions=None,
              causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (prefill). x: (B, S, D); ``window`` a Python
    int or None (global)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    return attend(cfg, p, x, x, positions, causal=causal, window=window)


def _tp_heads(cfg: ArchConfig, n: int, r: int):
    """Rank ``r`` of ``n``'s attention heads: its rows of ``wo`` start at
    column ``c0`` of the (.., H * hd) attention output and number ``c``;
    the q heads ``[h0, h1)`` cover them; ``pick`` lists the kv heads the
    flash kernel is given for them, which maps q head i to kv head
    ``pick[i // (len(q heads) / len(pick))]``: the kv heads those q heads
    use, or, where they straddle a GQA group unaligned, each q head's
    own.  One rank of one has every head."""
    hd, G = cfg.hd, cfg.group
    c = cfg.n_heads * hd // n
    c0 = r * c
    h0, h1 = c0 // hd, -(-(c0 + c) // hd)
    kv = [h // G for h in range(h0, h1)]
    if kv[-1] > kv[0] and (h0 % G or h1 % G):
        return c0, c, h0, h1, kv
    return c0, c, h0, h1, list(range(kv[0], kv[-1] + 1))


def _project_heads(p: Dense, x: torch.Tensor, dtype, heads: int, hd: int,
                   pick, t):
    """One of q, k, v on the heads ``pick``, (B, S, len(pick), hd).  With
    no ``model`` group ``t``, the whole product's heads.  Under one,
    column-parallel when ``p`` is split (its local output taken as it is
    when it is exactly the heads ``pick``, else gathered to whole heads),
    whole on every rank otherwise; a whole output passes
    ``copy_to_model`` before the rank picks its heads, so its gradient is
    the ranks' sum."""
    B, S = x.shape[:2]
    if t is None:
        y = dense(p, x, dtype)
    elif tp.split(p.w, 1, heads * hd):
        y = dense(p, tp.copy_to_model(x), dtype)
        c = y.shape[-1]
        if c % hd == 0 and list(pick) == list(range(t.rank * c // hd,
                                                    (t.rank + 1) * c // hd)):
            return y.reshape(B, S, c // hd, hd)
        y = tp.copy_to_model(tp.gather_from_model(y))
    else:
        y = tp.copy_to_model(dense(p, x, dtype))
    y = y.reshape(B, S, heads, hd)
    lo, hi = pick[0], pick[-1] + 1
    if list(pick) == list(range(lo, hi)):
        return y[:, :, lo:hi]
    return y[:, :, torch.tensor(pick, device=y.device)]


def attend(cfg: ArchConfig, p: Attention, xq: torch.Tensor,
           xkv: torch.Tensor, positions, *, causal: bool,
           window) -> torch.Tensor:
    """Queries of ``xq`` (B, S, D) over keys and values of ``xkv``:
    :func:`attention` (``xkv`` is ``xq``) or, with ``positions`` None, a
    cross-attention (no RoPE and no q/k norms, as the reference's).
    Under tensor parallelism (``wq`` split, see
    :func:`repro_torch.distributed.tensor_parallel.activate`) on this
    rank's heads: the flash kernel runs on the q heads that cover the
    rank's rows of ``wo`` and the kv heads they use (each q head its own
    kv head where the heads straddle a GQA group unaligned), the output's
    matching columns go through the rank's rows of ``wo``, and the ranks'
    partial outputs are summed.  Otherwise on every head."""
    B, S, _ = xq.shape
    dtype, hd = cfg.compute_dtype, cfg.hd
    t = tp.current() if tp.split(p.wq.w, 1, cfg.n_heads * hd) else None
    c0, c, h0, h1, pick = _tp_heads(cfg, *((t.size, t.rank) if t else
                                           (1, 0)))
    q = _project_heads(p.wq, xq, dtype, cfg.n_heads, hd, range(h0, h1), t)
    k = _project_heads(p.wk, xkv, dtype, cfg.n_kv_heads, hd, pick, t)
    v = _project_heads(p.wv, xkv, dtype, cfg.n_kv_heads, hd, pick, t)
    if positions is not None and cfg.qk_norm:
        q_norm, k_norm = (p.q_norm, p.k_norm) if t is None else (
            tp.copy_to_model(p.q_norm), tp.copy_to_model(p.k_norm))
        q = rms_norm_simple(q, q_norm)
        k = rms_norm_simple(k, k_norm)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if positions is not None and cfg.pos_emb == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal, window=window)
    o = o.transpose(1, 2).reshape(B, S, (h1 - h0) * hd)
    return row_parallel(p.wo, o[..., c0 - h0 * hd:c0 - h0 * hd + c], dtype,
                        cfg.n_heads * hd)


def column_whole(p: Dense, x: torch.Tensor, dtype, whole: int
                 ) -> torch.Tensor:
    """``x @ w (+ b)`` with all ``whole`` output columns: a split ``w``'s
    local product gathered over ``model`` (decode's q, k and v)."""
    if tp.split(p.w, 1, whole):
        return tp.gather_from_model(dense(p, x, dtype))
    return dense(p, x, dtype)


def row_parallel(p: Dense, h: torch.Tensor, dtype, whole: int
                 ) -> torch.Tensor:
    """``h @ w`` where ``w`` has ``whole`` rows: with ``w``'s rows split,
    ``h`` holds the matching columns (already this rank's, or sliced here
    from a whole ``h``) and the ranks' partial products are summed."""
    if not tp.split(p.w, 0, whole):
        return dense(p, h, dtype)
    if p.b is not None:
        raise ValueError("a row-parallel product takes no bias")
    c = p.w.shape[0]
    if h.shape[-1] == whole:
        r = tp.current().rank
        h = h[..., r * c:(r + 1) * c]
    return tp.reduce_from_model(dense(p, h, dtype))


def _act(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if cfg.act == "gelu" else F.silu(x)


def mlp(cfg: ArchConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    dtype = cfg.compute_dtype
    if tp.split(p.w1.w, 1, cfg.d_ff):     # w1, w3 by columns, w2 by rows
        x = tp.copy_to_model(x)
    h = dense(p.w1, x, dtype)
    if cfg.gated_mlp:
        h = _act(cfg, h) * dense(p.w3, x, dtype)
    else:
        h = _act(cfg, h)
    return row_parallel(p.w2, h, dtype, cfg.d_ff)


def _top_k(probs: torch.Tensor, k: int):
    """The k largest of the last axis, largest first, ties to the lower
    index (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    v, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


class _MoeBatch:
    # process-wide, not a thread's: on CUDA the backward (and remat's
    # recompute within it) runs on autograd's device thread
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
    # expert parallelism: this rank runs experts [e0, e0 + El) on the
    # slots they were given (every rank ranks alike: the router is whole),
    # the other choices go to the trash row, and the ranks' partial
    # outputs are summed
    El = p.w1.shape[0]
    par = tp.split(p.w1, 0, E)
    if par:
        e0 = tp.current().rank * El
        x = tp.copy_to_model(x)
        mine = keep & (fe >= e0) & (fe < e0 + El)
        dest = torch.where(mine, (fe - e0) * C + rank, El * C)
    else:
        dest = torch.where(keep, fe * C + rank, E * C)      # (B, S*K)
    tok = torch.arange(S, device=x.device).repeat_interleave(K)
    bidx = torch.arange(B, device=x.device)[:, None]

    buf = torch.zeros((B, El * C + 1, D), dtype=dtype, device=x.device)
    buf[bidx, dest] = x.to(dtype)[:, tok]
    h = buf[:, :El * C].reshape(B, El, C, D)
    up = torch.einsum("becd,edf->becf", h, p.w1.to(dtype))
    gate = torch.einsum("becd,edf->becf", h, p.w3.to(dtype))
    y = torch.einsum("becf,efd->becd", _act(cfg, up) * gate, p.w2.to(dtype))
    y = torch.cat([y.reshape(B, El * C, D),
                   torch.zeros((B, 1, D), dtype=dtype, device=x.device)], 1)
    w = topv.reshape(B, S * K).to(dtype) * keep.to(dtype)   # (B, S*K)
    if par:
        w = tp.copy_to_model(w)
    if cfg.moe_combine == "scatter":
        # each slot's weight and token scattered, then one scatter-add of
        # the weighted slots into the tokens (row S takes the empty slots)
        w_slot = torch.zeros((B, El * C + 1), dtype=dtype, device=x.device)
        w_slot[bidx, dest] = w
        tok_slot = torch.full((B, El * C + 1), S, dtype=torch.long,
                              device=x.device)
        tok_slot[bidx, dest] = tok
        out = torch.zeros((B, S + 1, D), dtype=dtype, device=x.device)
        out.scatter_add_(1, tok_slot[..., None].expand(-1, -1, D),
                         y * w_slot[..., None])
        out = out[:, :S]
    else:
        # "gather" and "allgather" differ only in their sharding
        out = (y[bidx, dest] * w[..., None]).reshape(B, S, K, D).sum(2)
    if par:
        out = tp.reduce_from_model(out)

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
    e = tp.vocab_embed(p.table, tokens, cfg.vocab).to(cfg.compute_dtype)
    if cfg.name.startswith("gemma"):
        e = e * math.sqrt(cfg.d_model)
    return e


def logits_head(cfg: ArchConfig, head: Dense | None, embed_p: Embedding,
                x: torch.Tensor, *, local: bool = False) -> torch.Tensor:
    """The logits (.., V).  With the vocabulary split over ``model`` (a
    tensor-parallel local copy) the product is this rank's columns, which
    ``local`` returns as they are and otherwise gathers over ``model``."""
    dtype = cfg.compute_dtype
    w = embed_p.table.T if cfg.tie_embeddings else head.w
    par = tp.split(w, 1, cfg.vocab)
    if par:
        x = tp.copy_to_model(x)
    if cfg.tie_embeddings:
        out = x @ embed_p.table.to(dtype).T
    else:
        out = x @ head.w.to(dtype)
    if cfg.logit_softcap:
        out = torch.tanh(out / cfg.logit_softcap) * cfg.logit_softcap
    return tp.gather_from_model(out) if par and not local else out


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
    body), so only one chunk's logits exist at a time (under tensor
    parallelism one chunk's ``(B, chunk, V / size)`` columns: the
    cross-entropy is :func:`tensor_parallel.vocab_nll`'s).  Returns the
    masked mean NLL in f32."""
    B, S, _ = x.shape
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    mask = mask.float()

    def body(xch, lch, mch):
        logits = logits_head(cfg, head, embed_p, xch, local=True)
        nll = tp.vocab_nll(logits, lch, cfg.vocab)
        return (nll * mch).sum()

    tot = x.new_zeros((), dtype=torch.float32)
    for i in range(0, x.shape[1], c):
        xs = (x[:, i:i + c], labels[:, i:i + c], mask[:, i:i + c])
        tot = tot + (checkpoint(body, *xs, use_reentrant=False)
                     if torch.is_grad_enabled() else body(*xs))
    return tot / mask.sum().clamp(min=1.0)
