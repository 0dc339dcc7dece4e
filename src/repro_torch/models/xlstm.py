"""xLSTM: mLSTM and sLSTM blocks, one sLSTM every ``slstm_every`` layers.

Port of ``repro.models.xlstm``.  The mLSTM (matrix memory, exponential
gating) runs full sequences in its chunkwise-parallel form
(:func:`mlstm_chunkwise`: attention-like products within a chunk, the
``(C, n, m)`` state carried across chunks) and decodes with the exact
recurrent step (:func:`mlstm_step`).  The sLSTM (scalar memory with a
per-head hidden-state recurrence ``r``) has no parallel form: it runs as
a loop over time.  Everything here is plain torch, as the reference is
jnp; no kernel of the reference's is on this path.

Under :func:`repro_torch.distributed.tensor_parallel.activate`, on a
local copy (the ``w_inner`` dimensions split over ``model``), each block
runs on this rank's channels of the inner dimension: the up-projections'
columns of the rank's parts (:func:`tensor_parallel.parts_of_model`),
``w_if`` and ``w_down`` row-parallel, the cell on the rank's heads, or,
where the ranks do not divide the heads (xlstm-1.3b's 4 over 16), on the
whole heads that cover its channels, of which it keeps its own channels.
The sLSTM's loop runs on those heads with no collective in it; the decode
states hold them.

The blocks are heterogeneous, so they sit in an ``nn.ModuleList`` of the
two classes, as the reference keeps a tuple of per-layer trees.  The
decode cache holds ``Tagged("mlstm", (C, n, m))`` or ``Tagged("slstm",
(h, c, n, m))`` per layer, all float32; each step returns new tensors.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import layers as L
from repro_torch.utils import Tagged

NEG_INF = -1e30
QKV_BLOCK = 4


def _block_linear(w: torch.Tensor, x: torch.Tensor, dtype) -> torch.Tensor:
    """Block-diagonal linear: w (n_blocks, bs, bs); x (..., n_blocks*bs)."""
    nb, bs, _ = w.shape
    xb = x.reshape(x.shape[:-1] + (nb, bs))
    y = torch.einsum("...nb,nbc->...nc", xb.to(dtype), w.to(dtype))
    return y.reshape(x.shape)


# ------------------------------------------------------------ mLSTM cell ---
def mlstm_chunkwise(q, k, v, ilog, glog, *, chunk: int = 256, state=None):
    """Chunkwise mLSTM.  q, k, v: (B, H, S, d) (q pre-scaled by
    1/sqrt(d)); ilog, glog: (B, H, S) input-gate preact and
    logsigmoid(forget).  Returns (h (B, H, S, d), final state (C (B, H, d,
    d), n (B, H, d), m (B, H)))."""
    B, H, S, d = q.shape
    Lc = min(chunk, S)
    assert S % Lc == 0, (S, Lc)
    dev = q.device
    if state is None:
        C = torch.zeros((B, H, d, d), dtype=torch.float32, device=dev)
        n = torch.zeros((B, H, d), dtype=torch.float32, device=dev)
        m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=dev)
    else:
        C, n, m = state
    tril = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=dev))
    hs = []
    for c0 in range(0, S, Lc):
        sl = slice(c0, c0 + Lc)
        Q, K, V = q[:, :, sl].float(), k[:, :, sl].float(), v[:, :, sl].float()
        il, gl = ilog[:, :, sl], glog[:, :, sl]
        b = torch.cumsum(gl, -1)                       # (B, H, Lc) inclusive
        btot = b[..., -1]                              # (B, H)

        D = b[..., :, None] - b[..., None, :] + il[..., None, :]
        D = D.masked_fill(~tril, NEG_INF)              # (B, H, Lc, Lc)
        m_intra = D.max(-1).values                     # (B, H, Lc)
        m_inter = b + m[..., None]
        mt = torch.maximum(m_intra, m_inter).clamp(min=-60.0)

        Sij = torch.einsum("bhtd,bhsd->bhts", Q, K) * torch.exp(
            D - mt[..., None])
        w_inter = torch.exp(m_inter - mt)              # (B, H, Lc)
        num = torch.einsum("bhts,bhsd->bhtd", Sij, V) \
            + w_inter[..., None] * torch.einsum("bhtd,bhde->bhte", Q, C)
        den = Sij.sum(-1) + w_inter * torch.einsum("bhtd,bhd->bht", Q, n)
        den = torch.maximum(den.abs(), torch.exp(-mt))
        hs.append(num / den[..., None])                # (B, H, Lc, d)

        # the state at the end of the chunk
        dec = btot[..., None] - b + il                 # decay s -> end
        m_next = torch.maximum(btot + m, dec.max(-1).values)
        sc_old = torch.exp(btot + m - m_next)          # (B, H)
        k_dec = K * torch.exp(dec - m_next[..., None])[..., None]
        C = sc_old[..., None, None] * C + torch.einsum("bhsd,bhse->bhde",
                                                       k_dec, V)
        n = sc_old[..., None] * n + k_dec.sum(2)
        m = m_next
    return torch.cat(hs, 2), (C, n, m)


def mlstm_step(state, q, k, v, ilog, glog):
    """The exact recurrent step.  q, k, v: (B, H, d) (q pre-scaled); gates
    (B, H).  Returns (state', h (B, H, d))."""
    C, n, m = state
    q, k, v = q.float(), k.float(), v.float()
    m_new = torch.maximum(glog + m, ilog).clamp(min=-60.0)
    fp = torch.exp(glog + m - m_new)                   # (B, H)
    ip = torch.exp(ilog - m_new)
    # C' = fp C + ip k v^T (k-index first): a scale and one fused
    # multiply-add of the outer product, two passes over the state
    ki = ip[..., None] * k
    C2 = torch.addcmul(fp[..., None, None] * C, ki[..., :, None],
                       v[..., None, :])
    n2 = fp[..., None] * n + ki
    num = torch.einsum("bhd,bhde->bhe", q, C2)
    den = torch.einsum("bhd,bhd->bh", q, n2)
    den = torch.maximum(den.abs(), torch.exp(-m_new))
    return (C2, n2, m_new), num / den[..., None]


# ----------------------------------------------------------- mLSTM block ---
class MLSTMBlock(nn.Module):
    """``ln``, ``w_up`` (D, 2 inner), the block-diagonal ``wq``, ``wk``,
    ``wv`` (inner/4, 4, 4), ``w_if`` (inner, 2 H), the per-head output
    norm ``hn`` and ``w_down``."""

    def __init__(self, cfg: ArchConfig, *, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        d = cfg.d_model
        inner = int(cfg.proj_factor * d)
        self.ln = L.Norm(cfg, d, **kw)
        self.w_up = L.Dense(d, 2 * inner, **kw)
        shape = (inner // QKV_BLOCK, QKV_BLOCK, QKV_BLOCK)
        self.wq = L._param(shape, dtype, device)
        self.wk = L._param(shape, dtype, device)
        self.wv = L._param(shape, dtype, device)
        self.w_if = L.Dense(inner, 2 * cfg.n_heads, **kw)
        self.hn = L._param((inner,), dtype, device)
        self.w_down = L.Dense(inner, d, **kw)

    @torch.no_grad()
    def reset_random_(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv):
            w.normal_(0.0, 1.0 / math.sqrt(QKV_BLOCK), generator=gen)
        self.hn.fill_(1.0)


def _dims(cfg: ArchConfig):
    inner = int(cfg.proj_factor * cfg.d_model)
    return cfg.n_heads, inner // cfg.n_heads, inner


def _tp_inner(cfg: ArchConfig, n: int, r: int):
    """Rank ``r`` of ``n``'s channels ``[c0, c0 + c)`` of the inner
    dimension and the heads ``[h0, h1)`` that cover them: its own heads
    where the ranks divide the heads, else the whole heads its channels
    fall in (over 4 ranks the smoke model's 2 heads are half a head a
    rank, xlstm-1.3b's 4 over 16 a quarter).  One rank of one has every
    channel and head."""
    H, hd, inner = _dims(cfg)
    c = inner // n
    c0 = r * c
    return c0, c, c0 // hd, -(-(c0 + c) // hd)


def _ranks(cfg: ArchConfig, w_down: L.Dense):
    """``(n, r)``: the ranks that split the inner dimension and this one,
    by ``w_down``'s rows (split over ``model`` in a tensor-parallel local
    copy); ``(1, 0)`` when it is whole."""
    t = tp.current() if tp.split(w_down.w, 0, _dims(cfg)[2]) else None
    return (t.size, t.rank) if t else (1, 0)


def _head_spans(cfg: ArchConfig, n: int, n_parts: int,
                own_last: bool = False):
    """``spans_of`` for :func:`tensor_parallel.parts_of_model`: each of
    ``n`` ranks' covering heads' channels in each of ``n_parts`` parts of
    the inner dimension (with ``own_last``, its own channels in the last
    part)."""
    hd = _dims(cfg)[1]

    def spans(r):
        c0, c, h0, h1 = _tp_inner(cfg, n, r)
        heads = (h0 * hd, h1 * hd)
        if own_last:
            return (heads,) * (n_parts - 1) + ((c0, c0 + c),)
        return (heads,) * n_parts
    return spans


def _mlstm_qkv_gates(cfg: ArchConfig, p: MLSTMBlock, x: torch.Tensor):
    """x: (B, S, D) -> q, k, v (B, nh, S, hd), ilog, glog (B, nh, S), z
    (B, S, c) and this rank's ``(c0, c, h0, h1)`` (:func:`_tp_inner`):
    the heads ``[h0, h1)`` (nh of them; all H without tensor parallelism)
    and z's channels ``[c0, c0 + c)``.  Under tensor parallelism xm on the
    covering heads' channels and z on the rank's own come from one
    product (:func:`tensor_parallel.parts_of_model` of ``w_up``'s
    columns); ``wq``, ``wk`` and ``wv`` act on those heads (their blocks
    gathered where the heads are not the rank's own); ``w_if`` is
    row-parallel on the rank's channels of xm, its partial sums reduced
    into the whole gates."""
    dtype = cfg.compute_dtype
    B, S, _ = x.shape
    H, hd, inner = _dims(cfg)
    n, r = _ranks(cfg, p.w_down)
    c0, c, h0, h1 = span = _tp_inner(cfg, n, r)
    nh = h1 - h0
    xn = L.norm_apply(cfg, p.ln, x)
    if n == 1:
        up = L.dense(p.w_up, xn, dtype)
    else:
        w = tp.parts_of_model(p.w_up.w, 2 * inner, 2, dim=1,
                              spans_of=_head_spans(cfg, n, 2, True))
        up = tp.copy_to_model(xn).to(dtype) @ w.to(dtype)
    xm, z = up[..., :nh * hd], up[..., nh * hd:]

    def heads(w):
        w = tp.parts_of_model(w, inner // QKV_BLOCK, 1, dim=0, spans_of=(
            lambda q: tuple((a // QKV_BLOCK, b // QKV_BLOCK) for a, b in
                            _head_spans(cfg, n, 1)(q))))
        return _block_linear(w, xm, dtype).reshape(
            B, S, nh, hd).transpose(1, 2)

    q, k, v = heads(p.wq), heads(p.wk), heads(p.wv)
    gates = L.dense(p.w_if, xm[..., c0 - h0 * hd:c0 - h0 * hd + c], dtype)
    if n > 1:
        gates = tp.copy_to_model(tp.reduce_from_model(gates))
    gates = gates.float()
    ilog = gates[..., h0:h1].transpose(1, 2)
    glog = F.logsigmoid(gates[..., H + h0:H + h1]).transpose(1, 2)
    return q / math.sqrt(hd), k, v, ilog, glog, z, span


def _mlstm_out(cfg: ArchConfig, p: MLSTMBlock, x, h, z, span, n):
    """The per-head norm of h (B, S, nh, hd), the rank's channels of it
    gated by silu(z), ``w_down`` (row-parallel over ``n`` ranks) and the
    residual."""
    B, S = h.shape[:2]
    dtype = cfg.compute_dtype
    H, hd, inner = _dims(cfg)
    c0, c, h0, h1 = span
    hn = tp.parts_of_model(p.hn, inner, 1, dim=0,
                           spans_of=_head_spans(cfg, n, 1))
    h = L.rms_norm_simple(h, hn.reshape(h1 - h0, hd)[None, None])
    h = h.reshape(B, S, (h1 - h0) * hd)[..., c0 - h0 * hd:c0 - h0 * hd + c]
    return x + L.row_parallel(p.w_down, h.to(dtype) * F.silu(z), dtype,
                              inner)


def mlstm_block(cfg: ArchConfig, p: MLSTMBlock, x: torch.Tensor, *,
                chunk: int = 256) -> torch.Tensor:
    S = x.shape[1]
    q, k, v, ilog, glog, z, span = _mlstm_qkv_gates(cfg, p, x)
    h, _ = mlstm_chunkwise(q, k, v, ilog, glog, chunk=min(chunk, S))
    return _mlstm_out(cfg, p, x, h.transpose(1, 2), z, span,
                      _ranks(cfg, p.w_down)[0])


def mlstm_block_step(cfg: ArchConfig, p: MLSTMBlock, x: torch.Tensor, state):
    """Decode step.  x: (B, 1, D); state (C, n, m) of the rank's heads."""
    q, k, v, ilog, glog, z, span = _mlstm_qkv_gates(cfg, p, x)
    state2, h = mlstm_step(state, q[:, :, 0], k[:, :, 0], v[:, :, 0],
                           ilog[:, :, 0], glog[:, :, 0])   # (B, nh, hd)
    return _mlstm_out(cfg, p, x, h[:, None], z, span,
                      _ranks(cfg, p.w_down)[0]), state2


def _state_heads(cfg: ArchConfig) -> int:
    """The heads a decode state holds: all H, or under tensor parallelism
    the rank's covering heads (:func:`_tp_inner`: its share of the
    ``state_head`` axis where the ranks divide H; where they do not, the
    reference keeps the state whole and each rank here keeps the whole
    heads it computes)."""
    t = tp.current()
    H, hd, inner = _dims(cfg)
    if t is None or inner % t.size:
        return H
    _, _, h0, h1 = _tp_inner(cfg, t.size, t.rank)
    return h1 - h0


def mlstm_state_spec(cfg: ArchConfig, B: int, device):
    H, hd, _ = _dims(cfg)
    nh = _state_heads(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((B, nh, hd, hd), **f32),
            torch.zeros((B, nh, hd), **f32),
            torch.full((B, nh), NEG_INF, **f32))


# ----------------------------------------------------------- sLSTM block ---
class SLSTMBlock(nn.Module):
    """``ln``, ``w_in`` (D, 4 inner), the recurrent ``r`` (4, H, hd, hd)
    in float32 (the reference applies it in float32) and ``w_down``."""

    def __init__(self, cfg: ArchConfig, *, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        d = cfg.d_model
        H, hd, inner = _dims(cfg)
        self.ln = L.Norm(cfg, d, **kw)
        self.w_in = L.Dense(d, 4 * inner, **kw)
        self.r = L._param((4, H, hd, hd), torch.float32, device)
        self.w_down = L.Dense(inner, d, **kw)

    @torch.no_grad()
    def reset_random_(self, gen: torch.Generator) -> None:
        self.r.normal_(0.0, 1.0 / math.sqrt(self.r.shape[-1]), generator=gen)


def _slstm_gate_step(r, xs_t, h, c, n, m):
    """One sLSTM time step in float32 on nh heads.  r: (4, nh, hd, hd);
    xs_t: (B, 4 nh hd) preacts; h, c, n, m: (B, nh hd)."""
    B = xs_t.shape[0]
    nh, hd = r.shape[1], r.shape[2]
    inner = nh * hd
    # (nh, B, hd) @ (4, nh, hd, hd), batched over (gate, head): r is read
    # in place (an einsum over "bhd,ghde" copies all of r to batch by head)
    rec = (h.reshape(B, nh, hd).transpose(0, 1) @ r).transpose(
        1, 2).reshape(4, B, inner)
    pre = xs_t.reshape(B, 4, inner).transpose(0, 1) + rec
    i_t, f_t, z_t, o_t = pre[0], pre[1], pre[2], pre[3]
    flog = F.logsigmoid(f_t)
    m_new = torch.maximum(flog + m, i_t)
    ip = torch.exp(i_t - m_new)
    fp = torch.exp(flog + m - m_new)
    c2 = fp * c + ip * torch.tanh(z_t)
    n2 = fp * n + ip
    h2 = torch.sigmoid(o_t) * c2 / n2.clamp(min=1e-6)
    return h2, c2, n2, m_new


def _slstm_in(cfg: ArchConfig, p: SLSTMBlock, x: torch.Tensor):
    """The preacts (B, S, 4 nh hd) in float32 on this rank's heads, ``r``
    on them (4, nh, hd, hd) and the rank's ``(c0, c, h0, h1)``: under
    tensor parallelism the covering heads' columns of each gate of
    ``w_in`` (:func:`tensor_parallel.parts_of_model`) and ``r``'s heads
    (its own shard where the ranks divide the heads, else sliced from the
    whole ``r``)."""
    dtype = cfg.compute_dtype
    H, hd, inner = _dims(cfg)
    n, rank = _ranks(cfg, p.w_down)
    span = _tp_inner(cfg, n, rank)
    xn = L.norm_apply(cfg, p.ln, x)
    if n == 1:
        return L.dense(p.w_in, xn, dtype).float(), p.r.float(), span
    w = tp.parts_of_model(p.w_in.w, 4 * inner, 4, dim=1,
                          spans_of=_head_spans(cfg, n, 4))
    r = tp.parts_of_model(p.r, H, 1, dim=1, spans_of=lambda q: tuple(
        (a // hd, b // hd) for a, b in _head_spans(cfg, n, 1)(q)))
    xs = tp.copy_to_model(xn).to(dtype) @ w.to(dtype)
    return xs.float(), r.float(), span


def _slstm_out(cfg: ArchConfig, p: SLSTMBlock, x, h, span):
    """The rank's channels of h (B, S, nh hd) through ``w_down``
    (row-parallel under tensor parallelism), plus the residual."""
    dtype = cfg.compute_dtype
    c0, c, h0, _ = span
    hd = _dims(cfg)[1]
    h = h[..., c0 - h0 * hd:c0 - h0 * hd + c].to(dtype)
    return x + L.row_parallel(p.w_down, h, dtype, _dims(cfg)[2])


def slstm_block(cfg: ArchConfig, p: SLSTMBlock, x: torch.Tensor
                ) -> torch.Tensor:
    """The sLSTM over a sequence, one step at a time; under tensor
    parallelism on the rank's heads, with no collective in the loop."""
    B, S, _ = x.shape
    xs, r, span = _slstm_in(cfg, p, x)
    carry = slstm_state_spec(cfg, B, x.device)
    hs = []
    for t in range(S):
        carry = _slstm_gate_step(r, xs[:, t], *carry)
        hs.append(carry[0])
    return _slstm_out(cfg, p, x, torch.stack(hs, 1), span)


def slstm_block_step(cfg: ArchConfig, p: SLSTMBlock, x: torch.Tensor, state):
    """Decode step.  x: (B, 1, D); state (h, c, n, m) of the rank's
    heads."""
    xs, r, span = _slstm_in(cfg, p, x)
    state2 = _slstm_gate_step(r, xs[:, 0], *state)
    return _slstm_out(cfg, p, x, state2[0][:, None], span), state2


def slstm_state_spec(cfg: ArchConfig, B: int, device):
    """(h, c, n, m), each (B, nh hd): every head, or under tensor
    parallelism the rank's (:func:`_state_heads`)."""
    _, hd, _ = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    z = torch.zeros((B, _state_heads(cfg) * hd), **f32)
    return (z, z.clone(), z.clone(), torch.full(z.shape, NEG_INF, **f32))


# ------------------------------------------------------------------- LM ----
def _is_slstm(cfg: ArchConfig, i: int) -> bool:
    return cfg.slstm_every > 0 and (i % cfg.slstm_every
                                    == cfg.slstm_every - 1)


class XLSTMLM(nn.Module):
    """Embedding, the blocks (an sLSTM at every layer ``_is_slstm`` names,
    an mLSTM elsewhere), ``ln_f`` and an untied head.  Parameters are
    allocated uninitialised; fill them with
    :func:`repro_torch.models.layers.init_random_` or
    :func:`repro_torch.interop.params_from_numpy`.  ``max_seq`` is
    accepted for the model API and unused."""

    def __init__(self, cfg: ArchConfig, *, max_seq: int = 0, dtype=None,
                 device=None):
        super().__init__()
        dtype = dtype or cfg.compute_dtype
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.embed = L.Embedding(cfg, **kw)
        self.blocks = nn.ModuleList(
            (SLSTMBlock if _is_slstm(cfg, i) else MLSTMBlock)(cfg, **kw)
            for i in range(cfg.n_layers))
        self.ln_f = L.Norm(cfg, cfg.d_model, **kw)
        self.head = L.Dense(cfg.d_model, cfg.vocab, **kw)


def forward(cfg: ArchConfig, model: XLSTMLM, batch: dict, *,
            last_only: bool = False, return_hidden: bool = False):
    """Full-sequence forward -> (logits (B, S, V), {}), or with
    ``return_hidden`` the final-normed hidden states (B, S, D) (with
    ``last_only`` the last position's, S = 1); each block under
    :func:`repro_torch.models.layers.remat`."""
    x = L.embed(cfg, model.embed, batch["tokens"])
    for i, bp in enumerate(model.blocks):
        fn = slstm_block if _is_slstm(cfg, i) else mlstm_block
        x = L.remat(cfg, functools.partial(fn, cfg, bp), x)
    x = L.norm_apply(cfg, model.ln_f, x)
    if last_only:
        x = x[:, -1:, :]
    if return_hidden:
        return x, {}
    return L.logits_head(cfg, model.head, model.embed, x), {}


def loss_fn(cfg: ArchConfig, model: XLSTMLM, batch: dict):
    """Chunked next-token cross entropy -> (loss, {"nll": loss}); the
    sLSTM's loop differentiates as plain torch."""
    hidden, _ = forward(cfg, model, batch, return_hidden=True)
    labels, mask = L.shifted_labels(batch["tokens"])
    loss = L.lm_loss_from_hidden(cfg, model.head, model.embed, hidden,
                                 labels, mask)
    return loss, {"nll": loss}


def init_decode_cache(cfg: ArchConfig, B: int, max_seq: int, device) -> dict:
    """One recurrent state per layer; ``max_seq`` does not size it.  The
    reference also returns the cache's sharding axes, which have no
    counterpart here."""
    layers = tuple(
        Tagged("slstm", slstm_state_spec(cfg, B, device)) if _is_slstm(cfg, i)
        else Tagged("mlstm", mlstm_state_spec(cfg, B, device))
        for i in range(cfg.n_layers))
    return {"seq_lens": torch.zeros((B,), dtype=torch.int32, device=device),
            "layers": layers}


@torch.no_grad()
def decode_step(cfg: ArchConfig, model: XLSTMLM, cache: dict,
                tokens: torch.Tensor):
    """tokens: (B,) int -> (logits (B, V), cache')."""
    x = L.embed(cfg, model.embed, tokens[:, None])
    new_layers = []
    for bp, tagged in zip(model.blocks, cache["layers"]):
        step = slstm_block_step if tagged.kind == "slstm" \
            else mlstm_block_step
        x, st2 = step(cfg, bp, x, tagged.value)
        new_layers.append(Tagged(tagged.kind, st2))
    x = L.norm_apply(cfg, model.ln_f, x)
    logits = L.logits_head(cfg, model.head, model.embed, x)
    cache2 = dict(cache)
    cache2["layers"] = tuple(new_layers)
    cache2["seq_lens"] = cache["seq_lens"] + 1
    return logits[:, 0, :], cache2
