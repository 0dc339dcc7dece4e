"""xLSTM: mLSTM and sLSTM blocks, one sLSTM every ``slstm_every`` layers.

Port of ``repro.models.xlstm``.  The mLSTM (matrix memory, exponential
gating) runs full sequences in its chunkwise-parallel form
(:func:`mlstm_chunkwise`: attention-like products within a chunk, the
``(C, n, m)`` state carried across chunks) and decodes with the exact
recurrent step (:func:`mlstm_step`).  The sLSTM (scalar memory with a
per-head hidden-state recurrence ``r``) has no parallel form: it runs as
a loop over time.  Everything here is plain torch, as the reference is
jnp; no kernel of the reference's is on this path.

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


def _mlstm_qkv_gates(cfg: ArchConfig, p: MLSTMBlock, x: torch.Tensor):
    """x: (B, S, D) -> q, k, v (B, H, S, hd), ilog, glog (B, H, S), z
    (B, S, inner), inner, hd."""
    dtype = cfg.compute_dtype
    B, S, _ = x.shape
    H = cfg.n_heads
    up = L.dense(p.w_up, L.norm_apply(cfg, p.ln, x), dtype)
    inner = up.shape[-1] // 2
    xm, z = up[..., :inner], up[..., inner:]
    hd = inner // H

    def heads(w):
        return _block_linear(w, xm, dtype).reshape(B, S, H, hd).transpose(1, 2)

    q, k, v = heads(p.wq), heads(p.wk), heads(p.wv)
    gates = L.dense(p.w_if, xm, dtype).float()
    ilog = gates[..., :H].transpose(1, 2)
    glog = F.logsigmoid(gates[..., H:]).transpose(1, 2)
    return q / math.sqrt(hd), k, v, ilog, glog, z, inner, hd


def _mlstm_out(cfg: ArchConfig, p: MLSTMBlock, x, h, z, inner, hd):
    """The per-head norm of h (B, S, H, hd), the silu(z) gate, w_down and
    the residual."""
    B, S = h.shape[:2]
    dtype = cfg.compute_dtype
    H = cfg.n_heads
    hn = L.rms_norm_simple(h, p.hn.reshape(H, hd)[None, None])
    h = hn.reshape(B, S, inner).to(dtype) * F.silu(z)
    return x + L.dense(p.w_down, h, dtype)


def mlstm_block(cfg: ArchConfig, p: MLSTMBlock, x: torch.Tensor, *,
                chunk: int = 256) -> torch.Tensor:
    S = x.shape[1]
    q, k, v, ilog, glog, z, inner, hd = _mlstm_qkv_gates(cfg, p, x)
    h, _ = mlstm_chunkwise(q, k, v, ilog, glog, chunk=min(chunk, S))
    return _mlstm_out(cfg, p, x, h.transpose(1, 2), z, inner, hd)


def mlstm_block_step(cfg: ArchConfig, p: MLSTMBlock, x: torch.Tensor, state):
    """Decode step.  x: (B, 1, D); state (C, n, m)."""
    q, k, v, ilog, glog, z, inner, hd = _mlstm_qkv_gates(cfg, p, x)
    state2, h = mlstm_step(state, q[:, :, 0], k[:, :, 0], v[:, :, 0],
                           ilog[:, :, 0], glog[:, :, 0])   # (B, H, hd)
    return _mlstm_out(cfg, p, x, h[:, None], z, inner, hd), state2


def mlstm_state_spec(cfg: ArchConfig, B: int, device):
    inner = int(cfg.proj_factor * cfg.d_model)
    hd = inner // cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((B, cfg.n_heads, hd, hd), **f32),
            torch.zeros((B, cfg.n_heads, hd), **f32),
            torch.full((B, cfg.n_heads), NEG_INF, **f32))


# ----------------------------------------------------------- sLSTM block ---
class SLSTMBlock(nn.Module):
    """``ln``, ``w_in`` (D, 4 inner), the recurrent ``r`` (4, H, hd, hd)
    in float32 (the reference applies it in float32) and ``w_down``."""

    def __init__(self, cfg: ArchConfig, *, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        d = cfg.d_model
        inner = int(cfg.proj_factor * d)
        H = cfg.n_heads
        hd = inner // H
        self.ln = L.Norm(cfg, d, **kw)
        self.w_in = L.Dense(d, 4 * inner, **kw)
        self.r = L._param((4, H, hd, hd), torch.float32, device)
        self.w_down = L.Dense(inner, d, **kw)

    @torch.no_grad()
    def reset_random_(self, gen: torch.Generator) -> None:
        self.r.normal_(0.0, 1.0 / math.sqrt(self.r.shape[-1]), generator=gen)


def _slstm_gate_step(p: SLSTMBlock, xs_t, h, c, n, m, H, hd):
    """One sLSTM time step in float32.  xs_t: (B, 4 inner) preacts."""
    B = xs_t.shape[0]
    inner = H * hd
    # (H, B, hd) @ (4, H, hd, hd), batched over (gate, head): r is read in
    # place (an einsum over "bhd,ghde" copies all of r to batch by head)
    rec = (h.reshape(B, H, hd).transpose(0, 1) @ p.r.float()).transpose(
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


def _slstm_dims(cfg: ArchConfig):
    inner = int(cfg.proj_factor * cfg.d_model)
    return cfg.n_heads, inner // cfg.n_heads, inner


def slstm_block(cfg: ArchConfig, p: SLSTMBlock, x: torch.Tensor
                ) -> torch.Tensor:
    """The sLSTM over a sequence, one step at a time."""
    B, S, _ = x.shape
    dtype = cfg.compute_dtype
    H, hd, inner = _slstm_dims(cfg)
    xs = L.dense(p.w_in, L.norm_apply(cfg, p.ln, x), dtype).float()
    carry = slstm_state_spec(cfg, B, x.device)
    hs = []
    for t in range(S):
        carry = _slstm_gate_step(p, xs[:, t], *carry, H, hd)
        hs.append(carry[0])
    h = torch.stack(hs, 1)                             # (B, S, inner)
    return x + L.dense(p.w_down, h.to(dtype), dtype)


def slstm_block_step(cfg: ArchConfig, p: SLSTMBlock, x: torch.Tensor, state):
    """Decode step.  x: (B, 1, D); state (h, c, n, m)."""
    dtype = cfg.compute_dtype
    H, hd, _ = _slstm_dims(cfg)
    xs = L.dense(p.w_in, L.norm_apply(cfg, p.ln, x), dtype).float()[:, 0]
    state2 = _slstm_gate_step(p, xs, *state, H, hd)
    out = x + L.dense(p.w_down, state2[0][:, None].to(dtype), dtype)
    return out, state2


def slstm_state_spec(cfg: ArchConfig, B: int, device):
    inner = int(cfg.proj_factor * cfg.d_model)
    f32 = dict(dtype=torch.float32, device=device)
    z = torch.zeros((B, inner), **f32)
    return (z, z.clone(), z.clone(), torch.full((B, inner), NEG_INF, **f32))


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
            return_hidden: bool = False):
    """Full-sequence forward -> (logits (B, S, V), {}), or with
    ``return_hidden`` the final-normed hidden states (B, S, D); each block
    under :func:`repro_torch.models.layers.remat`."""
    x = L.embed(cfg, model.embed, batch["tokens"])
    for i, bp in enumerate(model.blocks):
        fn = slstm_block if _is_slstm(cfg, i) else mlstm_block
        x = L.remat(cfg, functools.partial(fn, cfg, bp), x)
    x = L.norm_apply(cfg, model.ln_f, x)
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
