"""Hymba: hybrid-head layers, attention and Mamba (SSM) heads in parallel.

Port of ``repro.models.hymba``.  Every layer runs a sliding-window GQA path
and a selective-SSM (Mamba) path on the same normed input; their
normalised outputs are averaged, then an MLP follows.  Layers {0, L//2,
L-1} attend globally.  ``n_meta_tokens`` learnable meta tokens are
prepended to every sequence: ``forward`` puts them before the tokens and
drops their positions from the logits (``loss_fn`` the same from the
loss), and :func:`prime_cache` runs them
through a decode cache before any prompt token.

Attention goes through the port's flash kernel (``forward``, windowed on
the local layers) and its paged-attention kernel (decode on the global
layers); the local layers decode over a ring of ``window`` positions.
The SSM scan is plain torch, as the reference's is jnp: a log-depth
(Hillis-Steele) scan within each chunk of 256 steps, the state carried
from chunk to chunk.

Under :func:`repro_torch.distributed.tensor_parallel.activate`, on a
local copy (the ``w_inner`` dimensions split over ``model``), the Mamba
path runs on this rank's channels of d_inner (:func:`mamba_apply`) and
the attention, MLP, embedding and head take the layers' tensor-parallel
paths (25 q heads over 5 kv heads straddle GQA groups over 2 or 16
ranks: each rank attends on the q heads that cover its rows of ``wo``).

The decode cache holds, per layer, ``(Tagged("paged" | "ring", entry),
{"conv", "state"})``: the attention entry and the SSM's last
``CONV_K - 1`` conv inputs (compute dtype) and its ``(B, d_inner, N)``
state (float32).  K/V are written into the pools and rings in place, as in
:mod:`repro_torch.models.transformer`; ``conv`` and ``state`` are new
tensors each step.
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
from repro_torch.models import transformer as T
from repro_torch.utils import Tagged

CONV_K = 4  # causal conv width in the mamba path


# ------------------------------------------------------------- SSM (S6) ----
class Mamba(nn.Module):
    """The selective-SSM path, the reference's layouts: ``w_in`` (D,
    2 d_inner), ``conv`` (CONV_K, d_inner), ``w_bc`` (d_inner, 2 N),
    ``w_dt`` (d_inner, d_inner), ``w_out`` (d_inner, D) in the model's
    dtype; ``dt_bias``, ``a_log`` (d_inner, N) and ``d_skip`` in float32,
    since the reference applies them in float32."""

    def __init__(self, cfg: ArchConfig, *, dtype=None, device=None):
        super().__init__()
        D, N = cfg.d_model, cfg.ssm_state
        di = 2 * D
        f32 = torch.float32
        self.w_in = L._param((D, 2 * di), dtype, device)
        self.conv = L._param((CONV_K, di), dtype, device)
        self.w_bc = L._param((di, 2 * N), dtype, device)
        self.w_dt = L._param((di, di), dtype, device)
        self.dt_bias = L._param((di,), f32, device)
        self.a_log = L._param((di, N), f32, device)
        self.d_skip = L._param((di,), f32, device)
        self.w_out = L._param((di, D), dtype, device)

    @torch.no_grad()
    def reset_random_(self, gen: torch.Generator) -> None:
        """The reference's ``init_mamba``: softplus(dt_bias) about 0.018,
        ``A = -(1..N)`` on every row, a unit skip."""
        di, N = self.a_log.shape
        for w, scale in ((self.w_in, 1 / math.sqrt(self.w_in.shape[0])),
                         (self.conv, 0.5), (self.w_bc, 1 / math.sqrt(di)),
                         (self.w_dt, 0.01), (self.w_out, 1 / math.sqrt(di))):
            w.normal_(0.0, scale, generator=gen)
        self.dt_bias.fill_(-4.0)
        self.a_log.copy_(torch.log(torch.arange(
            1, N + 1, dtype=torch.float32, device=self.a_log.device)))
        self.d_skip.fill_(1.0)


def ssm_scan_chunked(a: torch.Tensor, b: torch.Tensor, state: torch.Tensor,
                     chunk: int):
    """h_t = a_t * h_{t-1} + b_t over axis 1 (time).

    a, b: (B, S, d_inner, N) float32; state (B, d_inner, N).  Within a
    chunk of ``chunk`` steps, a Hillis-Steele scan composes the steps
    pairwise (the reference's associative-scan combine) into each step's
    prefix product and sum; the chunk's carry is folded in after.  S
    not a multiple of the chunk is padded with identity steps (a = 1,
    b = 0).  Returns (h (B, S, d_inner, N), final state)."""
    B, S, DI, N = a.shape
    Lc = min(chunk, S)
    pad = (-S) % Lc
    if pad:
        a = torch.cat([a, a.new_ones((B, pad, DI, N))], 1)
        b = torch.cat([b, b.new_zeros((B, pad, DI, N))], 1)
    hs = []
    for c0 in range(0, S + pad, Lc):
        ac, bc = a[:, c0:c0 + Lc], b[:, c0:c0 + Lc]
        d = 1
        while d < Lc:
            # step t takes in the composed steps up to t - d
            ac, bc = (
                torch.cat([ac[:, :d], ac[:, :-d] * ac[:, d:]], 1),
                torch.cat([bc[:, :d], bc[:, d:] + ac[:, d:] * bc[:, :-d]], 1))
            d *= 2
        h = bc + ac * state[:, None]
        state = h[:, -1]
        hs.append(h)
    return torch.cat(hs, 1)[:, :S], state


def _mamba_split(cfg: ArchConfig, p: Mamba) -> bool:
    """Whether ``p`` holds this rank's ``1 / size`` of d_inner (a
    tensor-parallel local copy); the rule table splits every ``w_inner``
    dimension of the path alike, or none."""
    DI = 2 * cfg.d_model
    par = tp.split(p.conv, 1, DI)
    if par != tp.split(p.w_in, 1, 2 * DI):
        raise NotImplementedError(
            f"d_inner {DI} does not split over the model ranks as "
            "2 d_inner does")
    return par


def mamba_apply(cfg: ArchConfig, p: Mamba, x: torch.Tensor, *,
                conv_state=None, ssm_state=None, chunk: int = 256):
    """x: (B, S, D) -> ((B, S, D), (conv_state', ssm_state')).  With S == 1
    one recurrence step from ``ssm_state`` (zeros when None); else the
    chunked scan.

    Under tensor parallelism (``p`` a local copy's, d_inner split over
    ``model``) on this rank's channels of d_inner: ``w_in``'s columns of
    the rank's xm and z (:func:`tensor_parallel.parts_of_model`; the
    reference's blocks put xm and z on different ranks), the conv, the
    scan, ``dt_bias``, ``a_log`` and ``d_skip`` on those channels; ``w_bc``
    row-parallel, its partial sums reduced into the whole (B, S, 2 N);
    ``w_dt`` (rows split, columns whole) row-parallel with each rank
    taking its columns of the reduced sum
    (:func:`tensor_parallel.reduce_scatter_from_model`); ``w_out``
    row-parallel.  The states are the rank's channels."""
    dtype = cfg.compute_dtype
    B, S, D = x.shape
    N = cfg.ssm_state
    DI = 2 * cfg.d_model
    par = _mamba_split(cfg, p)
    w_in = p.w_in
    if par:
        x = tp.copy_to_model(x)
        w_in = tp.parts_of_model(w_in, 2 * DI, 2, dim=1)
    up = x.to(dtype) @ w_in.to(dtype)
    di = up.shape[-1] // 2
    xm, z = up[..., :di], up[..., di:]

    # causal conv1d
    w = p.conv.to(dtype)                               # (K, d_inner)
    if conv_state is None:
        xp = torch.cat([xm.new_zeros((B, CONV_K - 1, di)), xm], 1)
    else:
        xp = torch.cat([conv_state.to(dtype), xm], 1)
    new_conv_state = xp[:, -(CONV_K - 1):]
    xc = sum(xp[:, i:i + S] * w[i] for i in range(CONV_K))
    xc = F.silu(xc)

    # selective parameters
    bc = xc @ p.w_bc.to(dtype)
    dt = xc @ p.w_dt.to(dtype)
    if par:
        bc = tp.copy_to_model(tp.reduce_from_model(bc))
        dt = tp.reduce_scatter_from_model(dt)
    bc = bc.float()
    Bp, Cp = bc[..., :N], bc[..., N:]                  # (B, S, N)
    dt = F.softplus(dt.float() + p.dt_bias.float())    # (B, S, d_inner)
    A = -torch.exp(p.a_log.float())                    # (d_inner, N)
    da = torch.exp(dt[..., None] * A)                  # (B, S, d_inner, N)
    db = (dt * xc.float())[..., None] * Bp[..., None, :]

    state0 = (torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
              if ssm_state is None else ssm_state)
    if S == 1:
        h = da[:, 0] * state0 + db[:, 0]               # (B, d_inner, N)
        new_state = h
        y = torch.einsum("bdn,bn->bd", h, Cp[:, 0])[:, None]
    else:
        hs, new_state = ssm_scan_chunked(da, db, state0, chunk)
        y = torch.einsum("bsdn,bsn->bsd", hs, Cp)
    y = y + xc.float() * p.d_skip.float()
    y = y.to(dtype) * F.silu(z)
    out = y @ p.w_out.to(dtype)
    if par:
        out = tp.reduce_from_model(out)
    return out, (new_conv_state, new_state)


# ------------------------------------------------------------------ block --
class Block(nn.Module):
    """``ln1``, attention and Mamba in parallel, their output norms
    ``n_attn`` and ``n_ssm``, ``ln2`` and the MLP."""

    def __init__(self, cfg: ArchConfig, *, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1 = L.Norm(cfg, cfg.d_model, **kw)
        self.attn = L.Attention(cfg, **kw)
        self.mamba = Mamba(cfg, **kw)
        self.n_attn = L._param((cfg.d_model,), dtype, device)
        self.n_ssm = L._param((cfg.d_model,), dtype, device)
        self.ln2 = L.Norm(cfg, cfg.d_model, **kw)
        self.mlp = L.MLP(cfg, **kw)

    @torch.no_grad()
    def reset_random_(self, gen: torch.Generator) -> None:
        self.n_attn.fill_(1.0)
        self.n_ssm.fill_(1.0)


def _fuse(bp: Block, h_attn, h_ssm):
    return 0.5 * (L.rms_norm_simple(h_attn, bp.n_attn)
                  + L.rms_norm_simple(h_ssm, bp.n_ssm))


def block_apply(cfg: ArchConfig, bp: Block, x: torch.Tensor, *, window,
                positions) -> torch.Tensor:
    xn = L.norm_apply(cfg, bp.ln1, x)
    h_attn = L.attention(cfg, bp.attn, xn, window=window,
                         positions=positions)
    h_ssm, _ = mamba_apply(cfg, bp.mamba, xn)
    x = x + _fuse(bp, h_attn, h_ssm)
    return x + L.mlp(cfg, bp.mlp, L.norm_apply(cfg, bp.ln2, x))


# --------------------------------------------------------------------- LM --
def _global_layers(cfg: ArchConfig) -> set:
    return {0, cfg.n_layers // 2, cfg.n_layers - 1}


def layer_windows(cfg: ArchConfig) -> list:
    """Per-layer windows: ``BIG_WINDOW`` on the global layers, else
    ``cfg.window or 1024`` (the reference's ``layer_window_array``)."""
    g = _global_layers(cfg)
    w = cfg.window or 1024
    return [T.BIG_WINDOW if i in g else w for i in range(cfg.n_layers)]


class HymbaLM(nn.Module):
    """Embedding, ``meta`` (n_meta_tokens, D), the blocks, ``ln_f`` and an
    untied head.  Parameters are allocated uninitialised; fill them with
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
        self.meta = L._param((cfg.n_meta_tokens, cfg.d_model), dtype, device)
        self.blocks = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.Norm(cfg, cfg.d_model, **kw)
        self.head = L.Dense(cfg.d_model, cfg.vocab, **kw)

    @torch.no_grad()
    def reset_random_(self, gen: torch.Generator) -> None:
        self.meta.normal_(0.0, 0.02, generator=gen)


def forward(cfg: ArchConfig, model: HymbaLM, batch: dict, *,
            last_only: bool = False, return_hidden: bool = False):
    """Full-sequence forward -> (logits (B, S, V), {}), or with
    ``return_hidden`` the final-normed hidden states (B, S, D) (with
    ``last_only`` the last position's, S = 1): the meta
    tokens at positions 0..M-1, the tokens after them; a window of S + M
    or more runs its layer as global; each block under
    :func:`repro_torch.models.layers.remat`."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    M = cfg.n_meta_tokens
    x = L.embed(cfg, model.embed, tokens)
    meta = model.meta.to(cfg.compute_dtype)[None].expand(B, M, cfg.d_model)
    x = torch.cat([meta, x], 1)
    positions = torch.arange(S + M, device=x.device)
    for bp, w in zip(model.blocks, layer_windows(cfg)):
        x = L.remat(cfg, functools.partial(
            block_apply, cfg, bp, window=w if w < S + M else None,
            positions=positions), x, block=bp)
    x = L.norm_apply(cfg, model.ln_f, x)[:, M:]
    if last_only:
        x = x[:, -1:, :]
    if return_hidden:
        return x, {}
    return L.logits_head(cfg, model.head, model.embed, x), {}


def loss_fn(cfg: ArchConfig, model: HymbaLM, batch: dict):
    """Chunked next-token cross entropy over the token positions (the meta
    tokens carry no loss) -> (loss, {"nll": loss})."""
    hidden, _ = forward(cfg, model, batch, return_hidden=True)
    labels, mask = L.shifted_labels(batch["tokens"])
    loss = L.lm_loss_from_hidden(cfg, model.head, model.embed, hidden,
                                 labels, mask)
    return loss, {"nll": loss}


# ---------------------------------------------------------------- decode ---
def init_decode_cache(cfg: ArchConfig, B: int, max_seq: int, device) -> dict:
    """Per layer ``(Tagged(kind, entry), {"conv", "state"})``: a paged pool
    of ``max_seq + n_meta_tokens`` positions on the global layers, a ring
    of ``window`` positions on every other (whatever ``max_seq`` is).
    Under tensor parallelism ``conv`` and ``state`` hold this rank's
    channels of d_inner (the reference's cache axes split them over
    ``model``).  The reference also returns the cache's sharding axes,
    which have no counterpart here."""
    di = tp.local_size(2 * cfg.d_model)
    g = _global_layers(cfg)
    w = cfg.window or 1024
    total = max_seq + cfg.n_meta_tokens
    layers = []
    for i in range(cfg.n_layers):
        attn = (Tagged("paged", T._paged_spec(cfg, B, total, device))
                if i in g else Tagged("ring", T._ring_spec(cfg, B, w, device)))
        ssm = {"conv": torch.zeros((B, CONV_K - 1, di),
                                   dtype=cfg.compute_dtype, device=device),
               "state": torch.zeros((B, di, cfg.ssm_state),
                                    dtype=torch.float32, device=device)}
        layers.append((attn, ssm))
    return {"seq_lens": torch.zeros((B,), dtype=torch.int32, device=device),
            "layers": tuple(layers)}


@torch.no_grad()
def decode_embed_step(cfg: ArchConfig, model: HymbaLM, cache: dict,
                      x: torch.Tensor):
    """One decode step on an embedded input x: (B, 1, D) -> (x', cache')."""
    pos = cache["seq_lens"]
    new_layers = []
    for bp, (tagged, ssm) in zip(model.blocks, cache["layers"]):
        xn = L.norm_apply(cfg, bp.ln1, x)
        attn = T._decode_attn_ring if tagged.kind == "ring" \
            else T._decode_attn_paged
        h_attn, entry2 = attn(cfg, bp.attn, xn, tagged.value, pos)
        h_ssm, (conv2, state2) = mamba_apply(
            cfg, bp.mamba, xn, conv_state=ssm["conv"],
            ssm_state=ssm["state"])
        x = x + _fuse(bp, h_attn, h_ssm)
        x = x + L.mlp(cfg, bp.mlp, L.norm_apply(cfg, bp.ln2, x))
        new_layers.append((Tagged(tagged.kind, entry2),
                           {"conv": conv2, "state": state2}))
    cache2 = dict(cache)
    cache2["layers"] = tuple(new_layers)
    cache2["seq_lens"] = pos + 1
    return x, cache2


@torch.no_grad()
def prime_cache(cfg: ArchConfig, model: HymbaLM, cache: dict) -> dict:
    """Run the meta tokens through the cache before any prompt token: they
    are positions 0..M-1 of every sequence."""
    B = cache["seq_lens"].shape[0]
    for m in range(cfg.n_meta_tokens):
        x = model.meta[m].to(cfg.compute_dtype)[None, None].expand(
            B, 1, cfg.d_model)
        _, cache = decode_embed_step(cfg, model, cache, x)
    return cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, model: HymbaLM, cache: dict,
                tokens: torch.Tensor):
    """tokens: (B,) int -> (logits (B, V), cache')."""
    x = L.embed(cfg, model.embed, tokens[:, None])
    x, cache2 = decode_embed_step(cfg, model, cache, x)
    x = L.norm_apply(cfg, model.ln_f, x)
    return L.logits_head(cfg, model.head, model.embed, x)[:, 0, :], cache2
