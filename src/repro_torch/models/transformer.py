"""Decoder-only and encoder-decoder transformer LMs with a hybrid decode
cache.

Port of ``repro.models.transformer`` for the dense, MoE, VLM and audio
families: ``forward`` (full sequence through the flash-attention kernel;
VLM patch embeddings prepended, learned positions added, whisper's
cross-attention over ``encode``'s output, MoE aux losses summed over
layers), ``encode``, ``loss_fn`` (chunked next-token cross entropy with the MoE
aux terms), ``init_decode_cache`` (a ring for every layer whose
window is under ``max_seq``, a BaM-paged pool for every other, and the
enc-dec cross-attention KV ``xkv``), ``_decode_attn_ring``,
``_decode_attn_paged`` (through the paged-attention kernel),
``_decode_xattn``, ``decode_step`` and ``prefill`` (a loop over
``decode_step``, as the reference's).  The ring and cross-attention decode
are plain torch: the reference computes them in jnp, outside any kernel.

Blocks are an ``nn.ModuleList`` (the reference stacks them on a leading
axis and scans).  PyTorch runs eagerly, so ``decode_step`` writes the new
token's K/V into the pools and rings in place, where the reference returns
new arrays: the returned cache shares those tensors with the one passed in.

Not ported (``NotImplementedError``): ``flash_decode_shards``, the
reference's ``shard_map`` flash-decoding over a device mesh, which waits
for ``distributed/`` (``ROADMAP.md`` §1).
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.utils import Tagged

BIG_WINDOW = 1 << 30
FAMILIES = ("dense", "moe", "vlm", "audio")


def check_supported(cfg: ArchConfig, families=FAMILIES) -> None:
    """Raise for a family outside ``families`` and for the parts of the
    reference's decode not ported yet."""
    missing = []
    if cfg.family not in families:
        missing.append(f"family {cfg.family!r}")
    if cfg.flash_decode_shards:
        missing.append("flash_decode_shards (shard_map over a mesh)")
    if missing:
        raise NotImplementedError(
            f"repro_torch does not port {', '.join(missing)} yet "
            "(ROADMAP.md §1)")


class Block(nn.Module):
    """Self-attention and an MLP (or MoE); with ``cfg.enc_dec`` also a
    cross-attention (``ln_x``, ``xattn``, built without QKV bias)."""

    def __init__(self, cfg: ArchConfig, *, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1 = L.Norm(cfg, cfg.d_model, **kw)
        self.attn = L.Attention(cfg, **kw)
        self.ln2 = L.Norm(cfg, cfg.d_model, **kw)
        self.mlp = None if cfg.moe else L.MLP(cfg, **kw)
        self.moe = L.MoE(cfg, **kw) if cfg.moe else None
        self.ln_x = L.Norm(cfg, cfg.d_model, **kw) if cfg.enc_dec else None
        self.xattn = (L.Attention(cfg.replace(qkv_bias=False), **kw)
                      if cfg.enc_dec else None)


class TransformerLM(nn.Module):
    """Embedding, ``n_layers`` blocks, final norm and (untied) head; a
    learned position table of ``max(max_seq, 1024)`` rows; with
    ``cfg.enc_dec`` the encoder's blocks, positions ``(enc_seq, D)`` and
    final norm.  Parameters are allocated uninitialised; fill them with
    :func:`repro_torch.models.layers.init_random_` or
    :func:`repro_torch.interop.params_from_numpy`."""

    def __init__(self, cfg: ArchConfig, *, max_seq: int = 0, dtype=None,
                 device=None):
        super().__init__()
        check_supported(cfg)
        dtype = dtype or cfg.compute_dtype
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.embed = L.Embedding(cfg, **kw)
        self.blocks = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.Norm(cfg, cfg.d_model, **kw)
        self.head = (None if cfg.tie_embeddings
                     else L.Dense(cfg.d_model, cfg.vocab, **kw))
        self.pos = (L.LearnedPositions(max(max_seq, 1024), cfg.d_model, **kw)
                    if cfg.pos_emb == "learned" else None)
        self.enc_blocks = self.enc_pos = self.enc_ln_f = None
        if cfg.enc_dec:
            enc_cfg = cfg.replace(moe=False, enc_dec=False)
            self.enc_blocks = nn.ModuleList(
                Block(enc_cfg, **kw) for _ in range(cfg.n_enc_layers))
            self.enc_pos = L.LearnedPositions(cfg.enc_seq, cfg.d_model, **kw)
            self.enc_ln_f = L.Norm(cfg, cfg.d_model, **kw)


def _positions(table: L.LearnedPositions, n: int) -> torch.Tensor:
    """The first ``n`` rows of a learned table; past its end raises (the
    reference's slice would come up short)."""
    if n > table.table.shape[0]:
        raise ValueError(f"{n} positions but the learned table has "
                         f"{table.table.shape[0]} rows")
    return table.table[:n]


# ---------------------------------------------------------------- forward ---
def _ffn(cfg: ArchConfig, bp: Block, x: torch.Tensor):
    """The block's feed-forward on the normed ``x``: (y, aux)."""
    if bp.moe is not None:
        return L.moe_ffn(cfg, bp.moe, x)
    return L.mlp(cfg, bp.mlp, x), {}


def _cross_attention(cfg: ArchConfig, p: L.Attention, xq: torch.Tensor,
                     enc_out: torch.Tensor) -> torch.Tensor:
    """Full-sequence cross-attention: queries from the decoder, keys and
    values from the encoder's output, no mask, no positions."""
    B, S, _ = xq.shape
    dtype, hd = cfg.compute_dtype, cfg.hd
    q = L.dense(p.wq, xq, dtype).reshape(B, S, cfg.n_heads, hd)
    k = L.dense(p.wk, enc_out, dtype).reshape(B, -1, cfg.n_kv_heads, hd)
    v = L.dense(p.wv, enc_out, dtype).reshape(B, -1, cfg.n_kv_heads, hd)
    o = ops.flash_attention(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(), causal=False)
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * hd)
    return L.dense(p.wo, o, dtype)


def _block(cfg: ArchConfig, bp: Block, x, *, window, positions, causal,
           enc_out):
    """One block: (x', aux)."""
    x = x + L.attention(cfg, bp.attn, L.norm_apply(cfg, bp.ln1, x),
                        window=window, positions=positions, causal=causal)
    if enc_out is not None:
        x = x + _cross_attention(cfg, bp.xattn,
                                 L.norm_apply(cfg, bp.ln_x, x), enc_out)
    y, aux = _ffn(cfg, bp, L.norm_apply(cfg, bp.ln2, x))
    return x + y, aux


def _run_blocks(cfg: ArchConfig, blocks, x, windows, *, causal=True,
                enc_out=None):
    """The blocks in order (the reference's ``_scan_blocks``), each under
    :func:`layers.remat`; MoE aux losses summed over layers."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    aux = {}
    for bp, w in zip(blocks, windows):
        # a window of S or more masks nothing: run the layer as global
        fn = functools.partial(_block, cfg, bp, window=w if w < S else None,
                               positions=positions, causal=causal,
                               enc_out=enc_out)
        x, aux_l = L.remat(cfg, fn, x)
        for k, v in aux_l.items():
            aux[k] = aux[k] + v if k in aux else v
    return x, aux


def encode(cfg: ArchConfig, model: TransformerLM, frames: torch.Tensor):
    """Whisper-style encoder over precomputed frame embeddings (the stub
    frontend): frames (B, Senc, D) -> (B, Senc, D)."""
    x = frames.to(cfg.compute_dtype)
    S = x.shape[1]
    x = x + _positions(model.enc_pos, S).to(cfg.compute_dtype)
    x, _ = _run_blocks(cfg, model.enc_blocks, x,
                       [BIG_WINDOW] * cfg.n_enc_layers, causal=False)
    return L.norm_apply(cfg, model.enc_ln_f, x)


def forward(cfg: ArchConfig, model: TransformerLM, batch: dict, *,
            return_hidden: bool = False):
    """Full-sequence forward -> (logits (B, S, V), aux), or with
    ``return_hidden`` the final-normed hidden states (B, S, D) in place of
    the logits.

    batch: ``tokens`` (B, S[text]) int; optional ``patch_embeds``
    (B, P, D) (VLM, prepended) and ``enc_frames`` (B, Senc, D) (audio).
    aux holds the MoE losses summed over layers (empty otherwise)."""
    x = L.embed(cfg, model.embed, batch["tokens"])
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(cfg.compute_dtype), x], 1)
    S = x.shape[1]
    if cfg.pos_emb == "learned":
        x = x + _positions(model.pos, S).to(cfg.compute_dtype)
    enc_out = None
    if cfg.enc_dec:
        enc_out = encode(cfg, model, batch["enc_frames"])
    x, aux = _run_blocks(cfg, model.blocks, x, cfg.layer_windows(S),
                         causal=True, enc_out=enc_out)
    x = L.norm_apply(cfg, model.ln_f, x)
    if return_hidden:
        return x, aux
    return L.logits_head(cfg, model.head, model.embed, x), aux


def loss_fn(cfg: ArchConfig, model: TransformerLM, batch: dict):
    """Next-token cross entropy, chunked over the sequence so the (B, S, V)
    logits never exist (plus, for MoE, 0.01 of the load-balance loss and
    1e-3 of the router z-loss, each averaged over layers) -> (loss,
    metrics).  A VLM's patch positions are cut before the loss; with no
    ``labels`` in the batch the labels are the tokens shifted by one."""
    hidden, aux = forward(cfg, model, batch, return_hidden=True)
    tokens = batch["tokens"]
    n_prefix = hidden.shape[1] - tokens.shape[1]    # vlm patches prepended
    labels = batch.get("labels")
    if labels is None:
        labels, mask = L.shifted_labels(tokens)
    else:
        mask = batch.get("loss_mask", torch.ones_like(labels,
                                                      dtype=torch.float32))
    loss = L.lm_loss_from_hidden(cfg, model.head, model.embed,
                                 hidden[:, n_prefix:], labels, mask)
    metrics = {"nll": loss}
    if cfg.moe:
        lb = aux["load_balance"] / cfg.n_layers
        z = aux["router_z"] / cfg.n_layers
        metrics.update(load_balance=lb, router_z=z)
        loss = loss + 0.01 * lb + 1e-3 * z
    return loss, metrics


# ========================================================== decode caches ==
def _ring_spec(cfg: ArchConfig, B: int, W: int, device) -> dict:
    shape = (B, cfg.n_kv_heads, W, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "pos": torch.full((B, W), -1, dtype=torch.int32, device=device),
    }


def _paged_spec(cfg: ArchConfig, B: int, max_seq: int, device) -> dict:
    page = cfg.kv_page_size
    n_pages = -(-max_seq // page)
    shape = (B, n_pages, page, cfg.n_kv_heads, cfg.hd)
    table = torch.arange(n_pages, dtype=torch.int32, device=device)
    return {
        "k_pages": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "v_pages": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        # identity mapping at init; the indirection is the BaM page table
        "page_table": table[None].repeat(B, 1),
    }


def init_decode_cache(cfg: ArchConfig, B: int, max_seq: int, device) -> dict:
    """Hybrid cache: a ring for every layer whose window is under
    ``max_seq``, a BaM-paged pool for every other; with ``cfg.enc_dec``
    also ``xkv`` (n_layers, 2, B, Hkv, enc_seq, hd), zeros until
    :func:`prefill` fills it.  The reference also returns the cache's
    sharding axes, which have no counterpart here."""
    check_supported(cfg)
    layers = []
    for w in cfg.layer_windows(max_seq):
        if w < max_seq:                       # sliding-window layer
            layers.append(Tagged("ring", _ring_spec(cfg, B, w, device)))
        else:
            layers.append(Tagged("paged",
                                 _paged_spec(cfg, B, max_seq, device)))
    cache = {
        "seq_lens": torch.zeros((B,), dtype=torch.int32, device=device),
        "layers": tuple(layers),
    }
    if cfg.enc_dec:
        cache["xkv"] = torch.zeros(
            (cfg.n_layers, 2, B, cfg.n_kv_heads, cfg.enc_seq, cfg.hd),
            dtype=cfg.compute_dtype, device=device)
    return cache


def _decode_qkv(cfg: ArchConfig, p: L.Attention, xq: torch.Tensor,
                pos: torch.Tensor):
    """q (B, Hq, 1, hd), k and v (B, Hkv, 1, hd) of one new token per
    sequence at positions ``pos`` (B,)."""
    B = xq.shape[0]
    dtype, hd = cfg.compute_dtype, cfg.hd
    q = L.dense(p.wq, xq, dtype).reshape(B, 1, cfg.n_heads, hd)
    k = L.dense(p.wk, xq, dtype).reshape(B, 1, cfg.n_kv_heads, hd)
    v = L.dense(p.wv, xq, dtype).reshape(B, 1, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = L.rms_norm_simple(q, p.q_norm)
        k = L.rms_norm_simple(k, p.k_norm)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if cfg.pos_emb == "rope":
        pb = pos[:, None]
        q = L.rope(q, pb[:, None, :], cfg.rope_theta)
        k = L.rope(k, pb[:, None, :], cfg.rope_theta)
    return q, k, v


def _decode_attn_ring(cfg: ArchConfig, p: L.Attention, xq: torch.Tensor,
                      entry: dict, pos: torch.Tensor):
    """xq: (B, 1, D) normed input; the new token goes to ring slot
    ``pos % W`` and attends over the live slots (position in
    ``(pos - W, pos]``), in f32 with -1e30 for masked scores, as the
    reference.  Returns (B, 1, D) and the entry, written in place."""
    B = xq.shape[0]
    dtype, hd = cfg.compute_dtype, cfg.hd
    q, k, v = _decode_qkv(cfg, p, xq, pos)
    k_ring, v_ring, ring_pos = entry["k"], entry["v"], entry["pos"]
    W = k_ring.shape[2]
    slot = (pos % W).long()
    bidx = torch.arange(B, device=pos.device)
    k_ring[bidx, :, slot] = k[:, :, 0]
    v_ring[bidx, :, slot] = v[:, :, 0]
    ring_pos[bidx, slot] = pos

    qg = q.reshape(B, cfg.n_kv_heads, cfg.group, hd).float()
    s = torch.einsum("bkgd,bkwd->bkgw", qg, k_ring.float()) / math.sqrt(hd)
    pc = pos[:, None]
    valid = (ring_pos >= 0) & (ring_pos > pc - W) & (ring_pos <= pc)
    s = s.masked_fill(~valid[:, None, None, :], -1e30)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgw,bkwd->bkgd", pr, v_ring.float())
    o = o.reshape(B, 1, cfg.n_heads * hd).to(dtype)
    return L.dense(p.wo, o, dtype), entry


def _decode_attn_paged(cfg: ArchConfig, p: L.Attention, xq: torch.Tensor,
                       entry: dict, pos: torch.Tensor):
    """xq: (B, 1, D) normed input; returns the attention output (B, 1, D)
    and the entry with the new token's K/V written into its pools."""
    B = xq.shape[0]
    dtype, hd = cfg.compute_dtype, cfg.hd
    q, k, v = _decode_qkv(cfg, p, xq, pos)
    k_pages, v_pages = entry["k_pages"], entry["v_pages"]
    page_table = entry["page_table"]
    page = k_pages.shape[2]
    posl = pos.long()
    bidx = torch.arange(B, device=pos.device)
    # a hole (-1) at the token's logical page writes into physical page 0,
    # exactly as the reference's max(page_table, 0)
    ppage = page_table[bidx, posl // page].clamp(min=0).long()
    k_pages[bidx, ppage, posl % page] = k[:, :, 0]
    v_pages[bidx, ppage, posl % page] = v[:, :, 0]

    o = ops.paged_attention(q[:, :, 0].contiguous(), k_pages, v_pages,
                            page_table, pos + 1)              # (B, Hq, hd)
    o = o.reshape(B, 1, cfg.n_heads * hd)
    out = L.dense(p.wo, o.to(dtype), dtype)
    return out, {"k_pages": k_pages, "v_pages": v_pages,
                 "page_table": page_table}


def _decode_xattn(cfg: ArchConfig, p: L.Attention, xq: torch.Tensor,
                  xkv_l: torch.Tensor) -> torch.Tensor:
    """Cross-attention for decode in f32; xkv_l: (2, B, Hkv, Senc, hd)."""
    B = xq.shape[0]
    dtype, hd = cfg.compute_dtype, cfg.hd
    q = L.dense(p.wq, xq, dtype).reshape(B, cfg.n_kv_heads, cfg.group, hd)
    k, v = xkv_l[0], xkv_l[1]
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), k.float()) / math.sqrt(hd)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", pr, v.float())
    o = o.reshape(B, 1, cfg.n_heads * hd).to(dtype)
    return L.dense(p.wo, o, dtype)


@torch.no_grad()
def decode_step(cfg: ArchConfig, model: TransformerLM, cache: dict,
                tokens: torch.Tensor):
    """One decode step.  tokens: (B,) int, the tokens generated at the
    previous step.  Returns (logits (B, V), cache').  With learned
    positions a position past the table raises (one host read of the
    largest position a step)."""
    pos = cache["seq_lens"]                                  # (B,) int32
    x = L.embed(cfg, model.embed, tokens[:, None])           # (B, 1, D)
    if cfg.pos_emb == "learned":
        rows = _positions(model.pos, int(pos.max()) + 1)
        x = x + rows[pos.long()][:, None].to(cfg.compute_dtype)
    new_layers = []
    for i, (bp, tagged) in enumerate(zip(model.blocks, cache["layers"])):
        xq = L.norm_apply(cfg, bp.ln1, x)
        attn = _decode_attn_ring if tagged.kind == "ring" \
            else _decode_attn_paged
        h, entry2 = attn(cfg, bp.attn, xq, tagged.value, pos)
        x = x + h
        if cfg.enc_dec:
            x = x + _decode_xattn(cfg, bp.xattn,
                                  L.norm_apply(cfg, bp.ln_x, x),
                                  cache["xkv"][i])
        y, _ = _ffn(cfg, bp, L.norm_apply(cfg, bp.ln2, x))
        x = x + y
        new_layers.append(Tagged(tagged.kind, entry2))
    x = L.norm_apply(cfg, model.ln_f, x)
    logits = L.logits_head(cfg, model.head, model.embed, x)
    cache2 = dict(cache)
    cache2["layers"] = tuple(new_layers)
    cache2["seq_lens"] = pos + 1
    return logits[:, 0, :], cache2


@torch.no_grad()
def prefill(cfg: ArchConfig, model: TransformerLM, batch: dict,
            max_seq: int):
    """Encode once and fill ``xkv`` (enc-dec), then run the prompt token by
    token through ``decode_step`` (exact, as the reference) and return
    (last-token logits, filled cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = init_decode_cache(cfg, B, max_seq, tokens.device)
    if cfg.enc_dec:
        enc_out = encode(cfg, model, batch["enc_frames"])
        dtype, hd = cfg.compute_dtype, cfg.hd
        xkv = []
        for bp in model.blocks:
            k = L.dense(bp.xattn.wk, enc_out, dtype).reshape(
                B, -1, cfg.n_kv_heads, hd).transpose(1, 2)
            v = L.dense(bp.xattn.wv, enc_out, dtype).reshape(
                B, -1, cfg.n_kv_heads, hd).transpose(1, 2)
            xkv.append(torch.stack([k, v]))
        cache["xkv"] = torch.stack(xkv)
    logits = None
    for t in range(S):
        logits, cache = decode_step(cfg, model, cache, tokens[:, t])
    return logits, cache
