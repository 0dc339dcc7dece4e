"""Decoder-only transformer LM with a BaM-paged decode cache.

Port of ``repro.models.transformer`` for the dense decoder-only family:
``forward`` (full sequence, through the flash-attention kernel),
``init_decode_cache`` / ``_paged_spec``, ``_decode_attn_paged`` (one token
per sequence over the paged pool, through the paged-attention kernel),
``decode_step`` and ``prefill`` (a loop over ``decode_step``, as the
reference's).  Every layer of the configs ported here is global, so every
layer's decode goes through the paged pool.

Blocks are an ``nn.ModuleList`` (the reference stacks them on a leading
axis and scans).  PyTorch runs eagerly, so ``decode_step`` writes the new
token's K/V into the pools in place, where the reference returns new
arrays: the returned cache shares the pool tensors with the one passed in.

Not in this slice (``NotImplementedError``, ``ROADMAP.md`` §1 step 8):
sliding-window ring layers (``_decode_attn_ring``), MoE, enc-dec, VLM,
learned positions and ``flash_decode_shards``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.utils import Tagged

BIG_WINDOW = 1 << 30


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the parts of the reference's transformer not ported yet."""
    missing = []
    if cfg.family not in ("dense",):
        missing.append(f"family {cfg.family!r}")
    if cfg.moe:
        missing.append("MoE blocks")
    if cfg.enc_dec:
        missing.append("enc-dec")
    if cfg.pos_emb not in ("rope", "none"):
        missing.append(f"{cfg.pos_emb} positions")
    if cfg.flash_decode_shards:
        missing.append("flash_decode_shards")
    if missing:
        raise NotImplementedError(
            f"repro_torch does not port {', '.join(missing)} yet "
            "(ROADMAP.md §1 step 8)")


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1 = L.Norm(cfg, cfg.d_model, **kw)
        self.attn = L.Attention(cfg, **kw)
        self.ln2 = L.Norm(cfg, cfg.d_model, **kw)
        self.mlp = L.MLP(cfg, **kw)


class TransformerLM(nn.Module):
    """Embedding, ``n_layers`` blocks, final norm and (untied) head.
    Parameters are allocated uninitialised; fill them with
    :func:`repro_torch.models.layers.init_random_` or
    :func:`repro_torch.interop.params_from_numpy`."""

    def __init__(self, cfg: ArchConfig, *, dtype=None, device=None):
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


# ---------------------------------------------------------------- forward ---
@torch.no_grad()
def forward(cfg: ArchConfig, model: TransformerLM, batch: dict):
    """Full-sequence forward -> (logits (B, S, V), aux).  batch: ``tokens``
    (B, S) int."""
    tokens = batch["tokens"]
    x = L.embed(cfg, model.embed, tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    for bp, w in zip(model.blocks, cfg.layer_windows(S)):
        # a window of S or more masks nothing: run the layer as global
        x = x + L.attention(cfg, bp.attn, L.norm_apply(cfg, bp.ln1, x),
                            window=w if w < S else None,
                            positions=positions, causal=True)
        x = x + L.mlp(cfg, bp.mlp, L.norm_apply(cfg, bp.ln2, x))
    x = L.norm_apply(cfg, model.ln_f, x)
    return L.logits_head(cfg, model.head, model.embed, x), {}


# ========================================================== decode caches ==
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
    """BaM-paged pools for every (global) layer.  The reference also returns
    the cache's sharding axes, which have no counterpart here."""
    check_supported(cfg)
    windows = cfg.layer_windows(max_seq)
    if any(w < max_seq for w in windows):
        raise NotImplementedError(
            "sliding-window (ring) decode layers are not ported to "
            "repro_torch yet (ROADMAP.md §1 step 8)")
    return {
        "seq_lens": torch.zeros((B,), dtype=torch.int32, device=device),
        "layers": tuple(Tagged("paged", _paged_spec(cfg, B, max_seq, device))
                        for _ in windows),
    }


def _decode_attn_paged(cfg: ArchConfig, p: L.Attention, xq: torch.Tensor,
                       entry: dict, pos: torch.Tensor):
    """xq: (B, 1, D) normed input; returns the attention output (B, 1, D)
    and the entry with the new token's K/V written into its pools."""
    B = xq.shape[0]
    dtype = cfg.compute_dtype
    hd = cfg.hd
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


@torch.no_grad()
def decode_step(cfg: ArchConfig, model: TransformerLM, cache: dict,
                tokens: torch.Tensor):
    """One decode step.  tokens: (B,) int, the tokens generated at the
    previous step.  Returns (logits (B, V), cache')."""
    pos = cache["seq_lens"]                                  # (B,) int32
    x = L.embed(cfg, model.embed, tokens[:, None])           # (B, 1, D)
    new_layers = []
    for bp, tagged in zip(model.blocks, cache["layers"]):
        if tagged.kind != "paged":
            raise NotImplementedError(
                f"{tagged.kind!r} decode layers are not ported yet")
        xq = L.norm_apply(cfg, bp.ln1, x)
        h, entry2 = _decode_attn_paged(cfg, bp.attn, xq, tagged.value, pos)
        x = x + h
        x = x + L.mlp(cfg, bp.mlp, L.norm_apply(cfg, bp.ln2, x))
        new_layers.append(Tagged("paged", entry2))
    x = L.norm_apply(cfg, model.ln_f, x)
    logits = L.logits_head(cfg, model.head, model.embed, x)
    cache2 = dict(cache)
    cache2["layers"] = tuple(new_layers)
    cache2["seq_lens"] = pos + 1
    return logits[:, 0, :], cache2


def prefill(cfg: ArchConfig, model: TransformerLM, batch: dict,
            max_seq: int):
    """Run the prompt token by token through ``decode_step`` (exact, as the
    reference) and return (last-token logits, filled cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = init_decode_cache(cfg, B, max_seq, tokens.device)
    logits = None
    for t in range(S):
        logits, cache = decode_step(cfg, model, cache, tokens[:, t])
    return logits, cache
