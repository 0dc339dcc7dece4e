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

With ``cfg.flash_decode_shards`` under an active mesh with a ``model`` axis
(``repro_torch.distributed.sharding.activate``), the paged layers decode
shard-locally, as the reference's ``_paged_attention_flash_decode``: each
model rank holds ``P / n`` physical pages of every pool (``kv_pages ->
model``; ``init_decode_cache`` makes the pools DTensors split on the page
axis), only the rank that owns a token's page writes its K/V, each rank
attends over its own pages through the paged kernel (the pages it does not
own set to -1) and the ranks' partial results are combined by their
log-sum-exp (:func:`combine_shards`: an all-reduce MAX and a SUM).  The
batch stays whole on every model rank.  On the CPU the shard-local part is
the paged kernel's plain version with its log-sum-exp.

Under :func:`repro_torch.distributed.tensor_parallel.activate`, on a local
copy of the model, the forward and the encoder compute tensor-parallel
over ``model`` (:mod:`repro_torch.models.layers`), the cross-attention
too; ``decode_step`` computes q, k and v column-parallel and gathers them
to whole heads (one token: cheap), attends exactly as without it (the
paged kernel on whole pools, shard-local flash-decoding, the rings), and
runs ``wo``, the MLP or the experts and the head row-, column- and
vocab-parallel, the logits gathered to (B, V).
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.utils import Tagged

BIG_WINDOW = 1 << 30
FAMILIES = ("dense", "moe", "vlm", "audio")


def check_supported(cfg: ArchConfig, families=FAMILIES) -> None:
    """Raise for a family outside ``families``."""
    if cfg.family not in families:
        raise NotImplementedError(
            f"family {cfg.family!r} is not one of {families}")


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
    return L.attend(cfg, p, xq, enc_out, None, causal=False, window=None)


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
            last_only: bool = False, return_hidden: bool = False):
    """Full-sequence forward -> (logits (B, S, V), aux), or with
    ``return_hidden`` the final-normed hidden states (B, S, D) in place of
    the logits; with ``last_only`` only the last position's (S = 1).

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
    if last_only:
        x = x[:, -1:, :]
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
    mesh = _flash_decode_mesh(cfg)

    def pool():
        t = torch.zeros(shape, dtype=cfg.compute_dtype, device=device)
        if mesh is None:
            return t
        # kv_pages -> model: this rank keeps its P / n pages
        return shd.shard(t, shd.NamedSharding(mesh, POOL_SPEC))

    return {
        "k_pages": pool(),
        "v_pages": pool(),
        # identity mapping at init; the indirection is the BaM page table
        "page_table": table[None].repeat(B, 1),
    }


POOL_SPEC = (None, "model", None, None, None)   # (B, P, page, Hkv, D)


def _flash_decode_mesh(cfg: ArchConfig):
    """The active mesh when paged decode runs shard-locally on it
    (``flash_decode_shards`` and a ``model`` axis), else None."""
    mesh = shd.current_mesh()
    if cfg.flash_decode_shards and mesh is not None \
            and "model" in (mesh.mesh_dim_names or ()):
        return mesh
    return None


def _local_pool(pool: torch.Tensor, mesh):
    """This model rank's pages of a pool (a DTensor split as ``POOL_SPEC``,
    as ``init_decode_cache`` makes it under the mesh) and the first one's
    global index."""
    from torch.distributed.tensor import DTensor

    if not isinstance(pool, DTensor) or shd.spec_of(pool) != POOL_SPEC:
        raise ValueError(
            f"flash_decode_shards takes pools split as {POOL_SPEC}, not "
            f"{shd.spec_of(pool) if isinstance(pool, DTensor) else 'whole'}"
            ": make the cache with init_decode_cache under the mesh")
    loc = pool.to_local()
    return loc, mesh.get_local_rank("model") * loc.shape[1]


def combine_shards(o: torch.Tensor, lse: torch.Tensor, reduce_max,
                   reduce_sum) -> torch.Tensor:
    """Combine partial attention outputs ``o`` (B, Hq, D) over disjoint
    sets of keys by their log-sum-exp ``lse`` (B, Hq; -inf where a part has
    no live key): with M the largest lse (``reduce_max``) each part weighs
    ``w = exp(lse - M)``, and ``out = sum w o / max(sum w, 1e-30)`` in
    f32, cast to o's dtype; the two sums are one ``reduce_sum`` of
    ``[w o, w]``.  A part with no live key weighs 0, and a row with none
    anywhere gives 0.  The reductions are all-reduces over the model ranks,
    or reductions over a stacked leading axis when emulating the shards on
    one device."""
    M = reduce_max(lse)
    M = torch.where(torch.isfinite(M), M, torch.zeros_like(M))
    w = torch.exp(lse - M)[..., None]
    acc = reduce_sum(torch.cat([o.float() * w, w], -1))
    return (acc[..., :-1] / torch.clamp(acc[..., -1:], min=1e-30)).to(o.dtype)


def _paged_attention_flash_decode(cfg: ArchConfig, q: torch.Tensor,
                                  k_pages: torch.Tensor,
                                  v_pages: torch.Tensor,
                                  page_table: torch.Tensor,
                                  seq_lens: torch.Tensor, mesh):
    """Shard-local flash-decoding over the model-striped page pool: each
    model rank attends over the physical pages it owns and the partial
    softmax states are combined over the ``model`` axis.  q (B, Hq, D);
    pools DTensors split on the page axis; page_table (B, NP) global
    physical pages, -1 a hole; seq_lens (B,).  Returns (B, Hq, D) in q's
    dtype, the same on every model rank.  Each rank runs
    ``ops.paged_attention`` with its log-sum-exp (on CUDA the hand-written
    paged kernel) over its own pages, the others -1, and
    :func:`combine_shards` joins the ranks by all-reduces.  Collective
    payload per step: O(B x Hq x D), not O(pool)."""
    import torch.distributed as dist

    group = mesh.get_group("model")
    kp, base = _local_pool(k_pages, mesh)
    vp, _ = _local_pool(v_pages, mesh)
    p_loc = kp.shape[1]
    mine = (page_table >= base) & (page_table < base + p_loc)   # (B, NP)

    def reduce(op):
        def f(t):
            t = t.clone()
            dist.all_reduce(t, op=op, group=group)
            return t
        return f

    pt = torch.where(mine, page_table - base, -1).to(torch.int32)
    o, lse = ops.paged_attention(q.contiguous(), kp.contiguous(),
                                 vp.contiguous(), pt, seq_lens,
                                 return_lse=True)
    return combine_shards(o, lse, reduce(dist.ReduceOp.MAX),
                          reduce(dist.ReduceOp.SUM))


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
    H, Hkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    q = L.column_whole(p.wq, xq, dtype, H).reshape(B, 1, cfg.n_heads, hd)
    k = L.column_whole(p.wk, xq, dtype, Hkv).reshape(B, 1, cfg.n_kv_heads,
                                                     hd)
    v = L.column_whole(p.wv, xq, dtype, Hkv).reshape(B, 1, cfg.n_kv_heads,
                                                     hd)
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
    return L.row_parallel(p.wo, o, dtype, cfg.n_heads * hd), entry


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
    mesh = _flash_decode_mesh(cfg)
    if mesh is None:
        k_pages[bidx, ppage, posl % page] = k[:, :, 0]
        v_pages[bidx, ppage, posl % page] = v[:, :, 0]
        o = ops.paged_attention(q[:, :, 0].contiguous(), k_pages, v_pages,
                                page_table, pos + 1)          # (B, Hq, hd)
    else:
        # only the rank that owns the token's physical page writes it; the
        # other rows write back what their (clamped) slot holds, so no
        # count of owned rows has to reach the host
        kp, base = _local_pool(k_pages, mesh)
        vp, _ = _local_pool(v_pages, mesh)
        p_loc = kp.shape[1]
        own = ((ppage >= base) & (ppage < base + p_loc))[:, None, None]
        lp, slot = (ppage - base).clamp(0, p_loc - 1), posl % page
        kp[bidx, lp, slot] = torch.where(own, k[:, :, 0], kp[bidx, lp, slot])
        vp[bidx, lp, slot] = torch.where(own, v[:, :, 0], vp[bidx, lp, slot])
        o = _paged_attention_flash_decode(cfg, q[:, :, 0], k_pages, v_pages,
                                          page_table, pos + 1, mesh)
    o = o.reshape(B, 1, cfg.n_heads * hd)
    out = L.row_parallel(p.wo, o.to(dtype), dtype, cfg.n_heads * hd)
    return out, {"k_pages": k_pages, "v_pages": v_pages,
                 "page_table": page_table}


def _decode_xattn(cfg: ArchConfig, p: L.Attention, xq: torch.Tensor,
                  xkv_l: torch.Tensor) -> torch.Tensor:
    """Cross-attention for decode in f32; xkv_l: (2, B, Hkv, Senc, hd)."""
    B = xq.shape[0]
    dtype, hd = cfg.compute_dtype, cfg.hd
    q = L.column_whole(p.wq, xq, dtype, cfg.n_heads * hd).reshape(
        B, cfg.n_kv_heads, cfg.group, hd)
    k, v = xkv_l[0], xkv_l[1]
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), k.float()) / math.sqrt(hd)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", pr, v.float())
    o = o.reshape(B, 1, cfg.n_heads * hd).to(dtype)
    return L.row_parallel(p.wo, o, dtype, cfg.n_heads * hd)


@torch.no_grad()
def decode_step(cfg: ArchConfig, model: TransformerLM, cache: dict,
                tokens: torch.Tensor):
    """One decode step.  tokens: (B,) int, the tokens generated at the
    previous step.  Returns (logits (B, V), cache').  With learned
    positions a position past the table raises: the row gather's own
    bounds check, read nothing back to the host (on the CPU a
    ``ValueError`` at once, on the card the index kernel's device-side
    assert)."""
    pos = cache["seq_lens"]                                  # (B,) int32
    x = L.embed(cfg, model.embed, tokens[:, None])           # (B, 1, D)
    if cfg.pos_emb == "learned":
        table = model.pos.table
        try:
            rows = table[pos.long()]
        except IndexError as e:
            raise ValueError(f"a position past the learned table of "
                             f"{table.shape[0]} rows") from e
        x = x + rows[:, None].to(cfg.compute_dtype)
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
        Hkv = cfg.n_kv_heads * hd
        for bp in model.blocks:
            k = L.column_whole(bp.xattn.wk, enc_out, dtype, Hkv).reshape(
                B, -1, cfg.n_kv_heads, hd).transpose(1, 2)
            v = L.column_whole(bp.xattn.wv, enc_out, dtype, Hkv).reshape(
                B, -1, cfg.n_kv_heads, hd).transpose(1, 2)
            xkv.append(torch.stack([k, v]))
        cache["xkv"] = torch.stack(xkv)
    logits = None
    for t in range(S):
        logits, cache = decode_step(cfg, model, cache, tokens[:, t])
    return logits, cache
