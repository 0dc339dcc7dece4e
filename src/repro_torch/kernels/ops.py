"""Kernel dispatch by tensor device.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor goes
to the CUDA kernel, whose wrapper raises if the build or the launch fails.
There is no fallback between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.cache_probe import cache_probe_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.gather_blocks import gather_blocks_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.kernels.probe_allocate import probe_allocate_cuda


def _on(t: torch.Tensor) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for tensors on {t.device}")
    return kind


def gather_blocks(data, slots, *, off=None):
    """Line gather ``data[slots]``; with ``off`` the element gather
    ``data[slots, off]``.  Zero where ``slots < 0``."""
    if _on(slots) == "cpu":
        return _ref.gather_blocks_ref(data, slots, off=off)
    return gather_blocks_cuda(data, slots, off=off)


def cache_probe(tags, keys, *, owner=None, tenant=0):
    if _on(keys) == "cpu":
        return _ref.cache_probe_ref(tags, keys, owner=owner, tenant=tenant)
    return cache_probe_cuda(tags, keys, owner=owner, tenant=tenant)


def probe_allocate(tags, owner, refcount, dirty, speculative, clock_hand,
                   keys, *, valid=None, alloc_mask=None, protect_slots=None,
                   tenant=0, way_lo=0, way_hi=None, spec_insert=False,
                   protect_hits=True):
    """Fused cache probe + clock-sweep victim select.  Returns ``(hit,
    hit_slot, way, ok, evicted_key, evicted_dirty)``."""
    if valid is None:
        valid = keys >= 0
    fn = _ref.probe_allocate_ref if _on(keys) == "cpu" else probe_allocate_cuda
    return fn(tags, owner, refcount, dirty, speculative, clock_hand, keys,
              valid, alloc_mask, protect_slots, tenant=tenant, way_lo=way_lo,
              way_hi=way_hi, spec_insert=spec_insert,
              protect_hits=protect_hits)


def flash_attention(q, k, v, *, causal=True, window=None):
    """Causal / windowed GQA attention over full sequences: q (B, Hq, Sq, D),
    k and v (B, Hkv, Skv, D); ``window`` a Python int or None."""
    fn = _ref.flash_attention_ref if _on(q) == "cpu" else flash_attention_cuda
    return fn(q, k, v, causal=causal, window=window)


def paged_attention(q, k_pages, v_pages, page_table, seq_lens):
    """One-token attention over a paged KV pool: q (B, Hq, D), pools
    (B, P, page, Hkv, D), page_table (B, NP) with -1 holes, seq_lens (B,)."""
    fn = _ref.paged_attention_ref if _on(q) == "cpu" else paged_attention_cuda
    return fn(q, k_pages, v_pages, page_table, seq_lens)


sq_enqueue = _ref.sq_enqueue_ref
wfq_drain = _ref.wfq_drain_ref
