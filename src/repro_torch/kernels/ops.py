"""Kernel dispatch by tensor device.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor goes
to the CUDA kernel, whose wrapper raises if the build or the launch fails.
There is no fallback between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.cache_probe import cache_probe_cuda
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.gather_blocks import gather_blocks_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.kernels.probe_allocate import probe_allocate_cuda
from repro_torch.kernels.sq_enqueue import sq_enqueue_cuda
from repro_torch.kernels.wfq_drain import wfq_drain_cuda


def _on(t: torch.Tensor) -> str:
    """``"cuda"`` for a tensor on the card, ``"cpu"`` for one that goes to
    the plain version (on the CPU or on ``meta``)."""
    kind = t.device.type
    if kind == "meta":
        return "cpu"
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


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the forward keeps q, k, v, O and
    the rows' log-sum-exp; the backward is the CUDA backward kernel for
    CUDA tensors and its plain version for CPU tensors (the reference's
    ``custom_vjp`` of ``flash_attention_xla``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if _on(q) == "cpu":
            out, lse = _ref.flash_attention_lse_ref(q, k, v, causal=causal,
                                                    window=window)
        else:
            out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                            window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        fn = (_ref.flash_attention_bwd_ref if _on(q) == "cpu"
              else flash_attention_bwd_cuda)
        dq, dk, dv = fn(q, k, v, out, lse, dout.contiguous(),
                        causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=True, window=None):
    """Causal / windowed GQA attention over full sequences: q (B, Hq, Sq, D),
    k and v (B, Hkv, Skv, D); ``window`` a Python int or None.  When grad
    is on and an input requires it, the call goes through the autograd
    function above (forward with the log-sum-exp, backward kernel);
    otherwise it is the plain forward call, with nothing saved."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window)
    fn = _ref.flash_attention_ref if _on(q) == "cpu" else flash_attention_cuda
    return fn(q, k, v, causal=causal, window=window)


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, *,
                    return_lse=False):
    """One-token attention over a paged KV pool: q (B, Hq, D), pools
    (B, P, page, Hkv, D), page_table (B, NP) with -1 holes, seq_lens (B,);
    with ``return_lse`` also each row's f32 log-sum-exp (B, Hq)."""
    if _on(q) == "cpu":
        return (_ref.paged_attention_lse_ref if return_lse
                else _ref.paged_attention_ref)(q, k_pages, v_pages,
                                               page_table, seq_lens)
    return paged_attention_cuda(q, k_pages, v_pages, page_table, seq_lens,
                                return_lse=return_lse)


def sq_enqueue(sq_key, sq_dst, sq_is_write, sq_prio, sq_tenant, sq_ticket,
               sq_tail, sq_head, rr_ptr, dev_enqueued,
               keys, dst, is_write, prio, valid, *,
               seg_bounds, n_devices, stripe_blocks, tenant,
               failed_devices=()):
    """Fused multi-segment SQ enqueue: the six ring fields are written in
    place; returns ``(sq_tail, rr_ptr, queue, vslot, accepted, ticket_id,
    per_seg)``."""
    fn = _ref.sq_enqueue_ref if _on(keys) == "cpu" else sq_enqueue_cuda
    return fn(sq_key, sq_dst, sq_is_write, sq_prio, sq_tenant, sq_ticket,
              sq_tail, sq_head, rr_ptr, dev_enqueued,
              keys, dst, is_write, prio, valid,
              seg_bounds=seg_bounds, n_devices=n_devices,
              stripe_blocks=stripe_blocks, tenant=tenant,
              failed_devices=failed_devices)


def wfq_drain(sq_key, sq_is_write, sq_tenant, sq_ticket=None, *,
              n_devices, n_tenants, fault=None, entry_status=False):
    """Closed-form drain accounting over the pending ring entries:
    ``(count, count_dev, count_tenant, reads_dev, writes_dev, fstats)``
    (``fstats["status"]`` each entry's status with ``entry_status`` and an
    enabled fault model)."""
    fn = _ref.wfq_drain_ref if _on(sq_key) == "cpu" else wfq_drain_cuda
    return fn(sq_key, sq_is_write, sq_tenant, sq_ticket,
              n_devices=n_devices, n_tenants=n_tenants, fault=fault,
              entry_status=entry_status)
