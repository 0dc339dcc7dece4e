"""Paged decode attention: the CUDA kernels' wrapper, its plain version and
the launch count.  Kernel source: ``csrc/paged_attention.cu`` (split-KV: a
partial kernel per chunk of 128 logical positions, then a combine in
logical order, both launched by one C entry on one stream; the C side owns
the chunk size and the workspace's layout).  The CPU emulation of that
split, ``paged_attention_chunked_ref``, is held against the JAX package by
the tests.  With ``return_lse`` the combine also writes each row's f32
log-sum-exp (``paged_attention_lse_ref``), which the shard-local
flash-decoding uses to combine shards; ``lse_launches`` counts those
calls (``launches`` counts every call)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import (paged_attention_lse_ref,
                                     paged_attention_ref)

__all__ = ["launches", "lse_launches", "paged_attention_cuda",
           "paged_attention_lse_ref", "paged_attention_ref"]

launches = _build.LaunchCount("paged_attention")
lse_launches = _build.LaunchCount("paged_attention.lse")

DTYPES = (torch.float32, torch.bfloat16)


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_table: torch.Tensor,
                         seq_lens: torch.Tensor, *,
                         return_lse: bool = False):
    """One-token attention (scale 1/sqrt(D)) over a paged pool on CUDA
    tensors.  q: (B, Hq, D);
    pools (B, P, page, Hkv, D); page_table (B, NP) int32 (-1 a hole);
    seq_lens (B,) int32.  Returns (B, Hq, D) in q's dtype, and with
    ``return_lse`` also each row's f32 log-sum-exp (B, Hq), -inf where no
    key is live."""
    if q.device.type != "cuda":
        raise ValueError("paged_attention_cuda needs CUDA tensors")
    ts = (q, k_pages, v_pages, page_table, seq_lens)
    if any(t.device != q.device for t in ts):
        raise ValueError("paged_attention: tensors on different devices")
    if not all(t.is_contiguous() for t in ts) or not _aligned(*ts):
        raise ValueError("paged_attention: tensors must be contiguous and "
                         "16-byte aligned")
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"paged_attention: q, k, v must share one dtype of "
                         f"{DTYPES}")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("paged_attention: page_table and seq_lens must be "
                         "int32")
    B, Hq, D = q.shape
    _, P, page, Hkv, _ = k_pages.shape
    NP = page_table.shape[1]
    if k_pages.shape != (B, P, page, Hkv, D) or v_pages.shape != k_pages.shape \
            or page_table.shape != (B, NP) or seq_lens.shape != (B,):
        raise ValueError("paged_attention: inconsistent shapes")
    if Hq % Hkv or Hq // Hkv > 16 or D % 8 or D > 256:
        raise ValueError("paged_attention: needs Hq a multiple of Hkv, "
                         "Hq // Hkv <= 16, D a multiple of 8 and D <= 256")
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = _build.lib()
    # f32 workspace for the per-chunk partials, laid out by the C entry
    ws = torch.empty((lib.paged_attention_workspace_floats(B, Hq, NP, page,
                                                           D),),
                     dtype=torch.float32, device=q.device)
    status = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), B, P, page, Hkv, D,
        Hq // Hkv, NP, 1.0 / math.sqrt(D), int(q.dtype == torch.bfloat16),
        ws.data_ptr(), out.data_ptr(), 0 if lse is None else lse.data_ptr(),
        _build.stream_ptr(q))
    _build.check(status, "paged_attention")
    launches.n += 1
    if return_lse:
        lse_launches.n += 1
        return out, lse
    return out
