"""Blockwise (flash) attention forward: the CUDA kernel's wrapper, its
plain version and the launch count.  Kernel source:
``csrc/flash_attention.cu``."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["flash_attention_cuda", "flash_attention_ref", "launches"]

launches = _build.LaunchCount("flash_attention")

DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), CUDA tensors, with Hq a
    multiple of Hkv.  ``window`` is a Python int (keys more than
    ``window - 1`` positions behind the query are masked) or None.  Scale
    1/sqrt(D).  Returns (B, Hq, Sq, D) in q's dtype."""
    if q.device.type != "cuda":
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: tensors on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()) \
            or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: tensors must be contiguous and "
                         "16-byte aligned")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share one dtype of "
                         f"{DTYPES}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if k.shape != (B, Hkv, Skv, D) or v.shape != k.shape:
        raise ValueError("flash_attention: inconsistent shapes")
    if Hq % Hkv or D % 8 or D > 256:
        raise ValueError("flash_attention: needs Hq a multiple of Hkv, D a "
                         "multiple of 8 and D <= 256")
    if window is not None and not isinstance(window, int):
        raise TypeError("flash_attention: window must be a Python int or "
                        "None")
    out = torch.empty_like(q)
    status = _build.lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), B, Hq, Hkv, Sq, Skv, D,
        int(causal), int(window is not None),
        0 if window is None else window, 1.0 / math.sqrt(D),
        int(q.dtype == torch.bfloat16), out.data_ptr(), _build.stream_ptr(q))
    _build.check(status, "flash_attention")
    launches.n += 1
    return out
