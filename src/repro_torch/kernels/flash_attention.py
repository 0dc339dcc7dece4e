"""Blockwise (flash) attention forward: the CUDA kernels' wrapper, its
plain version and the launch counts.  Kernel source:
``csrc/flash_attention.cu``.

Two kernels compute the same function; :func:`variant` chooses by dtype and
shape, never by catching a failure:

* ``"tc"`` (tensor cores: TMA loads, ``wgmma``, bf16 in and f32
  accumulate) when q, k and v are bf16, the head dim D is 64, 128 or 256
  and Skv >= 1;
* ``"simt"`` (f32 SIMT arithmetic) for everything else: every f32 call
  (TF32 tensor cores keep 10 mantissa bits, too few for f32's 3e-5) and
  bf16 at other head dims.

A failed build or launch of either raises.  ``launches`` counts every call;
``variant_launches["tc"]`` and ``variant_launches["simt"]`` count which
kernel ran.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["flash_attention_cuda", "flash_attention_ref", "launches",
           "variant", "variant_launches"]

launches = _build.LaunchCount("flash_attention")
variant_launches = {"tc": _build.LaunchCount("flash_attention.tc"),
                    "simt": _build.LaunchCount("flash_attention.simt")}

DTYPES = (torch.float32, torch.bfloat16)
TC_HEAD_DIMS = (64, 128, 256)


def variant(q: torch.Tensor, k: torch.Tensor) -> str:
    """The kernel a call runs: ``"tc"`` for bf16 with D in (64, 128, 256)
    and at least one key, ``"simt"`` otherwise."""
    if q.dtype == torch.bfloat16 and q.shape[-1] in TC_HEAD_DIMS \
            and k.shape[2] >= 1:
        return "tc"
    return "simt"


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
    kind = variant(q, k)
    lib = _build.lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), B, Hq, Hkv, Sq, Skv, D,
            int(causal), int(window is not None),
            0 if window is None else window, 1.0 / math.sqrt(D))
    if kind == "tc":
        status = lib.flash_attention_tc_launch(*args, out.data_ptr(),
                                               _build.stream_ptr(q))
    else:
        status = lib.flash_attention_launch(
            *args, int(q.dtype == torch.bfloat16), out.data_ptr(),
            _build.stream_ptr(q))
    _build.check(status, f"flash_attention ({kind})")
    launches.n += 1
    variant_launches[kind].n += 1
    return out
