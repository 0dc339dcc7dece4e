"""Blockwise (flash) attention: the CUDA forward kernels' wrapper, the
backward kernel's wrapper, their plain versions and the launch counts.
Kernel sources: ``csrc/flash_attention.cu`` (forward) and
``csrc/flash_attention_bwd.cu`` (backward).

Two kernels compute the same function; :func:`variant` chooses by dtype and
shape, never by catching a failure:

* ``"tc"`` (tensor cores: TMA loads, ``wgmma``, bf16 in and f32
  accumulate) when q, k and v are bf16, the head dim D is 64, 128 or 256
  and Skv >= 1;
* ``"simt"`` (f32 SIMT arithmetic) for everything else: every f32 call
  (TF32 tensor cores keep 10 mantissa bits, too few for f32's 3e-5) and
  bf16 at other head dims.

Either writes each row's log-sum-exp when asked (``return_lse``), which
:func:`flash_attention_bwd_cuda` reads.  The backward has the same two
variants under the same rule (:func:`bwd_variant`): ``"tc"`` (TMA and
``wgmma``, P and dS rounded to bf16 before their products, as
:func:`flash_attention_bwd_tc_ref` emulates) and ``"simt"`` (register-tiled
f32 SIMT, the train step's f32 kernel).  A failed build or launch raises.
``launches`` counts every forward call; ``variant_launches["tc"]`` and
``variant_launches["simt"]`` count which kernel ran; ``bwd_launches``
counts the backward's calls (its kernels from one C entry) and
``bwd_variant_launches`` which variant ran.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_bwd_tc_ref,
                                     flash_attention_lse_ref,
                                     flash_attention_ref)

__all__ = ["bwd_launches", "bwd_variant", "bwd_variant_launches",
           "flash_attention_bwd_cuda", "flash_attention_bwd_ref",
           "flash_attention_bwd_tc_ref", "flash_attention_cuda",
           "flash_attention_lse_ref", "flash_attention_ref", "launches",
           "variant", "variant_launches"]

launches = _build.LaunchCount("flash_attention")
bwd_launches = _build.LaunchCount("flash_attention_bwd")
bwd_variant_launches = {
    "tc": _build.LaunchCount("flash_attention_bwd.tc"),
    "simt": _build.LaunchCount("flash_attention_bwd.simt")}
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


def bwd_variant(q: torch.Tensor, k: torch.Tensor) -> str:
    """The backward kernel a call runs, by the forward's rule: ``"tc"`` for
    bf16 with D in (64, 128, 256) and at least one key, ``"simt"``
    otherwise (every f32 call, so the f32 train step)."""
    return variant(q, k)


def _check(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *like_q: torch.Tensor, window) -> None:
    """Raise on what the kernels do not take: q (B, Hq, Sq, D), k and v
    (B, Hkv, Skv, D) and every tensor of ``like_q`` shaped like q, CUDA
    tensors of one dtype of ``DTYPES``, contiguous and 16-byte aligned; Hq
    a multiple of Hkv, D a multiple of 8 and at most 256; ``window`` a
    Python int or None."""
    ts = (q, k, v) + like_q
    if q.device.type != "cuda":
        raise ValueError(f"{what}_cuda needs CUDA tensors")
    if any(t.device != q.device for t in ts):
        raise ValueError(f"{what}: tensors on different devices")
    if not all(t.is_contiguous() for t in ts) \
            or any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what}: tensors must be contiguous and 16-byte "
                         "aligned")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"{what}: tensors must share one dtype of {DTYPES}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if k.shape != (B, Hkv, Skv, D) or v.shape != k.shape \
            or any(t.shape != q.shape for t in like_q):
        raise ValueError(f"{what}: inconsistent shapes")
    if Hq % Hkv or D % 8 or D > 256:
        raise ValueError(f"{what}: needs Hq a multiple of Hkv, D a multiple "
                         "of 8 and D <= 256")
    if window is not None and not isinstance(window, int):
        raise TypeError(f"{what}: window must be a Python int or None")


def _shape_args(q, k, causal, window):
    B, Hq, Sq, D = q.shape
    return (B, Hq, k.shape[1], Sq, k.shape[2], D, int(causal),
            int(window is not None), 0 if window is None else window,
            1.0 / math.sqrt(D))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         return_lse: bool = False):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), CUDA tensors, with Hq a
    multiple of Hkv.  ``window`` is a Python int (keys more than
    ``window - 1`` positions behind the query are masked) or None.  Scale
    1/sqrt(D).  Returns (B, Hq, Sq, D) in q's dtype, and with
    ``return_lse`` also each row's log-sum-exp, f32 (B, Hq, Sq), as
    :func:`flash_attention_lse_ref`."""
    _check("flash_attention", q, k, v, window=window)
    out = torch.empty_like(q)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if return_lse else None)
    kind = variant(q, k)
    lib = _build.lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *_shape_args(q, k, causal, window))
    lse_ptr = 0 if lse is None else lse.data_ptr()
    if kind == "tc":
        status = lib.flash_attention_tc_launch(*args, out.data_ptr(), lse_ptr,
                                               _build.stream_ptr(q))
    else:
        status = lib.flash_attention_launch(
            *args, int(q.dtype == torch.bfloat16), out.data_ptr(), lse_ptr,
            _build.stream_ptr(q))
    _build.check(status, f"flash_attention ({kind})")
    launches.n += 1
    variant_launches[kind].n += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True,
                             window: int | None = None):
    """The backward kernel: (dq, dk, dv) in the inputs' dtype from q, k, v,
    the forward's ``out`` and f32 ``lse`` (B, Hq, Sq) and ``dout`` (shaped
    like q), CUDA tensors; the function of :func:`flash_attention_bwd_ref`
    (``"simt"``) or, with P and dS rounded to bf16 before their products,
    of :func:`flash_attention_bwd_tc_ref` (``"tc"``), as
    :func:`bwd_variant` chooses.  Deterministic: no atomics."""
    _check("flash_attention_bwd", q, k, v, out, dout, window=window)
    if lse.dtype != torch.float32 or lse.shape != q.shape[:3] \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("flash_attention_bwd: lse must be a contiguous f32 "
                         "(B, Hq, Sq) tensor on q's device")
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.shape[2] == 0:             # no query: nothing reaches k or v
        return dq, dk.zero_(), dv.zero_()
    kind = bwd_variant(q, k)
    lib = _build.lib()
    shape = _shape_args(q, k, causal, window)
    # Delta, the GQA group's f32 partials and the dS tiles (C sizes them)
    work = torch.empty(lib.flash_attention_bwd_workspace_floats(
        *shape[:9], int(kind == "tc")), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), *shape)
    grads = (work.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             _build.stream_ptr(q))
    if kind == "tc":
        status = lib.flash_attention_bwd_tc_launch(*ptrs, *grads)
    else:
        status = lib.flash_attention_bwd_launch(
            *ptrs, int(q.dtype == torch.bfloat16), *grads)
    _build.check(status, f"flash_attention_bwd ({kind})")
    bwd_launches.n += 1
    bwd_variant_launches[kind].n += 1
    return dq, dk, dv
