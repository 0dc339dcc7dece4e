"""Paged block gather: the CUDA kernel's wrappers (line gather and element
gather), their plain version, and the launch count.  Kernel source:
``csrc/gather_blocks.cu``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import gather_blocks_ref

__all__ = ["gather_blocks_cuda", "gather_blocks_ref", "launches"]

launches = _build.LaunchCount("gather_blocks")

_ELEM_BYTES = {torch.float32: 4, torch.int32: 4, torch.bfloat16: 2,
               torch.float16: 2, torch.int16: 2}


def gather_blocks_cuda(data: torch.Tensor, slots: torch.Tensor,
                       off: torch.Tensor | None = None) -> torch.Tensor:
    """``data[slots]`` rows, or with ``off`` the elements
    ``data[slots, off]``, zero where ``slots < 0``, on CUDA tensors."""
    if slots.device.type != "cuda":
        raise ValueError("gather_blocks_cuda needs CUDA tensors")
    dev = slots.device
    if data.device != dev or (off is not None and off.device != dev):
        raise ValueError("gather_blocks: tensors on different devices")
    if data.dim() != 2 or not data.is_contiguous():
        raise ValueError("gather_blocks: data must be a contiguous 2-d tensor")
    if data.dtype not in _ELEM_BYTES:
        raise ValueError(f"gather_blocks: unsupported dtype {data.dtype}")
    if slots.dtype != torch.int32 or slots.dim() != 1 \
            or not slots.is_contiguous():
        raise ValueError("gather_blocks: slots must be contiguous 1-d int32")
    n = slots.shape[0]
    line_elems = data.shape[1]
    eb = _ELEM_BYTES[data.dtype]
    stream = _build.stream_ptr(slots)
    if off is None:
        out = torch.empty((n, line_elems), dtype=data.dtype, device=dev)
        status = _build.lib().gather_lines_launch(
            data.data_ptr(), slots.data_ptr(), n, line_elems, eb,
            out.data_ptr(), stream)
    else:
        if off.dtype != torch.int32 or off.shape != slots.shape \
                or not off.is_contiguous():
            raise ValueError("gather_blocks: off must be contiguous int32 "
                             "shaped like slots")
        out = torch.empty((n,), dtype=data.dtype, device=dev)
        status = _build.lib().gather_elems_launch(
            data.data_ptr(), slots.data_ptr(), off.data_ptr(), n, line_elems,
            eb, out.data_ptr(), stream)
    _build.check(status, "gather_blocks")
    launches.n += 1
    return out
