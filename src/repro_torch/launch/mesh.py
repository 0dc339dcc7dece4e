"""Mesh construction on a ``torch.distributed`` process group.

Port of ``repro.launch.mesh``: functions, not module-level constants, so
importing this module touches no process group.  The production target is
pods of 16 x 16 = 256 devices; the multi-pod mesh adds a leading ``pod``
axis (2 pods = 512).  Axis roles:

  pod    - data parallelism across pods (slow links; the int8
           error-feedback gradient reduction runs over this axis)
  data   - data parallelism + ZeRO-3 weight sharding within a pod
  model  - tensor/expert parallelism + BaM KV-page striping

A mesh spans ranks ``0 .. prod(shape) - 1`` of the default process group,
laid out row-major as the reference lays out its first devices.  The
caller starts the group (``torch.distributed.init_process_group``, or
torchrun's ``env://``).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

__all__ = ["make_mesh", "make_production_mesh"]


def make_mesh(shape, axes, device_type=None):
    """A ``DeviceMesh`` named ``axes`` over the first ``prod(shape)`` ranks
    of the default process group, on ``device_type`` (``"cuda"`` unless the
    caller asks for ``"cpu"``).  Raises when the group is smaller."""
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: start one with "
                           "torch.distributed.init_process_group (torchrun "
                           "sets env://)")
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} ranks, have {world}")
    return DeviceMesh(device_type or "cuda",
                      torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)
