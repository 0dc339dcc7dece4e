"""GPipe-style pipeline parallelism over the ``pod`` mesh axis (optional).

Port of ``repro.distributed.pipeline_parallel``: stages live on successive
ranks of the axis and microbatches flow through the reference's schedule.
At tick t stage s runs microbatch t - s; between ticks each stage's output
goes to the next stage over a ring of point-to-point sends (stage i to
stage i + 1 mod P, ``batch_isend_irecv``: the reference's ``ppermute``).
M microbatches over P stages take M + P - 1 ticks (the GPipe bubble).
Every stage computes on every tick, as the reference's scan body does; the
ticks outside a stage's microbatches compute values nobody keeps.  The
last stage's outputs are summed over the axis, so every rank of it returns
them (the reference's ``psum``).  Only tests use it.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

__all__ = ["gpipe"]


def _stage_slice(tree, stage: int):
    """This stage's slice of a tree of tensors stacked on a leading stage
    dimension."""
    if isinstance(tree, dict):
        return {k: _stage_slice(v, stage) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_stage_slice(v, stage) for v in tree)
    return tree[stage]


def gpipe(stage_fn: Callable, n_stages: int, n_microbatches: int, *,
          axis: str = "pod", mesh=None):
    """Build a pipelined forward ``y = pipe(stage_params, x)``.

    ``stage_fn(params_s, x) -> x`` is one stage's computation, shape and
    dtype preserving; ``stage_params`` a tree of tensors stacked on a
    leading stage dimension, the same on every rank (each stage takes its
    own); ``x`` the global batch, the same on every rank, split into
    ``n_microbatches`` along dim 0.  ``mesh`` (default: the active one)
    must have ``axis`` of size ``n_stages``."""
    if n_microbatches < 1:
        raise ValueError("n_microbatches must be >= 1")

    def pipe(stage_params, x):
        from repro_torch.distributed.sharding import current_mesh

        m = mesh or current_mesh()
        if m is None or axis not in (m.mesh_dim_names or ()):
            raise ValueError(f"gpipe needs a mesh with a {axis!r} axis")
        if m.shape[m.mesh_dim_names.index(axis)] != n_stages:
            raise ValueError(f"mesh axis {axis!r} is not {n_stages} stages")
        group = m.get_group(axis)
        stage = m.get_local_rank(axis)
        B = x.shape[0]
        if B % n_microbatches:
            raise ValueError(f"batch {B} is not a multiple of "
                             f"{n_microbatches} microbatches")
        mb = B // n_microbatches
        params = _stage_slice(stage_params, stage)
        xs = x.reshape(n_microbatches, mb, *x.shape[1:])
        nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
        prv = dist.get_global_rank(group, (stage - 1) % n_stages)
        buf = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        for t in range(n_microbatches + n_stages - 1):
            # stage 0 injects microbatch t; the others got theirs from the
            # previous tick's send
            x_in = xs[t if t < n_microbatches else 0] if stage == 0 \
                else buf
            y = stage_fn(params, x_in)
            mb_idx = t - stage            # the microbatch this stage ran
            if stage == n_stages - 1 and 0 <= mb_idx < n_microbatches:
                outs[mb_idx] = y
            if n_stages == 1:
                buf = y
                continue
            y = y.contiguous()
            buf = torch.empty_like(y)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y, nxt, group),
                dist.P2POp(dist.irecv, buf, prv, group)])
            for r in reqs:
                r.wait()
        # only the last stage holds real outputs; the sum over the axis
        # gives them to every stage
        if stage != n_stages - 1:
            outs.zero_()
        dist.all_reduce(outs, group=group)
        return outs.reshape(B, *x.shape[1:])

    return pipe
