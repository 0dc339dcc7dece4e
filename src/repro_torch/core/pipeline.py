"""Latency hiding: a token-pipelined fetch/compute software pipeline.

Port of ``repro.core.pipeline``.  Step ``t`` submits the read of step
``t+1``'s wavefront and then redeems step ``t``'s token and computes on its
values, so two wavefronts' commands are in flight while one computes.  The
reference carries the token through a ``lax.scan``; the port runs eagerly,
so the scan is a Python loop with the same schedule: the prologue submits
step 0 and the last step completes after the loop, with no junk wavefront.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

__all__ = ["software_pipeline", "pipelined_bam_map"]


def _stack(ys: list):
    """Stack per-step outputs leaf by leaf (tensors, tuples, lists, dicts
    of them; ``None`` stays ``None``), as ``lax.scan`` stacks its ``ys``."""
    first = ys[0]
    if first is None:
        return None
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([y[i] for y in ys])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([y[k] for y in ys]) for k in first}
    return torch.stack([torch.as_tensor(y) for y in ys])


def software_pipeline(
    read_fn: Optional[Callable[[Any, torch.Tensor],
                               Tuple[torch.Tensor, Any]]],
    compute_fn: Callable[[Any, torch.Tensor, torch.Tensor], Tuple[Any, Any]],
    idx_seq: torch.Tensor,          # (T, n) element indices per step
    read_state: Any,
    compute_carry: Any,
    *,
    submit_fn: Optional[Callable[[Any, torch.Tensor], Tuple[Any, Any]]] = None,
    wait_fn: Optional[Callable[[Any, Any], Tuple[Any, torch.Tensor]]] = None,
):
    """Run ``T`` steps with the fetch of step ``t+1`` in flight while step
    ``t`` computes.

    ``compute_fn(carry, values, idx) -> (carry, y)`` consumes the values
    fetched for its own step.  Pass an async pair ``submit_fn(state, idx)
    -> (state, token)`` / ``wait_fn(state, token) -> (state, values)``, or
    a synchronous ``read_fn(state, idx) -> (values, state)``, which is
    adapted to a pair whose "token" is the wavefront it read eagerly.
    Returns ``(read_state, compute_carry, ys)``, ``ys`` stacked over steps.
    """
    if (submit_fn is None) != (wait_fn is None):
        raise ValueError("pass submit_fn and wait_fn together")
    if submit_fn is None:
        if read_fn is None:
            raise ValueError("need read_fn or a submit_fn/wait_fn pair")
        sync_read = read_fn

        def submit_fn(rs, idx):
            vals, rs = sync_read(rs, idx)
            return rs, vals

        def wait_fn(rs, tok):
            return rs, tok

    T = idx_seq.shape[0]
    read_state, tok = submit_fn(read_state, idx_seq[0])
    ys = []
    for t in range(T - 1):
        # (a) issue t+1: its commands sit in the rings while (b) runs
        read_state, tok_next = submit_fn(read_state, idx_seq[t + 1])
        # (b) complete step t and compute on its values
        read_state, vals = wait_fn(read_state, tok)
        compute_carry, y = compute_fn(compute_carry, vals, idx_seq[t])
        ys.append(y)
        tok = tok_next
    read_state, vals = wait_fn(read_state, tok)
    compute_carry, y = compute_fn(compute_carry, vals, idx_seq[T - 1])
    ys.append(y)
    return read_state, compute_carry, _stack(ys)


def pipelined_bam_map(bam, st, idx_seq: torch.Tensor,
                      fn: Callable[[torch.Tensor], torch.Tensor]):
    """``ys[t] = fn(bam.flat[idx_seq[t]])`` with step ``t+1``'s storage
    commands in flight while ``fn`` runs on step ``t``.  Returns ``(ys,
    state)``."""
    from repro_torch.core.bam_array import IORequest

    def submit_fn(s, idx):
        return bam.submit(s, IORequest.read(idx))

    def compute_fn(carry, vals, _idx):
        return carry, fn(vals)

    st, _, ys = software_pipeline(None, compute_fn, idx_seq, st, None,
                                  submit_fn=submit_fn, wait_fn=bam.wait)
    return ys, st
