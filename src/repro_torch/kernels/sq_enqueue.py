"""Fused multi-segment SQ enqueue: the CUDA kernel's wrapper, its plain
version, and its launch count.  Kernel source: ``csrc/sq_enqueue.cu``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.ssd import _alive_devices
from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import sq_enqueue_ref

__all__ = ["sq_enqueue_cuda", "sq_enqueue_ref", "launches"]

launches = _build.LaunchCount("sq_enqueue")

# the kernel's limits (csrc/sq_enqueue.cu): one ballot and one scan warp a
# device, the tails and per-queue counts in shared memory, the segment
# bounds in the launch's parameters
MAX_DEVICES = 32
MAX_QUEUES = 4096
MAX_SEGMENTS = 64


def _bounds(seg_bounds, n: int) -> list:
    """The segments' edges ``[0, e_1, ..., n]``: the kernel takes segments
    that tile the lanes in order, as ``enqueue_segments`` builds them."""
    edges = [0]
    for s, e in seg_bounds:
        if s != edges[-1] or e < s:
            raise ValueError(f"sq_enqueue: segments {tuple(seg_bounds)} do "
                             "not tile the lanes in order")
        edges.append(e)
    if edges[-1] != n:
        raise ValueError(f"sq_enqueue: segments end at {edges[-1]}, the "
                         f"lanes at {n}")
    return edges


def sq_enqueue_cuda(sq_key, sq_dst, sq_is_write, sq_prio, sq_tenant,
                    sq_ticket, sq_tail, sq_head, rr_ptr, dev_enqueued,
                    keys, dst, is_write, prio, valid, *,
                    seg_bounds, n_devices, stripe_blocks, tenant,
                    failed_devices=()):
    """Launch the enqueue kernel on CUDA tensors: the six ring fields are
    written in place; returns ``(sq_tail, rr_ptr, queue, vslot, accepted,
    ticket_id, per_seg)`` as :func:`sq_enqueue_ref` does, with no host
    sync."""
    if keys.device.type != "cuda":
        raise ValueError("sq_enqueue_cuda needs CUDA tensors")
    dev = keys.device
    nq, depth = sq_key.shape
    nd = int(n_devices)
    n = keys.shape[0]
    if not 1 <= nd <= MAX_DEVICES:
        raise ValueError(f"sq_enqueue: n_devices {nd} outside the kernel's "
                         f"1..{MAX_DEVICES}")
    if nq > MAX_QUEUES or nq % nd:
        raise ValueError(f"sq_enqueue: {nq} queues must be a multiple of "
                         f"n_devices {nd} and at most {MAX_QUEUES}")
    if not 1 <= len(seg_bounds) <= MAX_SEGMENTS:
        raise ValueError(f"sq_enqueue: {len(seg_bounds)} segments outside "
                         f"the kernel's 1..{MAX_SEGMENTS}")
    if n >= 2 ** 31 - 4096:
        raise ValueError(f"sq_enqueue: {n} lanes past the kernel's int32 "
                         "lane index")
    i32, b8 = torch.int32, torch.bool
    for name, t, dtype, shape in (
            ("sq_key", sq_key, i32, (nq, depth)),
            ("sq_dst", sq_dst, i32, (nq, depth)),
            ("sq_is_write", sq_is_write, b8, (nq, depth)),
            ("sq_prio", sq_prio, i32, (nq, depth)),
            ("sq_tenant", sq_tenant, i32, (nq, depth)),
            ("sq_ticket", sq_ticket, i32, (nq, depth)),
            ("sq_tail", sq_tail, i32, (nq,)), ("sq_head", sq_head, i32, (nq,)),
            ("rr_ptr", rr_ptr, i32, (nd,)),
            ("dev_enqueued", dev_enqueued, i32, (nd,)),
            ("keys", keys, i32, (n,)), ("dst", dst, i32, (n,)),
            ("is_write", is_write, b8, (n,)), ("prio", prio, i32, (n,)),
            ("valid", valid, b8, (n,))):
        _build.check_tensor("sq_enqueue", name, t, dtype, shape, dev)
    edges = _bounds(seg_bounds, n)
    alive = _alive_devices(nd, failed_devices)
    n_seg = len(seg_bounds)
    sizes = [nq, nd, n, n, n, n_seg, n_seg, n_seg, n_seg, n_seg * nd,
             n_seg * nd]
    words = sum(sizes)
    # one buffer: the int32 outputs, then the accepted flags a byte each
    out = torch.empty((4 * words + n,), dtype=torch.uint8, device=dev)
    status = _build.lib().sq_enqueue_launch(
        sq_key.data_ptr(), sq_dst.data_ptr(), sq_is_write.data_ptr(),
        sq_prio.data_ptr(), sq_tenant.data_ptr(), sq_ticket.data_ptr(),
        sq_tail.data_ptr(), sq_head.data_ptr(), rr_ptr.data_ptr(),
        dev_enqueued.data_ptr(), keys.data_ptr(), dst.data_ptr(),
        is_write.data_ptr(), prio.data_ptr(), valid.data_ptr(), n, nq,
        depth, nd, int(stripe_blocks), int(tenant),
        (ctypes.c_int * len(edges))(*edges), n_seg,
        (ctypes.c_int * len(alive))(*alive), len(alive), out.data_ptr(),
        _build.stream_ptr(keys))
    _build.check(status, "sq_enqueue")
    launches.n += 1
    (tail, rr, queue, vslot, ticket_id, n_acc, n_drop, n_db, n_tick,
     dev_drop, dev_acc) = out[:4 * words].view(torch.int32).split(sizes)
    accepted = out[4 * words:].view(torch.bool)
    per_seg = dict(n_accepted=n_acc, n_dropped=n_drop, n_doorbells=n_db,
                   n_tickets=n_tick, dev_dropped=dev_drop.view(n_seg, nd),
                   dev_accepted=dev_acc.view(n_seg, nd))
    return tail, rr, queue, vslot, accepted, ticket_id, per_seg
