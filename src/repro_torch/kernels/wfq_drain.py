"""Closed-form drain accounting: the CUDA kernel's wrapper, its plain
version, and its launch count.  Kernel source: ``csrc/wfq_drain.cu``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import wfq_drain_ref

__all__ = ["wfq_drain_cuda", "wfq_drain_ref", "launches"]

launches = _build.LaunchCount("wfq_drain")

# the kernel's limits (csrc/wfq_drain.cu): the block's counters sit in
# shared memory
MAX_DEVICES = 32
MAX_TENANTS = 64

_DEV_FIELDS = ("count_dev", "reads_dev", "writes_dev", "errors_dev",
               "err_reads_dev", "err_writes_dev", "retry_reads_dev",
               "retry_writes_dev")


def wfq_drain_cuda(sq_key, sq_is_write, sq_tenant, sq_ticket=None, *,
                   n_devices, n_tenants, fault=None, entry_status=False):
    """Launch the drain kernel on CUDA tensors: ``(count, count_dev,
    count_tenant, reads_dev, writes_dev, fstats)`` as
    :func:`wfq_drain_ref` returns them (``fstats`` empty without an enabled
    fault model; with one and ``entry_status``, ``fstats["status"]`` each
    entry's status, written by the same launch)."""
    if sq_key.device.type != "cuda":
        raise ValueError("wfq_drain_cuda needs CUDA tensors")
    dev = sq_key.device
    nq, depth = sq_key.shape
    nd, nt = int(n_devices), int(n_tenants)
    if not 1 <= nd <= MAX_DEVICES or nq % nd:
        raise ValueError(f"wfq_drain: n_devices {nd} must divide {nq} "
                         f"queues and be at most {MAX_DEVICES}")
    if not 1 <= nt <= MAX_TENANTS:
        raise ValueError(f"wfq_drain: n_tenants {nt} outside the kernel's "
                         f"1..{MAX_TENANTS}")
    for name, t, dtype in (("sq_key", sq_key, torch.int32),
                           ("sq_is_write", sq_is_write, torch.bool),
                           ("sq_tenant", sq_tenant, torch.int32)):
        _build.check_tensor("wfq_drain", name, t, dtype, (nq, depth), dev)
    on = fault is not None and fault.enabled
    if on:
        if sq_ticket is None:
            raise ValueError("wfq_drain: a fault model needs sq_ticket")
        _build.check_tensor("wfq_drain", "sq_ticket", sq_ticket, torch.int32,
                            (nq, depth), dev)
        mask = sum(1 << d for d in fault.failed_devices if 0 <= d < nd)
        fargs = (1, fault.threshold, fault.retry_budget,
                 (fault.seed * 0x27D4EB2F) & 0xFFFFFFFF, mask)
    else:
        fargs = (0, 0, 0, 0, 0)
    out = torch.empty((2 + len(_DEV_FIELDS) * nd + 2 * nt,),
                      dtype=torch.int32, device=dev)
    status = (torch.empty((nq * depth,), dtype=torch.int32, device=dev)
              if on and entry_status else None)
    rc = _build.lib().wfq_drain_launch(
        sq_key.data_ptr(), sq_is_write.data_ptr(), sq_tenant.data_ptr(),
        sq_ticket.data_ptr() if on else None, nq, depth, nd, nt, *fargs,
        out.data_ptr(), None if status is None else status.data_ptr(),
        _build.stream_ptr(sq_key))
    _build.check(rc, "wfq_drain")
    launches.n += 1
    count, transient, *per_dev = out[:2 + len(_DEV_FIELDS) * nd].split(
        [1, 1] + [nd] * len(_DEV_FIELDS))
    d = dict(zip(_DEV_FIELDS, per_dev))
    count_tenant, errors_tenant = out[2 + len(_DEV_FIELDS) * nd:].split(nt)
    fstats = dict(
        errors_dev=d["errors_dev"], errors_tenant=errors_tenant,
        err_reads_dev=d["err_reads_dev"], err_writes_dev=d["err_writes_dev"],
        retry_reads_dev=d["retry_reads_dev"],
        retry_writes_dev=d["retry_writes_dev"],
        transient_errors=transient.view(())) if on else {}
    if status is not None:
        fstats["status"] = status
    return (count.view(()), d["count_dev"], count_tenant, d["reads_dev"],
            d["writes_dev"], fstats)
