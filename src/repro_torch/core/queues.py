"""High-throughput I/O queues: BaM's §III-C I/O stack as a prefix sum.

Port of ``repro.core.queues``, restricted to the fused path: the SQ ring
pool, the fused multi-segment enqueue and the closed-form drain.  The rings
are updated in place where the reference rebuilds a ``QueueState``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops as _ops

__all__ = ["QueueState", "make_queues", "enqueue", "enqueue_segments",
           "drain_accounting", "SubmitReceipt", "DrainReceipt",
           "PRIO_DEMAND", "PRIO_READAHEAD", "in_flight",
           "in_flight_per_device", "in_flight_per_tenant"]

PRIO_DEMAND = 0      # demand reads and write-backs
PRIO_READAHEAD = 1   # speculative readahead fills


@dataclasses.dataclass
class QueueState:
    """A pool of NVMe submission queues, split into ``n_devices`` equal
    groups: queues ``[d*group, (d+1)*group)`` belong to device ``d``."""

    num_queues: int
    depth: int
    n_devices: int
    stripe_blocks: int
    n_tenants: int
    sq_key: torch.Tensor       # (num_queues, depth) int32, -1 free
    sq_dst: torch.Tensor       # (num_queues, depth) int32 destination slot
    sq_is_write: torch.Tensor  # (num_queues, depth) bool
    sq_prio: torch.Tensor      # (num_queues, depth) int32
    sq_tenant: torch.Tensor    # (num_queues, depth) int32
    sq_ticket: torch.Tensor    # (num_queues, depth) int32, -1 free
    sq_tail: torch.Tensor      # (num_queues,) int32 monotonic
    sq_head: torch.Tensor      # (num_queues,) int32 monotonic
    rr_ptr: torch.Tensor       # (n_devices,) int32
    ticket_total: torch.Tensor  # () int32
    doorbells: torch.Tensor    # () int32
    completions: torch.Tensor  # () int32
    dropped: torch.Tensor      # () int32
    dev_dropped: torch.Tensor  # (n_devices,) int32
    dev_enqueued: torch.Tensor  # (n_devices,) int32
    dev_completed: torch.Tensor  # (n_devices,) int32
    tenant_enqueued: torch.Tensor  # (n_tenants,) int32
    tenant_dropped: torch.Tensor   # (n_tenants,) int32
    tenant_completed: torch.Tensor  # (n_tenants,) int32

    @property
    def group_size(self) -> int:
        return self.num_queues // self.n_devices


def make_queues(num_queues: int, depth: int, n_devices: int = 1,
                stripe_blocks: int = 1, n_tenants: int = 1,
                device="cpu") -> QueueState:
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if stripe_blocks < 1:
        raise ValueError(f"stripe_blocks must be >= 1, got {stripe_blocks}")
    if num_queues % n_devices != 0:
        raise ValueError(
            f"num_queues ({num_queues}) must be a multiple of n_devices "
            f"({n_devices})")

    def ring(fill, dt=torch.int32):
        return torch.full((num_queues, depth), fill, dtype=dt, device=device)

    def zi(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return QueueState(
        num_queues=num_queues, depth=depth, n_devices=n_devices,
        stripe_blocks=stripe_blocks, n_tenants=n_tenants,
        sq_key=ring(-1), sq_dst=ring(-1), sq_is_write=ring(False, torch.bool),
        sq_prio=ring(0), sq_tenant=ring(0), sq_ticket=ring(-1),
        sq_tail=zi(num_queues), sq_head=zi(num_queues), rr_ptr=zi(n_devices),
        ticket_total=zi(), doorbells=zi(), completions=zi(), dropped=zi(),
        dev_dropped=zi(n_devices), dev_enqueued=zi(n_devices),
        dev_completed=zi(n_devices), tenant_enqueued=zi(n_tenants),
        tenant_dropped=zi(n_tenants), tenant_completed=zi(n_tenants))


@dataclasses.dataclass
class SubmitReceipt:
    """What a command segment learns from its enqueue."""

    queue: torch.Tensor       # (n,) int32, -1 dropped/invalid
    vslot: torch.Tensor       # (n,) int32 virtual slot, -1 dropped/invalid
    accepted: torch.Tensor    # (n,) bool
    ticket: torch.Tensor      # (n,) int32 per-device ordinal, -1 if not
    n_accepted: torch.Tensor  # () int32
    n_dropped: torch.Tensor   # () int32
    n_doorbells: torch.Tensor  # () int32


def enqueue_segments(qs: QueueState, segments, tenant: int = 0):
    """Submit several command segments of one tenant in one fused pass.

    ``segments`` is a sequence of ``(keys, dst, is_write, valid, prio)`` in
    issue order (``None`` entries take the defaults).  Returns ``(qs,
    receipts)``, one receipt per segment; ``qs`` is updated in place.
    """
    if not 0 <= tenant < qs.n_tenants:
        raise ValueError(
            f"tenant {tenant} out of range for n_tenants={qs.n_tenants}")
    keys_l, dst_l, w_l, valid_l, prio_l, bounds = [], [], [], [], [], []
    off = 0
    # a host loop over the segment list (eager torch, nothing is traced)
    for keys, dst, is_write, valid, prio in segments:  # bamlint: ignore[BAM104]
        n = keys.shape[0]
        dev = keys.device
        valid = keys >= 0 if valid is None else valid & (keys >= 0)
        if dst is None:
            dst = torch.full((n,), -1, dtype=torch.int32, device=dev)
        if is_write is None:
            is_write = torch.zeros((n,), dtype=torch.bool, device=dev)
        prio = torch.as_tensor(prio, dtype=torch.int32, device=dev).expand(n)
        keys_l.append(keys)
        dst_l.append(dst.to(torch.int32))
        w_l.append(is_write)
        valid_l.append(valid)
        prio_l.append(prio)
        bounds.append((off, off + n))
        off += n
    (sq_tail, rr_ptr, queue, vslot, accepted, ticket_id,
     per_seg) = _ops.sq_enqueue(
        qs.sq_key, qs.sq_dst, qs.sq_is_write, qs.sq_prio, qs.sq_tenant,
        qs.sq_ticket, qs.sq_tail, qs.sq_head, qs.rr_ptr, qs.dev_enqueued,
        torch.cat(keys_l), torch.cat(dst_l), torch.cat(w_l),
        torch.cat(prio_l), torch.cat(valid_l),
        seg_bounds=tuple(bounds), n_devices=qs.n_devices,
        stripe_blocks=qs.stripe_blocks, tenant=tenant)

    receipts = []
    for i, (s, e) in enumerate(bounds):
        acc = accepted[s:e]
        receipts.append(SubmitReceipt(
            queue=torch.where(acc, queue[s:e], -1),
            vslot=torch.where(acc, vslot[s:e], -1),
            accepted=acc,
            ticket=torch.where(acc, ticket_id[s:e], -1),
            n_accepted=per_seg["n_accepted"][i],
            n_dropped=per_seg["n_dropped"][i],
            n_doorbells=per_seg["n_doorbells"][i]))
    qs.sq_tail.copy_(sq_tail)
    qs.rr_ptr.copy_(rr_ptr)
    qs.ticket_total += per_seg["n_tickets"].sum(dtype=torch.int32)
    qs.doorbells += per_seg["n_doorbells"].sum(dtype=torch.int32)
    qs.dropped += per_seg["n_dropped"].sum(dtype=torch.int32)
    qs.dev_dropped += per_seg["dev_dropped"].sum(0, dtype=torch.int32)
    qs.dev_enqueued += per_seg["dev_accepted"].sum(0, dtype=torch.int32)
    qs.tenant_enqueued[tenant] += per_seg["n_accepted"].sum(dtype=torch.int32)
    qs.tenant_dropped[tenant] += per_seg["n_dropped"].sum(dtype=torch.int32)
    return qs, receipts


def enqueue(qs: QueueState, keys: torch.Tensor, dst=None, is_write=None,
            valid=None, prio=PRIO_DEMAND, tenant: int = 0):
    """Submit one wavefront of commands: a one-segment
    :func:`enqueue_segments` (bit-identical to the reference's single
    enqueue).  Returns ``(qs, receipt)``."""
    qs, (receipt,) = enqueue_segments(
        qs, [(keys, dst, is_write, valid, prio)], tenant=tenant)
    return qs, receipt


@dataclasses.dataclass
class DrainReceipt:
    """Order-free accounting of one full ring drain."""

    count: torch.Tensor         # () int32
    count_dev: torch.Tensor     # (n_devices,) int32
    count_tenant: torch.Tensor  # (n_tenants,) int32
    reads_dev: torch.Tensor     # (n_devices,) int32
    writes_dev: torch.Tensor    # (n_devices,) int32


def drain_accounting(qs: QueueState):
    """Drain every pending SQ entry, in place, returning accounting only:
    rings cleared, heads advanced to tails, one CQ doorbell, completion
    counters bumped.  Returns ``(qs, DrainReceipt)``."""
    count, count_dev, count_tenant, reads_dev, writes_dev = _ops.wfq_drain(
        qs.sq_key, qs.sq_is_write, qs.sq_tenant,
        n_devices=qs.n_devices, n_tenants=qs.n_tenants)
    qs.sq_key.fill_(-1)
    qs.sq_dst.fill_(-1)
    qs.sq_is_write.fill_(False)
    qs.sq_prio.fill_(0)
    qs.sq_tenant.fill_(0)
    qs.sq_ticket.fill_(-1)
    qs.sq_head.copy_(qs.sq_tail)
    qs.doorbells += (count > 0).to(torch.int32)
    qs.completions += count
    qs.dev_completed += count_dev
    qs.tenant_completed += count_tenant
    return qs, DrainReceipt(count=count, count_dev=count_dev,
                            count_tenant=count_tenant, reads_dev=reads_dev,
                            writes_dev=writes_dev)


def in_flight(qs: QueueState) -> torch.Tensor:
    """Current total queue depth in use (the Little's-law Q_d)."""
    return (qs.sq_tail - qs.sq_head).sum(dtype=torch.int32)


def in_flight_per_device(qs: QueueState) -> torch.Tensor:
    return (qs.sq_tail - qs.sq_head).reshape(
        qs.n_devices, qs.group_size).sum(1, dtype=torch.int32)


def in_flight_per_tenant(qs: QueueState) -> torch.Tensor:
    pend = (qs.sq_key >= 0).reshape(-1)
    out = torch.zeros((qs.n_tenants,), dtype=torch.int32,
                      device=qs.sq_key.device)
    return out.index_add_(
        0, torch.where(pend, qs.sq_tenant.reshape(-1), 0).to(torch.int64),
        pend.to(torch.int32))
