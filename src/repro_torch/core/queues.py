"""High-throughput I/O queues: BaM's §III-C I/O stack as a prefix sum.

Port of ``repro.core.queues``: the SQ ring pool, the fused multi-segment
enqueue (routing around hard-failed devices), the closed-form drain with
its fault accounting, and ``service_all``, the drain that returns the
completion stream in its arbitration order (priority-major; weighted-fair
across tenants within a priority class).  The rings are updated in place
where the reference rebuilds a ``QueueState``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.ssd import _alive_devices
from repro_torch.kernels import ops as _ops

__all__ = ["QueueState", "make_queues", "enqueue", "enqueue_segments",
           "service_all", "drain_accounting", "Completions",
           "SubmitReceipt", "DrainReceipt",
           "PRIO_DEMAND", "PRIO_READAHEAD", "in_flight",
           "in_flight_per_device", "in_flight_per_tenant"]

PRIO_DEMAND = 0      # demand reads and write-backs
PRIO_READAHEAD = 1   # speculative readahead fills


@dataclasses.dataclass
class QueueState:
    """A pool of NVMe submission queues, split into ``n_devices`` equal
    groups: queues ``[d*group, (d+1)*group)`` belong to device ``d``.
    ``failed_devices`` (static, mirroring the SSD array's ``FaultModel``)
    lists hard-failed channels, whose blocks route to the survivors.
    ``tenant_weights`` are the per-tenant service weights of the
    weighted-fair drain (:func:`service_all`)."""

    num_queues: int
    depth: int
    n_devices: int
    stripe_blocks: int
    n_tenants: int
    tenant_weights: tuple
    failed_devices: tuple
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
                tenant_weights: tuple | None = None,
                failed_devices=(), device="cpu") -> QueueState:
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if stripe_blocks < 1:
        raise ValueError(f"stripe_blocks must be >= 1, got {stripe_blocks}")
    if num_queues % n_devices != 0:
        raise ValueError(
            f"num_queues ({num_queues}) must be a multiple of n_devices "
            f"({n_devices})")
    if n_tenants < 1:
        raise ValueError(f"n_tenants must be >= 1, got {n_tenants}")
    if tenant_weights is None:
        tenant_weights = (1.0,) * n_tenants
    tenant_weights = tuple(float(w) for w in tenant_weights)
    if len(tenant_weights) != n_tenants:
        raise ValueError(
            f"tenant_weights has {len(tenant_weights)} entries for "
            f"n_tenants={n_tenants}")
    if any(w <= 0 for w in tenant_weights):
        raise ValueError(f"tenant_weights must be positive: {tenant_weights}")
    if failed_devices:
        _alive_devices(n_devices, failed_devices)   # range / all-dead check
    failed_devices = tuple(sorted({int(d) for d in failed_devices}))

    def ring(fill, dt=torch.int32):
        return torch.full((num_queues, depth), fill, dtype=dt, device=device)

    def zi(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return QueueState(
        num_queues=num_queues, depth=depth, n_devices=n_devices,
        stripe_blocks=stripe_blocks, n_tenants=n_tenants,
        tenant_weights=tenant_weights,
        failed_devices=failed_devices, sq_key=ring(-1), sq_dst=ring(-1),
        sq_is_write=ring(False, torch.bool),
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
        stripe_blocks=qs.stripe_blocks, tenant=tenant,
        failed_devices=qs.failed_devices)

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
    """Order-free accounting of one full ring drain; the fault fields are
    None when the drain ran without a fault model."""

    count: torch.Tensor         # () int32
    count_dev: torch.Tensor     # (n_devices,) int32
    count_tenant: torch.Tensor  # (n_tenants,) int32
    reads_dev: torch.Tensor     # (n_devices,) int32
    writes_dev: torch.Tensor    # (n_devices,) int32
    # fault fields, (n_devices,) int32 unless said otherwise
    errors_dev: torch.Tensor | None = None      # errored commands
    errors_tenant: torch.Tensor | None = None   # (n_tenants,)
    err_reads_dev: torch.Tensor | None = None   # errored reads
    err_writes_dev: torch.Tensor | None = None  # errored writes
    retry_reads_dev: torch.Tensor | None = None   # read re-issues
    retry_writes_dev: torch.Tensor | None = None  # write re-issues
    transient_errors: torch.Tensor | None = None  # () attempt failures


def _retire(qs: QueueState, count, count_dev, count_tenant) -> None:
    """Completion-side ring maintenance of a full drain, in place: rings
    cleared, heads advanced to tails, one CQ doorbell, completion counters
    bumped."""
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


def drain_accounting(qs: QueueState, fault=None):
    """Drain every pending SQ entry, in place, returning accounting only:
    rings cleared, heads advanced to tails, one CQ doorbell, completion
    counters bumped.  ``fault`` (a ``FaultModel``) adds the error and
    retry counts of each pending command from its ``(device, sq_ticket)``
    stamp.  Returns ``(qs, DrainReceipt)``."""
    (count, count_dev, count_tenant, reads_dev, writes_dev,
     fstats) = _ops.wfq_drain(
        qs.sq_key, qs.sq_is_write, qs.sq_tenant, qs.sq_ticket,
        n_devices=qs.n_devices, n_tenants=qs.n_tenants, fault=fault)
    _retire(qs, count, count_dev, count_tenant)
    return qs, DrainReceipt(count=count, count_dev=count_dev,
                            count_tenant=count_tenant, reads_dev=reads_dev,
                            writes_dev=writes_dev, **fstats)


@dataclasses.dataclass
class Completions:
    """Drained commands in their arbitration order; filter with ``valid``.
    The per-command fields have ``num_queues * depth`` entries; ``status``
    is 0 OK, 1 error (all 0 without a fault model).  The counts are
    (n_devices,) or (n_tenants,) int32; the fault counts are zeros without
    a fault model."""

    keys: torch.Tensor
    dst: torch.Tensor
    is_write: torch.Tensor
    prio: torch.Tensor
    tenant: torch.Tensor
    valid: torch.Tensor
    status: torch.Tensor
    count: torch.Tensor          # () int32
    count_dev: torch.Tensor
    count_tenant: torch.Tensor
    error_dev: torch.Tensor
    error_tenant: torch.Tensor
    retries_dev: torch.Tensor
    transient: torch.Tensor      # () int32 attempt failures
    err_reads_dev: torch.Tensor
    err_writes_dev: torch.Tensor
    retry_reads_dev: torch.Tensor
    retry_writes_dev: torch.Tensor


def _stable_order(key: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Refine ``order`` by a stable sort on ``key[order]``."""
    return order[torch.sort(key[order], stable=True).indices]


def service_all(qs: QueueState, fault=None):
    """The simulated NVMe controller: consume every pending SQ entry, in
    place, and return the completion stream.  Returns ``(qs,
    Completions)``.

    Demand commands come back ahead of readahead commands, stable in ring
    order within a class; the sort runs only when readahead is pending.
    With ``n_tenants > 1`` each priority class is drained weighted-fair:
    the i-th pending command of tenant t within its (tenant, priority)
    class finishes at virtual time ``float32(i + 1) / float32(weight[t])``,
    and the stream is the reference's ``lexsort((pos, vfinish,
    sort_key))``, built from stable sorts, last key first; it runs when
    readahead is pending or more than one tenant has commands.  The
    arbitration gate is a host branch (one device sync) where the
    reference has a ``lax.cond``.  ``fault`` resolves each command's
    status, error and retry counts from its ``(device, sq_ticket)``
    stamp, as :func:`drain_accounting` does.
    """
    dev_t = qs.sq_key.device
    nd, gsize, depth = qs.n_devices, qs.group_size, qs.depth
    nt = qs.n_tenants
    pending = qs.sq_key >= 0

    def group_sum(x):
        return x.reshape(nd, gsize * depth).sum(1, dtype=torch.int32)

    def per_tenant(mask):
        flat = mask.reshape(-1)
        out = torch.zeros((nt,), dtype=torch.int32, device=dev_t)
        return out.index_add_(
            0, torch.where(flat, qs.sq_tenant.reshape(-1), 0).to(torch.int64),
            flat.to(torch.int32))

    count = pending.sum(dtype=torch.int32)
    count_dev = group_sum(pending)
    count_tenant = per_tenant(pending)
    flat_pend = pending.reshape(-1)
    flat_prio = qs.sq_prio.reshape(-1)
    flat_tenant = qs.sq_tenant.reshape(-1)
    zd = torch.zeros((nd,), dtype=torch.int32, device=dev_t)
    # bamlint: ignore[BAM104] -- fault is static config, not a tensor
    if fault is not None and fault.enabled:
        dev_of_entry = torch.div(
            torch.arange(qs.num_queues, dtype=torch.int32, device=dev_t),
            gsize, rounding_mode="floor")[:, None]
        ok_e, retries_e, transient_e = fault.command_status(dev_of_entry,
                                                            qs.sq_ticket)
        err_e = pending & ~ok_e
        flat_status = err_e.to(torch.int32).reshape(-1)
        error_dev = group_sum(err_e)
        error_tenant = per_tenant(err_e)
        retries_dev = group_sum(torch.where(pending, retries_e, 0))
        transient = torch.where(pending, transient_e, 0).sum(
            dtype=torch.int32)
        err_writes_dev = group_sum(err_e & qs.sq_is_write)
        retry_writes_dev = group_sum(
            torch.where(pending & qs.sq_is_write, retries_e, 0))
        fkw = dict(error_dev=error_dev, error_tenant=error_tenant,
                   retries_dev=retries_dev, transient=transient,
                   err_reads_dev=error_dev - err_writes_dev,
                   err_writes_dev=err_writes_dev,
                   retry_reads_dev=retries_dev - retry_writes_dev,
                   retry_writes_dev=retry_writes_dev)
    else:
        flat_status = torch.zeros_like(flat_prio)
        fkw = dict(error_dev=zd, error_tenant=torch.zeros_like(count_tenant),
                   retries_dev=zd.clone(),
                   transient=torch.zeros((), dtype=torch.int32,
                                         device=dev_t),
                   err_reads_dev=zd.clone(), err_writes_dev=zd.clone(),
                   retry_reads_dev=zd.clone(), retry_writes_dev=zd.clone())
    flat = [qs.sq_key.reshape(-1).clone(), qs.sq_dst.reshape(-1).clone(),
            qs.sq_is_write.reshape(-1).clone(), flat_prio.clone(),
            flat_tenant.clone(), flat_pend, flat_status]

    has_ra = flat_pend & (flat_prio != PRIO_DEMAND)
    gate = has_ra.any()
    if nt > 1:
        gate = gate | ((count_tenant > 0).sum() > 1)
    if bool(gate):  # bamlint: ignore[BAM102] -- the arbitration gate
        sort_key = torch.where(flat_pend, flat_prio,
                               torch.full_like(flat_prio, 2 ** 31 - 1))
        order = torch.arange(sort_key.shape[0], device=dev_t)
        if nt > 1:
            w = torch.tensor(qs.tenant_weights, dtype=torch.float32,
                             device=dev_t)
            cls = (flat_tenant * 2 + flat_prio.clamp(0, 1)).to(torch.int64)
            oh = torch.zeros((cls.shape[0], 2 * nt), dtype=torch.int32,
                             device=dev_t)
            oh.scatter_(1, cls[:, None], flat_pend.to(torch.int32)[:, None])
            rank = torch.gather(torch.cumsum(oh, 0, dtype=torch.int32) - oh,
                                1, cls[:, None])[:, 0]
            vfinish = (rank + 1).to(torch.float32) \
                / w[flat_tenant.to(torch.int64)]
            order = _stable_order(vfinish, order)
        order = _stable_order(sort_key, order)
        flat = [x[order] for x in flat]
    keys, dst, is_write, prio, ten, valid, status = flat
    comps = Completions(keys=keys, dst=dst, is_write=is_write, prio=prio,
                        tenant=ten, valid=valid, status=status, count=count,
                        count_dev=count_dev, count_tenant=count_tenant,
                        **fkw)
    _retire(qs, count, count_dev, count_tenant)
    return qs, comps


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
