"""Plain PyTorch versions of the hot-path kernels.

Ports of ``repro.kernels.ref``: ``cache_probe_ref``, ``probe_allocate_ref``,
``gather_blocks_ref``, ``paged_attention_ref`` and ``flash_attention_ref``
are the plain versions of the five CUDA kernels (the CPU path, and the
yardstick the kernels are held against on the card);
``flash_attention_lse_ref`` and ``flash_attention_bwd_ref`` are the
plain versions of the flash forward with its log-sum-exp and of the flash
backward kernel; ``sq_enqueue_ref`` and ``wfq_drain_ref`` (with its fault
accounting) were never Pallas kernels and stay plain torch on every
device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.ssd import device_of_block
from repro_torch.utils import mix_hash, segment_rank

NEG_INF = -1e30


def _flash_scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                  window: int | None):
    """The scaled f32 scores (B, Hq, Sq, Skv), masked to NEG_INF, and the
    (Sq, Skv) mask: key position <= query position (causal) and > query
    position - window (with a window)."""
    Sq, D = q.shape[2], q.shape[3]
    Skv = k.shape[2]
    kr = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * (1.0 / math.sqrt(D))
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if window is not None:
        mask &= kv_pos > q_pos - window
    return torch.where(mask, s, NEG_INF), mask


def _flash_out(s, mask, v, group, dtype):
    vr = v.repeat_interleave(group, dim=1).float()
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr)
    return torch.where(mask.any(dim=-1)[:, None], out, 0.0).to(dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D).  Plain masked softmax in
    float32 with scale 1/sqrt(D); query head h reads kv head h // (Hq //
    Hkv); a row with no live key is zero.  Output in q's dtype."""
    s, mask = _flash_scores(q, k, causal=causal, window=window)
    return _flash_out(s, mask, v, q.shape[1] // k.shape[1], q.dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int | None = None):
    """:func:`flash_attention_ref`'s output and the per-row log-sum-exp of
    the scaled scores, ``lse = m + log(max(l, 1e-30))`` (m the row's
    largest masked score, l the sum of exp(s - m) over its live keys), f32
    (B, Hq, Sq), as the reference's ``_fa_vjp_fwd`` saves it.  A row with
    no live key has m = NEG_INF, so lse = NEG_INF in f32."""
    s, mask = _flash_scores(q, k, causal=causal, window=window)
    m = s.amax(dim=-1)
    l = torch.where(mask, torch.exp(s - m[..., None]), 0.0).sum(-1)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return _flash_out(s, mask, v, q.shape[1] // k.shape[1], q.dtype), lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True, window: int | None = None):
    """The flash backward of the reference's ``_fa_vjp_bwd``
    (``repro.kernels.ref``) without its blocks: P = exp(S scale - lse)
    under the mask, dV = P^T dO, dP = dO V^T, Delta = rowsum(dO * O),
    dS = P * (dP - Delta) * scale, dQ = dS K, dK = dS^T Q, all in f32,
    each GQA group summed into its kv head.  A row with no live key has
    P = 0 and contributes nothing.  Returns (dq, dk, dv) in the inputs'
    dtype."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    s, mask = _flash_scores(q, k, causal=causal, window=window)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    do = dout.float()
    kr = k.repeat_interleave(group, dim=1).float()
    vr = v.repeat_interleave(group, dim=1).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vr)
    delta = (do * out.float()).sum(-1)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())

    def per_kv_head(g):
        return g.reshape(B, Hkv, group, Skv, D).sum(2)
    return (dq.to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        seq_lens: torch.Tensor) -> torch.Tensor:
    """One-token attention over a paged pool, scale 1/sqrt(D).  q:
    (B, Hq, D); pools (B, P, page, Hkv, D); page_table (B, NP) int32, -1 a
    hole; seq_lens (B,).  Keys at holes and at positions >= seq_lens are
    masked; a row with no live key is zero.  Output (B, Hq, D) in q's
    dtype."""
    B, Hq, D = q.shape
    page, Hkv = k_pages.shape[2], k_pages.shape[3]
    NP = page_table.shape[1]
    group = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    safe = torch.clamp(page_table, min=0).long()               # (B, NP)
    bidx = torch.arange(B, device=q.device)[:, None]
    S = NP * page
    k = k_pages[bidx, safe].permute(0, 3, 1, 2, 4).reshape(B, Hkv, S, D)
    v = v_pages[bidx, safe].permute(0, 3, 1, 2, 4).reshape(B, Hkv, S, D)
    k = k.repeat_interleave(group, dim=1).float()
    v = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k) * scale
    pos = torch.arange(S, device=q.device)[None, :]
    hole = (page_table < 0).repeat_interleave(page, dim=1)     # (B, S)
    live = (pos < seq_lens[:, None]) & ~hole
    s = torch.where(live[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(live[:, None], p, 0.0)
    out = torch.einsum("bhk,bhkd->bhd", p, v)
    return out.to(q.dtype)


def paged_attention_chunked_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                page_table: torch.Tensor,
                                seq_lens: torch.Tensor, *,
                                chunk: int = 128) -> torch.Tensor:
    """The split-KV arithmetic of ``csrc/paged_attention.cu`` in plain
    PyTorch (float32, natural exp), for the tests: the logical positions cut
    into chunks of ``chunk``; per chunk the partial (m, l, acc) over its
    live positions, with m = NEG_INF, l = 0 and acc = 0 where none is live;
    then the chunks combined in logical order, out = sum acc_i e^(m_i - M)
    / max(sum l_i e^(m_i - M), 1e-30) with M = max m_i.  Same arguments
    and result as :func:`paged_attention_ref`."""
    B, Hq, D = q.shape
    page, Hkv = k_pages.shape[2], k_pages.shape[3]
    NP = page_table.shape[1]
    group = Hq // Hkv
    S = NP * page
    nc = -(-S // chunk)
    safe = torch.clamp(page_table, min=0).long()
    bidx = torch.arange(B, device=q.device)[:, None]
    k = k_pages[bidx, safe].permute(0, 3, 1, 2, 4).reshape(B, Hkv, S, D)
    v = v_pages[bidx, safe].permute(0, 3, 1, 2, 4).reshape(B, Hkv, S, D)
    pad = nc * chunk - S
    k = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    v = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    hole = (page_table < 0).repeat_interleave(page, dim=1)
    pos = torch.arange(nc * chunk, device=q.device)[None, :]
    live = (pos < seq_lens[:, None]) & (pos < S) \
        & ~torch.nn.functional.pad(hole, (0, pad))              # (B, nc*chunk)
    qg = q.float().reshape(B, Hkv, group, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k) / math.sqrt(D)
    live = live[:, None, None, :]
    s = torch.where(live, s, NEG_INF).reshape(B, Hkv, group, nc, chunk)
    live = live.reshape(B, 1, 1, nc, chunk)
    m = s.max(-1).values                                        # (B,Hkv,G,nc)
    p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bhgck,bhckd->bhgcd", p,
                       v.reshape(B, Hkv, nc, chunk, D))
    M = m.max(-1, keepdim=True).values
    w = torch.exp(m - M)                                        # finite: m >= NEG_INF
    l_tot = (l * w).sum(-1)
    out = (acc * w[..., None]).sum(-2) / torch.clamp(l_tot, min=1e-30)[..., None]
    return out.reshape(B, Hq, D).to(q.dtype)


def gather_blocks_ref(data: torch.Tensor, slots: torch.Tensor,
                      off: torch.Tensor | None = None) -> torch.Tensor:
    """data: (num_lines, line_elems); slots: (n,) -> (n, line_elems), or
    with ``off`` the (n,) elements ``data[slots, off]``; zero where
    ``slots < 0``."""
    safe = torch.clamp(slots, min=0).to(torch.int64)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    if off is not None:
        return torch.where(slots >= 0, data[safe, off.to(torch.int64)], zero)
    return torch.where((slots >= 0)[:, None], data[safe], zero)


def cache_probe_ref(tags: torch.Tensor, keys: torch.Tensor,
                    owner: torch.Tensor | None = None, tenant: int = 0):
    """Tag probe of a raw (num_sets, ways) directory: ``(hit, slot)``, slot
    -1 on a miss.  With ``owner`` a line only hits when it is ``tenant``'s.
    Negative keys never hit."""
    num_sets, ways = tags.shape
    valid = keys >= 0
    sets = (mix_hash(torch.where(valid, keys, 0)) % num_sets).to(torch.int64)
    rows = tags[sets]
    eq = (rows == keys[:, None]) & valid[:, None]
    if owner is not None:
        eq = eq & (owner[sets] == tenant)
    hit = eq.any(dim=1)
    way = torch.argmax(eq.to(torch.int32), dim=1)
    slot = torch.where(hit, sets * ways + way, -1).to(torch.int32)
    return hit, slot


def probe_allocate_ref(tags, owner, refcount, dirty, speculative, clock_hand,
                       keys, valid, alloc_mask=None, protect_slots=None, *,
                       tenant=0, way_lo=0, way_hi=None, spec_insert=False,
                       protect_hits=True):
    """Fused probe + class-then-clock victim select: the plain version of
    the ``probe_allocate`` kernel.  Returns ``(hit, hit_slot, way, ok,
    evicted_key, evicted_dirty)``; allocation outputs are -1 / False on
    rows with ``ok=False``.  See ``repro.kernels.ref.probe_allocate_ref``.
    """
    num_sets, ways = tags.shape
    way_hi = ways if way_hi is None else way_hi
    m = keys.shape[0]
    dev = keys.device
    sets = (mix_hash(torch.where(valid, keys, 0)) % num_sets).to(torch.int64)

    rows_tag = tags[sets]
    rows_owner = owner[sets]
    eq = (rows_tag == keys[:, None]) & valid[:, None] & (rows_owner == tenant)
    hit = eq.any(dim=1)
    hway = torch.argmax(eq.to(torch.int32), dim=1)
    hslot = torch.where(hit, sets * ways + hway, -1).to(torch.int32)

    miss = valid & ~hit
    if alloc_mask is not None:
        miss = miss & alloc_mask

    def no_miss():
        return (torch.full((m,), -1, dtype=torch.int32, device=dev),
                torch.zeros((m,), dtype=torch.bool, device=dev),
                torch.full((m,), -1, dtype=torch.int32, device=dev),
                torch.zeros((m,), dtype=torch.bool, device=dev))

    # Host-side branch in place of the reference's lax.cond (a device
    # sync): with no miss every victim-select output is masked anyway.
    if not bool(miss.any()):
        return (hit, hslot) + no_miss()

    rows_ref = refcount[sets]
    rows_dirty = dirty[sets]
    rows_spec = speculative[sets]
    elig = rows_ref == 0
    foreign_dirty = (rows_owner != tenant) & (rows_tag >= 0) & rows_dirty
    elig = elig & ~foreign_dirty
    warange = torch.arange(ways, dtype=torch.int32, device=dev)
    if way_lo != 0 or way_hi != ways:
        elig = elig & ((warange >= way_lo) & (warange < way_hi))[None, :]
    if spec_insert:
        elig = elig & ~(rows_spec & (rows_tag >= 0))
    # one spare entry takes the dropped writes of the reference's
    # ``.at[].set(mode="drop")``
    n_lines = num_sets * ways
    overlay = torch.zeros((n_lines + 1,), dtype=torch.bool, device=dev)
    if protect_hits:
        overlay[torch.where(hit, hslot.to(torch.int64), n_lines)] = True
    if protect_slots is not None:
        ps = protect_slots.to(torch.int64)
        overlay[torch.where((ps >= 0) & (ps < n_lines), ps, n_lines)] = True
    elig = elig & ~overlay[:n_lines].reshape(num_sets, ways)[sets]

    rank = segment_rank(sets.to(torch.int32), miss)
    hand = clock_hand[sets]
    clock_pos = torch.remainder(warange[None, :] - hand[:, None], ways)
    vclass = torch.where(rows_tag < 0, 0,
                         torch.where(rows_spec, 1, 2)).to(torch.int32)
    key_w = vclass * ways + clock_pos
    smaller = key_w[:, None, :] < key_w[:, :, None]
    eidx = (smaller & elig[:, None, :]).sum(dim=2, dtype=torch.int32)
    n_elig = elig.sum(dim=1, dtype=torch.int32)
    sel = elig & (eidx == rank[:, None]) & miss[:, None]
    ok = miss & (n_elig >= rank + 1)
    way = torch.argmax(sel.to(torch.int32), dim=1)
    safe_way = torch.where(ok, way, 0)
    rows_i = torch.arange(m, device=dev)
    evicted_key = torch.where(ok, rows_tag[rows_i, safe_way], -1)
    evicted_dirty = ok & rows_dirty[rows_i, safe_way]
    return (hit, hslot, torch.where(ok, way, -1).to(torch.int32), ok,
            evicted_key.to(torch.int32), evicted_dirty)


def sq_enqueue_ref(sq_key, sq_dst, sq_is_write, sq_prio, sq_tenant,
                   sq_ticket, sq_tail, sq_head, rr_ptr, dev_enqueued,
                   keys, dst, is_write, prio, valid, *,
                   seg_bounds, n_devices, stripe_blocks, tenant,
                   failed_devices=()):
    """Fused multi-segment SQ enqueue (see ``repro.kernels.ref``), routing
    around ``failed_devices``.

    The six ring fields are updated in place (the reference returns new
    rings).  Returns ``(sq_tail, rr_ptr, queue, vslot, accepted, ticket_id,
    per_seg)``.
    """
    nq, depth = sq_key.shape
    gsize = nq // n_devices
    nd = n_devices
    dev_t = keys.device
    tail = sq_tail
    rr = rr_ptr
    dev_base = dev_enqueued
    darange = torch.arange(nd, dtype=torch.int32, device=dev_t)
    q_parts, v_parts, a_parts, t_parts = [], [], [], []
    n_acc, n_drop, n_db, n_tick = [], [], [], []
    dev_drop, dev_acc = [], []
    for (s, e) in seg_bounds:
        k_s, v_s = keys[s:e], valid[s:e]
        dev = device_of_block(k_s, nd, stripe_blocks, failed_devices)
        dev64 = dev.to(torch.int64)
        onehot = ((dev[:, None] == darange[None, :])
                  & v_s[:, None]).to(torch.int32)
        ticket = torch.gather(
            torch.cumsum(onehot, 0, dtype=torch.int32) - onehot, 1,
            dev64[:, None])[:, 0]
        k_dev = onehot.sum(0, dtype=torch.int32)
        queue = dev * gsize + torch.remainder(rr[dev64] + ticket, gsize)
        queue64 = queue.to(torch.int64)
        pos_in_q = torch.div(ticket, gsize, rounding_mode="floor")
        vslot = tail[queue64] + pos_in_q
        fits = (vslot - sq_head[queue64]) < depth
        accepted = v_s & fits
        acc_i = accepted.to(torch.int32)
        # bincount in place of the (n, nq) one-hot: integer sums are
        # order-free
        per_q = torch.zeros((nq,), dtype=torch.int32, device=dev_t)
        per_q.index_add_(0, queue64, acc_i)
        tail = tail + per_q
        rr = torch.remainder(rr + k_dev, gsize)
        drops = v_s & ~fits
        acc_oh = onehot * acc_i[:, None]
        arank = torch.gather(
            torch.cumsum(acc_oh, 0, dtype=torch.int32) - acc_oh, 1,
            dev64[:, None])[:, 0]
        dev_acc_seg = acc_oh.sum(0, dtype=torch.int32)
        t_parts.append((dev_base[dev64] + arank).to(torch.int32))
        dev_base = dev_base + dev_acc_seg
        q_parts.append(queue.to(torch.int32))
        v_parts.append(vslot.to(torch.int32))
        a_parts.append(accepted)
        n_acc.append(acc_i.sum(dtype=torch.int32))
        n_drop.append(drops.sum(dtype=torch.int32))
        n_db.append((per_q > 0).sum(dtype=torch.int32))
        n_tick.append(k_dev.sum(dtype=torch.int32))
        dev_drop.append((onehot * drops.to(torch.int32)[:, None])
                        .sum(0, dtype=torch.int32))
        dev_acc.append(dev_acc_seg)

    queue = torch.cat(q_parts)
    vslot = torch.cat(v_parts)
    accepted = torch.cat(a_parts)
    ticket_id = torch.cat(t_parts)

    # Host-side branch in place of the reference's lax.cond (a device
    # sync): a submission that enqueues nothing leaves the rings as they
    # are.  Accepted (queue, slot) pairs are distinct, so the write order
    # cannot matter.
    sel = torch.nonzero(accepted).squeeze(1)
    if sel.numel() > 0:
        flat = queue[sel].to(torch.int64) * depth \
            + torch.remainder(vslot[sel], depth).to(torch.int64)
        sq_key.view(-1)[flat] = keys[sel]
        sq_dst.view(-1)[flat] = dst[sel]
        sq_is_write.view(-1)[flat] = is_write[sel]
        sq_prio.view(-1)[flat] = prio[sel]
        sq_tenant.view(-1)[flat] = tenant
        sq_ticket.view(-1)[flat] = ticket_id[sel]
    per_seg = dict(
        n_accepted=torch.stack(n_acc), n_dropped=torch.stack(n_drop),
        n_doorbells=torch.stack(n_db), n_tickets=torch.stack(n_tick),
        dev_dropped=torch.stack(dev_drop), dev_accepted=torch.stack(dev_acc))
    return tail, rr, queue, vslot, accepted, ticket_id, per_seg


def wfq_drain_ref(sq_key, sq_is_write, sq_tenant, sq_ticket=None, *,
                  n_devices, n_tenants, fault=None):
    """Closed-form drain accounting: ``(count, count_dev, count_tenant,
    reads_dev, writes_dev, fstats)`` as order-free reductions over the
    pending SQ entries.  ``fstats`` holds the fault fields of the
    ``DrainReceipt``: with an enabled ``fault`` each pending command's
    retry loop is resolved from its ``(device, sq_ticket)`` stamp, else
    it is empty (the receipt's fault fields stay None)."""
    nq, depth = sq_key.shape
    gsize = nq // n_devices
    dev_t = sq_key.device
    pending = sq_key >= 0
    count = pending.sum(dtype=torch.int32)

    def group_sum(x):
        return x.reshape(n_devices, gsize * depth).sum(1, dtype=torch.int32)

    def per_tenant(mask):
        flat = mask.reshape(-1)
        out = torch.zeros((n_tenants,), dtype=torch.int32, device=dev_t)
        return out.index_add_(
            0, torch.where(flat, sq_tenant.reshape(-1), 0).to(torch.int64),
            flat.to(torch.int32))

    count_dev = group_sum(pending)
    writes_dev = group_sum(pending & sq_is_write)
    reads_dev = count_dev - writes_dev
    count_tenant = per_tenant(pending)
    if fault is not None and fault.enabled:
        dev_of_entry = torch.div(
            torch.arange(nq, dtype=torch.int32, device=dev_t), gsize,
            rounding_mode="floor")[:, None]
        ok_e, retries_e, transient_e = fault.command_status(dev_of_entry,
                                                            sq_ticket)
        err = pending & ~ok_e
        errors_dev = group_sum(err)
        err_writes_dev = group_sum(err & sq_is_write)
        fstats = dict(
            errors_dev=errors_dev, errors_tenant=per_tenant(err),
            err_reads_dev=errors_dev - err_writes_dev,
            err_writes_dev=err_writes_dev,
            retry_reads_dev=group_sum(
                torch.where(pending & ~sq_is_write, retries_e, 0)),
            retry_writes_dev=group_sum(
                torch.where(pending & sq_is_write, retries_e, 0)),
            transient_errors=torch.where(pending, transient_e, 0).sum(
                dtype=torch.int32))
    else:
        fstats = {}
    return count, count_dev, count_tenant, reads_dev, writes_dev, fstats
