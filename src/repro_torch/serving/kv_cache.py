"""BaM-paged KV cache management: the serving-side face of the BaM cache.

Port of ``repro.serving.kv_cache``.  A decode cache holds, per paged
layer, a paged pool ``(B, P, page, Hkv, hd)`` and a page table ``(B, NP)``
(the layer itself, or the first item of a tuple layer as in hymba's
cache); a cache with no paged layer moves nothing:

* the pool is the BaM cache's data array and the page table its tag store;
* **spill** evicts cold pages (those older than the last ``keep_last``
  tokens) to the storage tier and leaves a hole (-1) in the page table;
* **fetch** brings spilled pages back before a decode step, each into the
  lowest free physical page of its sequence.

The storage tier is a host-side dict keyed ``(layer, seq, logical_page)``.
The reference copies every pool to the host and back on each call; here
only the pages that move cross the link: a spill gathers them on the
device and copies them to the host in one transfer per layer, a fetch
copies them back in one transfer per layer and scatters them into the
pool in place.  Page tables are replaced, never written in place; but a
fetched page may land in the physical page a spilled one left, so a cache
from before a spill that shares the pools is spent once a fetch has run.
Accounting reuses the port's float64 ``IOMetrics``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from repro_torch.core.metrics import IOMetrics
from repro_torch.core.ssd import INTEL_OPTANE_P5800X, ArrayOfSSDs
from repro_torch.utils import Tagged

__all__ = ["PagedKVManager", "spill_cold_pages", "fetch_holes"]


def _tagged(item):
    """A layer's attention entry: the layer itself, or the first item of
    a tuple layer (hymba's ``(Tagged, ssm state)``)."""
    return item[0] if isinstance(item, tuple) else item


def _paged_layers(cache) -> list:
    """(layer index, entry) of every paged layer of a cache."""
    return [(i, t.value) for i, t in enumerate(map(_tagged, cache["layers"]))
            if isinstance(t, Tagged) and t.kind == "paged"]


def _with_entries(cache, updates: dict):
    """A new cache whose layers ``updates`` maps to new entries (a tuple
    layer keeps its other items)."""
    layers = list(cache["layers"])
    for li, entry in updates.items():
        item = layers[li]
        layers[li] = ((Tagged("paged", entry),) + item[1:]
                      if isinstance(item, tuple) else Tagged("paged", entry))
    cache2 = dict(cache)
    cache2["layers"] = tuple(layers)
    return cache2


def _host_tables(paged) -> torch.Tensor:
    """Every paged layer's page table on the host, in one transfer."""
    return torch.stack([e["page_table"] for _, e in paged]).cpu()


def spill_cold_pages(cache, keep_last: int,
                     store_fn: Callable) -> Tuple[dict, int]:
    """Evict the logical pages older than the last ``keep_last`` tokens.

    ``store_fn(layer, bs, lps, k, v)`` persists the pages of one layer:
    ``bs`` and ``lps`` are lists of sequence and logical-page indices, and
    ``k``, ``v`` the pages' contents ``(n, page, Hkv, hd)`` on the host.
    Returns (cache', n_spilled); holes are -1 in the new page tables.
    """
    paged = _paged_layers(cache)
    if not paged:
        return cache, 0
    seq_lens = cache["seq_lens"].cpu().tolist()
    tables = _host_tables(paged)
    n_spilled, updates = 0, {}
    for (li, entry), pt in zip(paged, tables):
        page = entry["k_pages"].shape[2]
        rows = pt.tolist()
        bs, lps, phys = [], [], []
        for b, n_tok in enumerate(seq_lens):
            last_live = max(int(n_tok) - keep_last, 0) // page
            for lp in range(last_live):
                if rows[b][lp] >= 0:
                    bs.append(b)
                    lps.append(lp)
                    phys.append(rows[b][lp])
        if not bs:
            continue
        dev = entry["k_pages"].device
        bi = torch.tensor(bs, device=dev)
        pi = torch.tensor(phys, device=dev)
        store_fn(li, bs, lps, entry["k_pages"][bi, pi].cpu(),
                 entry["v_pages"][bi, pi].cpu())
        pt2 = pt.clone()
        pt2[bs, lps] = -1
        updates[li] = dict(entry, page_table=pt2.to(dev))
        n_spilled += len(bs)
    return _with_entries(cache, updates), n_spilled


def fetch_holes(cache, load_fn: Callable) -> Tuple[dict, int]:
    """Re-materialise spilled pages.  ``load_fn(layer, b, lpage)`` returns
    the page's ``(k, v)`` on the host, or None when the store lacks it.

    Each fetched page takes the lowest free physical page of its sequence
    (free = not named by the page table), the page the reference's
    ``set.pop()`` gives; with no free page the hole stays.  Returns
    (cache', n_fetched)."""
    paged = _paged_layers(cache)
    if not paged:
        return cache, 0
    tables = _host_tables(paged)
    if not bool((tables < 0).any()):
        return cache, 0
    n, updates = 0, {}
    for (li, entry), pt in zip(paged, tables):
        if not bool((pt < 0).any()):
            continue
        P = entry["k_pages"].shape[1]
        pt2 = pt.clone()
        bs, phys, ks, vs = [], [], [], []
        for b, row in enumerate(pt.tolist()):
            free = sorted(set(range(P)) - {x for x in row if x >= 0})
            for lp, x in enumerate(row):
                if x >= 0:
                    continue
                got = load_fn(li, b, lp)
                if got is None or not free:
                    continue                 # not stored, or the pool is full
                ph = free.pop(0)
                bs.append(b)
                phys.append(ph)
                ks.append(got[0])
                vs.append(got[1])
                pt2[b, lp] = ph
        if not bs:
            continue
        dev = entry["k_pages"].device
        bi = torch.tensor(bs, device=dev)
        pi = torch.tensor(phys, device=dev)
        entry["k_pages"][bi, pi] = torch.stack(ks).to(dev)
        entry["v_pages"][bi, pi] = torch.stack(vs).to(dev)
        updates[li] = dict(entry, page_table=pt2.to(dev))
        n += len(bs)
    return _with_entries(cache, updates), n


@dataclasses.dataclass
class PagedKVManager:
    """Host-side page store and spill/fetch policy around a decode cache.

    The paper's mapping: pool pages are BaM cache lines in device memory,
    this host store is the NVMe tier, spill and fetch are BaM writes and
    reads, and the Little's-law model charges simulated device time per
    page moved.  With ``deferred=True`` the pages still move inside
    :meth:`maybe_spill` / :meth:`ensure_resident`, but the time charge
    waits for :meth:`drain`, which charges the whole batch at its batched
    concurrency.
    """

    ssd: ArrayOfSSDs = dataclasses.field(
        default_factory=lambda: ArrayOfSSDs(INTEL_OPTANE_P5800X, 1))
    keep_last: int = 4096            # hot window kept resident
    store: dict = dataclasses.field(default_factory=dict)
    metrics: IOMetrics = dataclasses.field(default_factory=IOMetrics.zeros)
    page_bytes: int = 0
    deferred: bool = False           # defer the device-time charge to drain()
    pending_spills: int = 0          # pages moved but not yet time-charged
    pending_fetches: int = 0

    def _store_fn(self, layer, bs, lps, k, v):
        for j, (b, lp) in enumerate(zip(bs, lps)):
            self.store[(layer, b, lp)] = (k[j], v[j])
        self.page_bytes = (k[0].numel() * k.element_size()
                           + v[0].numel() * v.element_size())

    def _load_fn(self, layer, b, lp):
        return self.store.get((layer, b, lp))

    def maybe_spill(self, cache):
        cache, n = spill_cold_pages(cache, self.keep_last, self._store_fn)
        if n:
            m = self.metrics
            self.metrics = dataclasses.replace(
                m, write_ops=m.write_ops + n,
                bytes_to_storage=m.bytes_to_storage + n * self.page_bytes)
            if self.deferred:
                self.pending_spills += n
            else:
                self._charge(n_writes=n)
        return cache, n

    def ensure_resident(self, cache):
        cache, n = fetch_holes(cache, self._load_fn)
        if n:
            m = self.metrics
            self.metrics = dataclasses.replace(
                m, misses=m.misses + n,
                bytes_from_storage=m.bytes_from_storage + n * self.page_bytes)
            if self.deferred:
                self.pending_fetches += n
            else:
                self._charge(n_reads=n)
        return cache, n

    def drain(self) -> Tuple[int, int]:
        """Charge every deferred page move as one batched drain; returns
        ``(n_reads, n_writes)`` retired (a no-op when nothing is pending)."""
        n_r, n_w = self.pending_fetches, self.pending_spills
        self.pending_fetches = self.pending_spills = 0
        self._charge(n_reads=n_r, n_writes=n_w)
        return n_r, n_w

    def _charge(self, n_reads: int = 0, n_writes: int = 0) -> None:
        m = self.metrics
        block = max(self.page_bytes, 1)
        t_r = self.ssd.service_time(n_reads, block) if n_reads else 0.0
        t_w = (self.ssd.service_time(n_writes, block, write=True)
               if n_writes else 0.0)
        if t_r or t_w:
            self.metrics = dataclasses.replace(
                m, sim_time_s=m.sim_time_s + t_r + t_w,
                read_time_s=m.read_time_s + t_r,
                write_time_s=m.write_time_s + t_w)
