"""Graph analytics on BaM (paper §IV-B): BFS and connected components over
a BamArray-backed CSR edge list.

Port of ``repro.graph.analytics``.  The topology metadata (``indptr``, the
per-edge source id) lives on the device; the edge target array lives in the
BaM storage tier and is read on demand, one wavefront of all ``E`` edge
lanes per iteration (inactive lanes are -1 and never fetched).

The reference's ``.at[].min`` scatters become ``scatter_reduce_(amin)``,
which is deterministic whatever the order of duplicate indices.  ``bfs``
and ``cc`` start from a copy of ``g.state``, so, as in the reference, the
graph's own state is left as it was.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.bam_array import BamArray, BamState, IORequest
from repro_torch.core.ssd import ArrayOfSSDs, INTEL_OPTANE_P5800X
from repro_torch.utils import resolve_device

INF = 2 ** 30


# ------------------------------------------------------------- graph build --
def random_graph(n_nodes: int, avg_deg: float, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Random CSR graph (undirected, symmetrised): ``(indptr int64, dst
    int32)``, identical to ``repro.graph.analytics.random_graph``.

    Two things differ in how, not in what: the stable sort by source is an
    LSD radix sort of two stable 16-bit passes (numpy radix-sorts 16-bit
    keys; a stable sort of the full keys is the same permutation), and the
    per-node counts come from ``bincount`` in place of ``np.add.at``.  At
    2^23 nodes and degree 32 this is what keeps the host build short.
    """
    if n_nodes > 2 ** 32:
        raise ValueError("node ids must fit in 32 bits")
    rng = np.random.default_rng(seed)
    m = int(n_nodes * avg_deg / 2)
    src = rng.integers(0, n_nodes, m)
    dst = rng.integers(0, n_nodes, m)
    su = np.concatenate([src, dst])
    du = np.concatenate([dst, src])
    del src, dst
    order = np.argsort((su & 0xFFFF).astype(np.uint16), kind="stable")
    high = (su >> 16).astype(np.uint16)[order]
    order = order[np.argsort(high, kind="stable")]
    del high
    counts = np.bincount(su, minlength=n_nodes)
    del su
    du = du[order].astype(np.int32)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, du


@dataclasses.dataclass
class BamGraph:
    """CSR graph with the edge-target array behind BaM."""

    n_nodes: int
    n_edges: int
    indptr: torch.Tensor      # (N+1,) int32, device-resident
    edge_src: torch.Tensor    # (E,) int32 source node per edge
    edge_ids: torch.Tensor    # (E,) int32 arange, the all-edges wavefront
    edges: BamArray           # edge targets, storage-resident
    state: BamState

    @property
    def device(self) -> torch.device:
        return self.edges.device

    @staticmethod
    def build(indptr: np.ndarray, dst: np.ndarray, *,
              cacheline_bytes: int = 4096, cache_bytes: int = 1 << 20,
              ways: int = 4, ssd: Optional[ArrayOfSSDs] = None,
              n_devices: int = 1, backend: str = "sim",
              device=None) -> "BamGraph":
        """``n_devices`` stripes the edge array over that many SSD channels
        (ignored when an explicit ``ssd`` array is passed)."""
        dev = resolve_device(device)
        n_nodes = len(indptr) - 1
        n_edges = len(dst)
        if n_edges >= 2 ** 31:
            raise ValueError("edge ids are int32: E must stay below 2^31")
        block_elems = max(cacheline_bytes // 4, 1)
        num_lines = max(cache_bytes // cacheline_bytes, ways)
        arr, st = BamArray.build(
            np.asarray(dst, dtype=np.int32).reshape(1, -1),
            block_elems=block_elems, num_sets=max(num_lines // ways, 1),
            ways=ways, num_queues=16, queue_depth=1024,
            ssd=ssd or ArrayOfSSDs(INTEL_OPTANE_P5800X, n_devices),
            backend=backend, device=dev)
        counts = torch.from_numpy(np.diff(np.asarray(indptr))).to(dev)
        edge_src = torch.repeat_interleave(
            torch.arange(n_nodes, dtype=torch.int32, device=dev), counts,
            output_size=n_edges)
        return BamGraph(
            n_nodes=n_nodes, n_edges=n_edges,
            indptr=torch.as_tensor(np.asarray(indptr), dtype=torch.int32,
                                   device=dev),
            edge_src=edge_src,
            edge_ids=torch.arange(n_edges, dtype=torch.int32, device=dev),
            edges=arr, state=st)


    @staticmethod
    def from_runtime(rt, rst, name: str, indptr: np.ndarray) -> "BamGraph":
        """A CSR graph whose edge-target array is the ``BamRuntime``
        tenant ``name``: :func:`bfs` and :func:`cc` then run against the
        shared cache and rings under the tenant's way quota and weight.
        ``state`` is the tenant's view of ``rst``; fold a traversal's state
        back with ``rt.absorb(rst, name, state)``."""
        arr = rt.array(name)
        dev = arr.device
        n_nodes = len(indptr) - 1
        n_edges = arr.size
        if int(indptr[-1]) != n_edges:
            raise ValueError(
                f"indptr covers {int(indptr[-1])} edges but tenant "
                f"{name!r} holds {n_edges}")
        counts = torch.from_numpy(np.diff(np.asarray(indptr))).to(dev)
        edge_src = torch.repeat_interleave(
            torch.arange(n_nodes, dtype=torch.int32, device=dev), counts,
            output_size=n_edges)
        return BamGraph(
            n_nodes=n_nodes, n_edges=n_edges,
            indptr=torch.as_tensor(np.asarray(indptr), dtype=torch.int32,
                                   device=dev),
            edge_src=edge_src,
            edge_ids=torch.arange(n_edges, dtype=torch.int32, device=dev),
            edges=arr, state=rt.tenant_view(rst, name))


def _frontier_req(g: BamGraph, depth: torch.Tensor, it: int) -> IORequest:
    """Read request for exactly the frontier-at-``it``'s edges."""
    active = (depth == it)[g.edge_src]
    return IORequest.read(torch.where(active, g.edge_ids, -1), active)


def _visit(g: BamGraph, depth: torch.Tensor, nbrs: torch.Tensor,
           active: torch.Tensor, it: int) -> torch.Tensor:
    """Relax the frontier's edges into ``depth`` in place; returns the
    first-visit lanes."""
    nbrs = torch.where(active, nbrs.to(torch.int32), 0).to(torch.int64)
    first_visit = active & (depth[nbrs] >= INF)
    depth.scatter_reduce_(0, torch.where(first_visit, nbrs, 0),
                          torch.where(first_visit, it + 1, INF)
                          .to(torch.int32), reduce="amin")
    return first_visit


def _bfs_step_tok(g: BamGraph, depth, st, tok, it: int):
    """Redeem iteration ``it``'s token, relax its edges, and submit the
    read of iteration ``it+1``'s frontier before the caller looks."""
    st, nbrs = g.edges.wait(st, tok)
    active = (depth == it)[g.edge_src]
    more = bool(_visit(g, depth, nbrs, active, it).any())
    st, tok = g.edges.submit(st, _frontier_req(g, depth, it + 1))
    return st, tok, more


def bfs(g: BamGraph, source: int, max_iters: Optional[int] = None,
        prefetch: bool = False, async_tokens: bool = False
        ) -> Tuple[np.ndarray, BamState]:
    """Frontier BFS: ``(depth per node, -1 unreachable; BamState)``.

    With ``async_tokens=True`` iteration ``t`` submits the read of
    iteration ``t+1``'s frontier edges as soon as it has updated the depth
    array and carries the token into the next iteration, which redeems it.
    With ``prefetch=True`` each iteration instead hints the next frontier's
    edges through :meth:`BamArray.prefetch` (speculative fills in the
    readahead lane), so the next demand wavefront finds its lines resident.
    """
    if prefetch and async_tokens:
        raise ValueError("pick one of prefetch= (hints) or async_tokens=")
    max_iters = max_iters or g.n_nodes
    depth = torch.full((g.n_nodes,), INF, dtype=torch.int32, device=g.device)
    depth[source] = 0
    st = g.state.clone()

    if async_tokens:
        st, tok = g.edges.submit(st, _frontier_req(g, depth, 0))
        for it in range(max_iters):
            st, tok, more = _bfs_step_tok(g, depth, st, tok, it)
            if not more:
                break
        st, _ = g.edges.wait(st, tok)              # retire the last token
    else:
        for it in range(max_iters):
            req = _frontier_req(g, depth, it)
            nbrs, st = g.edges.read(st, req.idx, req.valid)
            more = bool(_visit(g, depth, nbrs, req.valid, it).any())
            if prefetch:                           # frontier-ahead hint
                nxt = _frontier_req(g, depth, it + 1)
                st = g.edges.prefetch(st, nxt.idx, nxt.valid)
            if not more:
                break
    depth = torch.where(depth >= INF, -1, depth)
    return depth.cpu().numpy(), st


def bfs_oracle(indptr: np.ndarray, dst: np.ndarray, source: int
               ) -> np.ndarray:
    n = len(indptr) - 1
    depth = np.full(n, -1, np.int32)
    depth[source] = 0
    frontier = [source]
    d = 0
    while frontier:
        nxt = []
        for u in frontier:
            for v in dst[indptr[u]:indptr[u + 1]]:
                if depth[v] < 0:
                    depth[v] = d + 1
                    nxt.append(int(v))
        frontier = nxt
        d += 1
    return depth


def _propagate(g: BamGraph, labels: torch.Tensor,
               nbrs: torch.Tensor) -> torch.Tensor:
    """Push the minimum label across every edge, both ways."""
    nbrs = nbrs.to(torch.int64)
    src = g.edge_src.to(torch.int64)
    new = labels.clone()
    new.scatter_reduce_(0, nbrs, labels[src], reduce="amin")
    new.scatter_reduce_(0, src, new[nbrs], reduce="amin")
    return new


def _cc_step_tok(g: BamGraph, labels, st, tok):
    """Redeem this round's token, propagate, and submit the next round's
    all-edge read before the caller checks convergence."""
    st, nbrs = g.edges.wait(st, tok)
    new = _propagate(g, labels, nbrs)
    st, tok = g.edges.submit(st, IORequest.read(g.edge_ids))
    return new, st, tok, bool((new != labels).any())


def cc(g: BamGraph, max_iters: Optional[int] = None,
       prefetch: bool = False, async_tokens: bool = False
       ) -> Tuple[np.ndarray, BamState]:
    """Connected components by min-label propagation over every edge, every
    round (the paper's bursty CC access pattern): ``(labels, BamState)``.

    With ``async_tokens=True`` each round submits the next round's
    all-edge read before the caller checks convergence.  With
    ``prefetch=True`` the whole edge array is hinted once up front (a
    warm-up through the readahead lane).
    """
    if prefetch and async_tokens:
        raise ValueError("pick one of prefetch= (hints) or async_tokens=")
    max_iters = max_iters or g.n_nodes
    labels = torch.arange(g.n_nodes, dtype=torch.int32, device=g.device)
    st = g.state.clone()
    if prefetch:
        st = g.edges.prefetch(st, g.edge_ids)

    if async_tokens:
        st, tok = g.edges.submit(st, IORequest.read(g.edge_ids))
        for _ in range(max_iters):
            labels, st, tok, more = _cc_step_tok(g, labels, st, tok)
            if not more:
                break
        st, _ = g.edges.wait(st, tok)              # retire the last token
    else:
        for _ in range(max_iters):
            nbrs, st = g.edges.read(st, g.edge_ids)
            new = _propagate(g, labels, nbrs)
            more = bool((new != labels).any())
            labels = new
            if not more:
                break
    return labels.cpu().numpy(), st


def cc_oracle(indptr: np.ndarray, dst: np.ndarray) -> np.ndarray:
    n = len(indptr) - 1
    labels = np.arange(n)

    def find(x):
        while labels[x] != x:
            labels[x] = labels[labels[x]]
            x = labels[x]
        return x

    src = np.repeat(np.arange(n), np.diff(indptr))
    for u, v in zip(src, dst):
        ru, rv = find(u), find(int(v))
        if ru != rv:
            labels[max(ru, rv)] = min(ru, rv)
    return np.array([find(i) for i in range(n)])
