"""Data analytics on BaM (paper §II-B, §IV-C): the NYC-taxi query suite.

Port of ``repro.analytics.taxi``.  A synthetic stand-in for the 1.7B-row
taxi table: the ``pickup_gid`` filter column lives on the device and is
scanned in full; the six dependent float32 columns live in the BaM storage
tier, one :class:`BamArray` each, and a query gathers only the cache lines
that hold its matching rows (about 0.05 % of them):

  Q1  avg(trip_dist)                       | +surcharge (Q3) +hail (Q4)
  Q2  avg(total_amt / trip_dist)           | +tolls (Q5)     +tax (Q6)

The table is built with numpy from the seed exactly as the reference builds
it, so one seed gives the same table in both packages.  The CPU-centric
baseline (RAPIDS in the paper) ships every dependent column in full;
``IOMetrics.amplification`` gives the ratio of Fig. 2 and Fig. 10.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.bam_array import (BamArray, BamState, IORequest,
                                        PrefetchConfig)
from repro_torch.core.ssd import ArrayOfSSDs, INTEL_OPTANE_P5800X
from repro_torch.utils import resolve_device

COLUMNS = ["pickup_gid", "trip_dist", "total_amt", "surcharge",
           "hail_fee", "tolls", "tax"]

# query -> dependent columns aggregated over the filtered rows
QUERIES: Dict[str, List[str]] = {
    "Q1": ["trip_dist"],
    "Q2": ["trip_dist", "total_amt"],
    "Q3": ["trip_dist", "total_amt", "surcharge"],
    "Q4": ["trip_dist", "total_amt", "surcharge", "hail_fee"],
    "Q5": ["trip_dist", "total_amt", "surcharge", "hail_fee", "tolls"],
    "Q6": ["trip_dist", "total_amt", "surcharge", "hail_fee", "tolls",
           "tax"],
}

WILLIAMSBURG = 17                     # the filter value


@dataclasses.dataclass
class TaxiTable:
    n_rows: int
    pickup: torch.Tensor               # filter column, on the device
    cols: Dict[str, BamArray]
    states: Dict[str, BamState]
    host: Dict[str, np.ndarray]        # oracle copies


def make_taxi_table(n_rows: int = 1 << 18, *, selectivity: float = 5e-4,
                    block_bytes: int = 512, cache_bytes: int = 1 << 18,
                    seed: int = 0, backend: str = "sim",
                    n_devices: int = 1,
                    prefetch: Optional[PrefetchConfig] = None,
                    device=None) -> TaxiTable:
    """The table on ``device`` (default CUDA); ``n_devices`` stripes every
    column over that many SSD channels, ``cache_bytes`` is each column's
    cache."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pickup = rng.integers(0, 256, n_rows).astype(np.int32)
    # plant the target selectivity for gid == WILLIAMSBURG
    pickup[pickup == WILLIAMSBURG] = 255
    hits = rng.choice(n_rows, max(int(n_rows * selectivity), 1),
                      replace=False)
    pickup[hits] = WILLIAMSBURG
    host = {"pickup_gid": pickup}
    cols, states = {}, {}
    block_elems = block_bytes // 4
    for name in COLUMNS[1:]:
        data = rng.gamma(2.0, 3.0, n_rows).astype(np.float32)
        host[name] = data
        cols[name], states[name] = BamArray.build(
            data.reshape(1, -1), block_elems=block_elems,
            num_sets=max(cache_bytes // block_bytes // 4, 1), ways=4,
            num_queues=16, queue_depth=1024,
            ssd=ArrayOfSSDs(INTEL_OPTANE_P5800X, n_devices), backend=backend,
            prefetch=prefetch, device=dev)
    return TaxiTable(n_rows=n_rows, pickup=torch.from_numpy(pickup).to(dev),
                     cols=cols, states=states, host=host)


def run_query(tbl: TaxiTable, query: str) -> Tuple[dict, dict]:
    """BaM execution: full scan of the filter column + on-demand gathers of
    the dependent columns.  Returns ``(result, io_summary)``; the gathered
    values of each column are in ``io_summary["values"]``."""
    dep = QUERIES[query]
    match = tbl.pickup == WILLIAMSBURG                   # (N,)
    rows = torch.where(match, torch.arange(tbl.n_rows, dtype=torch.int32,
                                           device=match.device), -1)
    vals = {}
    io = {"bytes_from_storage": 0.0, "bytes_requested": 0.0,
          "amplification": 0.0, "hit_rate": 0.0}
    for name in dep:
        v, st = tbl.cols[name].read(tbl.states[name], rows, match)
        tbl.states[name] = st
        vals[name] = v
        s = st.metrics.summary()
        io["bytes_from_storage"] += s["bytes_from_storage"]
        io["bytes_requested"] += s["bytes_requested"]
    n = torch.clamp(match.sum(), min=1).to(torch.float32)
    if query == "Q1":
        res = float((vals["trip_dist"] * match).sum() / n)
    else:
        dist = torch.where(match & (vals["trip_dist"] > 0),
                           vals["trip_dist"], 1.0)
        total = vals["total_amt"]
        for extra in dep[2:]:
            total = total + vals[extra]
        res = float(((total / dist) * match).sum() / n)
    # the filter column itself is one full sequential scan
    scan_bytes = tbl.n_rows * 4
    io["scan_bytes"] = scan_bytes
    moved = io["bytes_from_storage"] + scan_bytes
    useful = io["bytes_requested"] + scan_bytes
    io["amplification"] = moved / max(useful, 1.0)
    io["bytes_moved_total"] = moved
    io["values"] = vals
    return {"query": query, "value": res}, io


def scan_column(tbl: TaxiTable, name: str, *, wavefront: int = 1024,
                window: int = 0) -> Tuple[float, dict]:
    """Full sequential scan of one BaM-resident column, one wavefront at a
    time: the readahead and token-window showcase.  ``window >= 1`` keeps
    that many wavefronts in flight through ``submit``/``wait`` (the oldest
    waited once ``window`` are pending); ``window=0`` reads synchronously.
    Returns ``(column_sum, io_summary)``, the summary being the column's
    cumulative ``IOMetrics``."""
    arr, st = tbl.cols[name], tbl.states[name]
    dev = tbl.pickup.device
    total = 0.0

    def wave(start):
        return torch.arange(start, start + wavefront, dtype=torch.int32,
                            device=dev)

    if window > 0:
        pending: collections.deque = collections.deque()
        for start in range(0, tbl.n_rows, wavefront):
            st, tok = arr.submit(st, IORequest.read(wave(start)))
            pending.append(tok)
            if len(pending) >= window:
                st, v = arr.wait(st, pending.popleft())
                total += float(v.sum())
        while pending:
            st, v = arr.wait(st, pending.popleft())
            total += float(v.sum())
    else:
        for start in range(0, tbl.n_rows, wavefront):
            v, st = arr.read(st, wave(start))
            total += float(v.sum())
    tbl.states[name] = st
    return total, st.metrics.summary()


def scan_column_runtime(rt, rst, name: str, *, n_rows: int,
                        wavefront: int = 1024, start: int = 0,
                        waves: Optional[int] = None):
    """Streaming scan of a column registered as a shared-runtime tenant
    (``BamRuntime``): ``waves`` wavefronts from row ``start`` (``None``: one
    full pass), through ``rt.read``.  Past-the-end lanes read 0 within a
    wave; the stream wraps to row 0 between waves.  Returns
    ``(partial_sum, rst, next_start)``, so a driver can advance one
    wavefront a round."""
    if waves is None:
        waves = -(-n_rows // wavefront)
    dev = rt.array(name).device
    total = 0.0
    for _ in range(waves):
        idx = start + torch.arange(wavefront, dtype=torch.int32, device=dev)
        v, rst = rt.read(rst, name, idx)
        total += float(v.sum())
        start = start + wavefront
        if start >= n_rows:
            start = 0
    return total, rst, start


def run_query_baseline(tbl: TaxiTable, query: str) -> Tuple[dict, dict]:
    """CPU-centric baseline: ships every dependent column in full (the
    RAPIDS behaviour the paper measures in Fig. 2), in numpy."""
    dep = QUERIES[query]
    match = tbl.host["pickup_gid"] == WILLIAMSBURG
    if query == "Q1":
        res = float(tbl.host["trip_dist"][match].mean())
    else:
        dist = np.where(tbl.host["trip_dist"][match] > 0,
                        tbl.host["trip_dist"][match], 1.0)
        total = tbl.host["total_amt"][match].copy()
        for extra in dep[2:]:
            total += tbl.host[extra][match]
        res = float((total / dist).mean())
    scan_bytes = tbl.n_rows * 4
    moved = scan_bytes + len(dep) * tbl.n_rows * 4       # full columns
    useful = scan_bytes + int(match.sum()) * 4 * len(dep)
    io = {"bytes_moved_total": float(moved),
          "amplification": moved / max(useful, 1),
          "scan_bytes": scan_bytes}
    return {"query": query, "value": res}, io


def oracle_value(tbl: TaxiTable, query: str) -> float:
    return run_query_baseline(tbl, query)[0]["value"]
