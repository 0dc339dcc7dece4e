"""The NYC-taxi queries on ``repro_torch`` against the JAX package, at 2^15
rows striped over four simulated devices, with readahead on and a cache of
eight lines a column (so the queries evict).

The tables must be equal (both are built with numpy from the seed); every
gathered value must equal the host column at its row, bit for bit; each
query's value must be within 1e-5 relative of the reference's (both sum
float32 values, in different orders); the I/O summary (bytes, amplification)
and every column's cache, ring and ``IOMetrics`` state must be the
reference's exactly (simulated-time fields within rtol 1e-6).  The scans
run on the port only: three passes (demand, readahead, readahead with four
tokens in flight) give one checksum, numpy's within 1e-5 relative.
"""
import jax
import numpy as np
import pytest

from repro.analytics import taxi as JT
from repro.core.prefetch import PrefetchConfig as JPC
from repro_torch.analytics import taxi as TT
from repro_torch.core.prefetch import PrefetchConfig as TPC

from _torch_port import (  # noqa: F401
    assert_states_equal, fast_reference_compiles)

jax.config.update("jax_platform_name", "cpu")

ROWS = 1 << 15
TABLE = dict(cache_bytes=1 << 12, n_devices=4, seed=3)


def test_queries_match_reference():
    # The reference keeps each column in its state (backend "hbm"), so the
    # six column arrays share one static configuration and one compiled
    # read: one jit cache serves them all.
    jt = JT.make_taxi_table(ROWS, backend="hbm",
                            prefetch=JPC(enabled=True, window=8), **TABLE)
    shared = {}
    for arr in jt.cols.values():
        arr._jit_ops = shared
    tt = TT.make_taxi_table(ROWS, prefetch=TPC(enabled=True, window=8),
                            device="cpu", **TABLE)
    assert set(tt.host) == set(jt.host)
    for name, col in jt.host.items():
        assert tt.host[name].dtype == col.dtype
        np.testing.assert_array_equal(tt.host[name], col, err_msg=name)
    np.testing.assert_array_equal(tt.pickup.numpy(), np.asarray(jt.pickup))
    rows = np.flatnonzero(jt.host["pickup_gid"] == TT.WILLIAMSBURG)
    assert len(rows) == int(ROWS * 5e-4)
    for q, dep in TT.QUERIES.items():
        got, gio = TT.run_query(tt, q)
        want, wio = JT.run_query(jt, q)
        np.testing.assert_allclose(got["value"], want["value"], rtol=1e-5)
        for name in dep:
            v = gio["values"][name].numpy()
            np.testing.assert_array_equal(v[rows], jt.host[name][rows])
            assert not np.delete(v, rows).any()
            assert_states_equal(tt.states[name], jt.states[name],
                                f"{q} {name}")
        for key, w in wio.items():
            assert gio[key] == w, (q, key, gio[key], w)
        base_t, bio_t = TT.run_query_baseline(tt, q)
        base_j, bio_j = JT.run_query_baseline(jt, q)
        assert base_t == base_j and bio_t == bio_j
        np.testing.assert_allclose(got["value"], base_t["value"], rtol=1e-5)
        assert gio["amplification"] < bio_t["amplification"]


def test_scans_agree_and_readahead_raises_hit_rate():
    runs = {}
    for name, pf, window in (("demand", None, 0),
                             ("readahead", TPC(True, window=8), 0),
                             ("readahead_w4", TPC(True, window=8), 4)):
        tbl = TT.make_taxi_table(ROWS, device="cpu", prefetch=pf, **TABLE)
        runs[name] = TT.scan_column(tbl, "trip_dist", wavefront=1024,
                                    window=window)
    want = tbl.host["trip_dist"].astype(np.float64).sum()
    sums = {name: total for name, (total, _) in runs.items()}
    assert len(set(sums.values())) == 1, sums
    np.testing.assert_allclose(sums["demand"], want, rtol=1e-5)
    demand = runs["demand"][1]
    assert demand["hit_rate"] == 0.0 and demand["prefetch_issued"] == 0
    for name in ("readahead", "readahead_w4"):
        io = runs[name][1]
        assert io["hit_rate"] > demand["hit_rate"], (name, io["hit_rate"])
        assert io["prefetch_accuracy"] >= 0.99, name
        assert io["amplification"] <= demand["amplification"], name
    # the same column as a shared-runtime tenant beside a neighbour: one
    # full pass gives the same checksum
    from repro_torch.core.bam_array import BamRuntime, TenantSpec

    rt, rst = BamRuntime.build(
        [TenantSpec("trip_dist", tbl.host["trip_dist"], 128),
         TenantSpec("other", np.zeros(1024, np.float32), 128)],
        num_sets=8, ways=4, device="cpu")
    total, rst, nxt = TT.scan_column_runtime(rt, rst, "trip_dist",
                                             n_rows=ROWS, wavefront=1024)
    assert total == sums["demand"] and nxt == 0
    rt.assert_metrics_consistent(rst)
