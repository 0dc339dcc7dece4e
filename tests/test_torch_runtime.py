"""``repro_torch``'s multi-tenant ``BamRuntime`` and ``BamKVStore`` against
``repro.core``'s.

The cases of ``tests/test_runtime.py`` and the runtime case of
``tests/test_faults.py`` (the ``BamKVStore`` cases are in
``test_torch_kv_store.py``).  Where a case runs on both packages
(:class:`RtBoth`), the values and the whole runtime state (shared cache and
rings, global and per-tenant ``IOMetrics``, tenant stores) are compared
after every op, integers bit for bit and simulated-time fields within
``TIME_RTOL``, and after a deferred drain the completion stream field by
field, in order.  The reference runs through its own ``read_jit`` /
``write_jit`` / ``submit_jit`` and jitted ``wait_ex`` / ``prefetch`` /
``flush`` / ``drain`` on the ``hbm`` backend; writes avoid block 0 of
every tenant (see ROADMAP §3: the reference's ``HBMStorage.write_blocks``
may lose a real write to block 0).  The other cases are the reference tests' own checks,
on the port.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import BamRuntime as JRT, TenantSpec as JTS
from repro.core.ssd import (ArrayOfSSDs as JSSDs, FaultModel as JFault,
                            INTEL_OPTANE_P5800X as JP58)
from repro_torch.core.bam_array import (BamRuntime as TRT, IORequest,
                                        TenantSpec as TTS)
from repro_torch.core.queues import in_flight_per_tenant
from repro_torch.core.ssd import (ArrayOfSSDs as TSSDs, FaultModel as TFault,
                                  INTEL_OPTANE_P5800X)

from repro_torch.interop import (runtime_state_from_numpy,
                                 runtime_state_to_numpy)

from _torch_port import (  # noqa: F401
    RtBoth, fast_reference_compiles, jax_runtime_to_numpy)

jax.config.update("jax_platform_name", "cpu")

BE = 8          # shared cache line geometry (elements)
N = 64          # lanes per wavefront: one shape per op, one compile each
SHARED = {}     # the reference's compiled ops, by runtime configuration


def _both(specs, *, key, fault=None, **kw):
    """The same runtime on both packages (hbm backend); ``specs`` are
    ``(name, data, TenantSpec keywords)``."""
    jf = JFault(**fault) if fault else JFault()
    tf = TFault(**fault) if fault else TFault()
    jrt, jrst = JRT.build([JTS(n, d, BE, **o) for n, d, o in specs],
                          ssd=JSSDs(JP58, 2, fault=jf), backend="hbm",
                          kernel_impl="ref", **kw)
    trt, trst = TRT.build([TTS(n, d, BE, **o) for n, d, o in specs],
                          ssd=TSSDs(INTEL_OPTANE_P5800X, 2, fault=tf),
                          backend="hbm", device="cpu", **kw)
    return RtBoth(jrt, jrst, trt, trst, shared=SHARED.setdefault(key, {}))


FAULTED = dict(num_sets=16, ways=4, num_queues=4, queue_depth=64,
               isolation="shared",
               fault=dict(transient_error_rate=0.35, retry_budget=1,
                          seed=13))


def _faulted(drain, da, db):
    """Two float tenants weighted 3 and 1 over one shared, fault-injected
    runtime; the tests that use it share the reference's compiled ops of
    each drain mode."""
    return _both([("a", da, dict(weight=3.0)), ("b", db, dict(weight=1.0))],
                 key=f"faulted:{drain}", drain=drain, **FAULTED)


def _store(b, name):
    return b.trst.storages[b.trt.tenant_ids[name]].data.numpy().reshape(-1)


def test_tenants_share_one_cache_and_ring_pool():
    """Two tenants, a float32 "hot" array and an int32 "edges" array, over
    one 4-set x 4-way cache, partitioned 2 + 2 ways.  Both read blocks 0..
    of their own data (the shared cache namespaces equal block keys by
    owner); the int tenant round-trips through the float32 cache exactly;
    it streams 16x its way quota and leaves the hot tenant's lines
    resident; every read's ring traffic retires; writes land in each
    tenant's own store (the int tenant's through the float cache), a
    one-tenant flush leaves the other's dirty lines, a prefetch warms the
    hot tenant's ways, and the tenant metrics sum to the global ones after
    every op."""
    rng = np.random.default_rng(0)
    hot = rng.standard_normal(512).astype(np.float32)
    edges = rng.permutation(1 << 10).astype(np.int32)
    b = _both([("hot", hot, {}), ("edges", edges, {})], key="partitioned",
              num_sets=4, ways=4, num_queues=4, queue_depth=16)
    shadow = {"hot": hot.copy(), "edges": edges.copy()}
    hot_idx = np.arange(N, dtype=np.int32) % 32         # 4 lines
    np.testing.assert_array_equal(b.read("hot", hot_idx), hot[hot_idx])
    np.testing.assert_array_equal(b.read("edges", hot_idx), edges[hot_idx])
    h0 = float(b.trst.tenant_metrics[0].hits)
    for start in range(0, edges.size, N):
        idx = np.arange(start, start + N, dtype=np.int32)
        assert b.read("edges", idx).dtype == np.int32
    b.read("hot", hot_idx)
    assert float(b.trst.tenant_metrics[0].hits) - h0 == 4
    qs = b.trst.queues
    assert torch.equal(qs.tenant_enqueued, qs.tenant_completed)
    assert int(in_flight_per_tenant(qs).sum()) == 0

    ew = 512 + np.arange(N, dtype=np.int32)     # 8 lines, dirty
    evals = rng.integers(0, 1 << 20, N).astype(np.int32)
    b.write("edges", ew, evals)
    shadow["edges"][ew] = evals
    w = BE + rng.choice(448, N, replace=False).astype(np.int32)
    wv = rng.standard_normal(N).astype(np.float32)
    b.write("hot", w, wv)
    shadow["hot"][w] = wv
    b.flush("hot")
    dirty = b.trst.cache.dirty
    assert bool(dirty.any())
    assert bool((b.trst.cache.owner[dirty] == 1).all())
    b.prefetch("hot", np.arange(256, 256 + N, dtype=np.int32))
    b.flush()
    assert not bool(b.trst.cache.dirty.any())
    for name in ("hot", "edges"):
        np.testing.assert_array_equal(_store(b, name)[:shadow[name].size],
                                      shadow[name])


def test_shared_isolation_evicts_across_tenants():
    """``isolation="shared"`` on the port (the reference's cross-tenant
    eviction is held on both packages by the deferred-drain test below):
    a streaming tenant evicts the hot tenant's clean lines, a dirty line
    of another tenant is never victimised, and flushing one tenant leaves
    the other's dirty lines."""
    hot = np.arange(512, dtype=np.float32)
    rt, rst = TRT.build([TTS("hot", hot, BE),
                         TTS("edges", np.arange(1 << 10, dtype=np.int32),
                             BE)], num_sets=4, ways=4, isolation="shared",
                        device="cpu")
    hot_idx = torch.arange(32, dtype=torch.int32)
    rst = rt.write(rst, "hot", hot_idx[8:16], -torch.arange(8.0))
    _, rst = rt.read(rst, "hot", hot_idx)
    h0 = float(rst.tenant_metrics[0].hits)
    for start in range(0, 1 << 10, N):
        _, rst = rt.read(rst, "edges", torch.arange(start, start + N,
                                                    dtype=torch.int32))
    v, rst = rt.read(rst, "hot", hot_idx)
    assert float(rst.tenant_metrics[0].hits) - h0 < 4
    want = hot[:32].copy()
    want[8:16] = -np.arange(8.0)
    np.testing.assert_array_equal(v.numpy(), want)
    dirty = rst.cache.dirty
    assert int(dirty.sum()) == 1 and bool((rst.cache.owner[dirty] == 0).all())
    rst = rt.flush(rst, "edges")
    assert int(rst.cache.dirty.sum()) == 1
    rst = rt.flush(rst, "hot")
    assert not bool(rst.cache.dirty.any())
    np.testing.assert_array_equal(
        rt.array("hot").storage.data.numpy().reshape(-1)[:32], want)
    rt.assert_metrics_consistent(rst)


def test_deferred_drain_weighted_fair_stream_with_faults():
    """drain="deferred" with weights 3 and 1 and a fault model: both
    tenants' commands coexist in the rings, each round's drain retires
    them in the reference's weighted-fair order (``vfinish`` ties between
    the weight-3 tenant's third command and the weight-1 tenant's first
    are broken by ring position), per-command status included, and every
    ring drains empty."""
    rng = np.random.default_rng(1)
    da = rng.standard_normal(1024).astype(np.float32)
    db = rng.standard_normal(1024).astype(np.float32)
    b = _faulted("deferred", da, db)
    n_err = n_status = 0
    for _ in range(3):
        toks = [(name, b.submit(name, rng.integers(0, 1024, N).astype(
            np.int32))) for name in ("a", "b")]
        assert (in_flight_per_tenant(b.trst.queues) > 0).all()
        for name, tok in reversed(toks):
            n_err += int(b.wait(name, tok)[1].sum())
        comps = b.drain()
        ten = comps.tenant[comps.valid]
        assert ten.numel() == int(comps.count) and int(comps.count) > 0
        # weights 3:1 while both tenants have demand commands left
        head = ten[:16].tolist()
        assert head[:4] == [0, 0, 0, 1], head
        n_status += int(comps.status[comps.valid].sum())
        qs = b.trst.queues
        assert torch.equal(qs.tenant_enqueued, qs.tenant_completed)
    assert n_err > 0 and n_status > 0
    assert float(b.trst.metrics.degraded_reads) == n_err
    # resume the port from the reference's state through interop, and go
    # on in lockstep for one more round; snapshots are copies
    snap = runtime_state_to_numpy(b.trst)
    b.trst = runtime_state_from_numpy(
        jax_runtime_to_numpy(b.jrst), "cpu", stripe_blocks=1,
        tenant_weights=(3, 1))
    b.check("resumed")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            runtime_state_from_numpy(snap)
    toks = [(name, b.submit(name, rng.integers(0, 1024, N).astype(
        np.int32))) for name in ("a", "b")]
    for name, tok in toks:
        b.wait(name, tok)
    b.drain()
    assert not np.array_equal(snap["metrics.requests"],
                              runtime_state_to_numpy(b.trst)[
                                  "metrics.requests"])


@pytest.mark.parametrize("drain", ["per_op", "deferred"])
def test_runtime_tenant_error_counters_sum_exactly(drain):
    """``tests/test_faults.py``'s runtime case on both packages, values,
    error masks and the whole state compared after every op: per-tenant
    fault counters sum exactly to the global ones, each tenant's
    ``degraded_reads`` equals its errored lanes, errored lanes read 0 and
    the others their data, and no pin or in-flight bit is left."""
    rng = np.random.default_rng(31)
    base = {"a": rng.standard_normal(1024).astype(np.float32),
            "b": rng.standard_normal(1024).astype(np.float32)}
    b = _faulted(drain, base["a"], base["b"])
    seen = {"a": 0, "b": 0}
    for _ in range(3):
        toks = []
        for name in ("a", "b"):
            idx = rng.integers(0, 1024, N).astype(np.int32)
            toks.append((name, idx, b.submit(name, idx)))
        while toks:
            name, idx, tok = toks.pop()
            vals, err = b.wait(name, tok)
            seen[name] += int(err.sum())
            np.testing.assert_array_equal(vals[~err], base[name][idx][~err])
            np.testing.assert_array_equal(vals[err], 0.0)
        if drain == "deferred":
            b.drain()
    rt, rst = b.trt, b.trst
    rt.assert_metrics_consistent(rst)
    for name in ("a", "b"):
        assert int(rst.tenant_metrics[rt.tenant_ids[name]].degraded_reads) \
            == seen[name]
    assert int(rst.metrics.degraded_reads) == seen["a"] + seen["b"] > 0
    assert not bool(rst.cache.refcount.any())
    assert not bool(rst.cache.inflight.any())


def test_scan_column_runtime_non_divisible_tail():
    """A 500-row column in 128-row waves: the past-the-end lanes of the
    last wave read 0 (no head row counted twice) and the stream wraps to
    row 0; sum and state against the reference's."""
    from repro.analytics.taxi import scan_column_runtime as jscan
    from repro_torch.analytics.taxi import scan_column_runtime as tscan

    col = np.arange(500, dtype=np.float32)
    b = _both([("scan", col, {})], key="scan", num_sets=4, ways=2)
    jt, b.jrst, jn = jscan(b.jrt, b.jrst, "scan", n_rows=500, wavefront=128)
    tt, b.trst, tn = tscan(b.trt, b.trst, "scan", n_rows=500, wavefront=128)
    b.check("scan")
    assert tt == jt == float(col.sum()) and tn == jn == 0
    tt, b.trst, tn = tscan(b.trt, b.trst, "scan", n_rows=500, wavefront=128,
                           start=384, waves=2)
    assert tt == float(col[384:].sum() + col[:128].sum()) and tn == 128


def test_scan_tenant_cannot_evict_partitioned_hot_tenant():
    """``test_scan_column_runtime_sums_and_isolates`` on the port: a full
    scan pass through one tenant leaves the partitioned hot tenant's four
    lines resident."""
    from repro_torch.analytics.taxi import scan_column_runtime

    col = np.arange(512, dtype=np.float32)
    rt, rst = TRT.build([TTS("scan", col, BE),
                         TTS("hot", 7 * np.ones(64, np.float32), BE)],
                        num_sets=4, ways=4, device="cpu")
    hot = torch.arange(32, dtype=torch.int32)
    _, rst = rt.read(rst, "hot", hot)
    total, rst, nxt = scan_column_runtime(rt, rst, "scan", n_rows=512,
                                          wavefront=128)
    assert total == float(col.sum()) and nxt == 0
    before = float(rst.tenant_metrics[1].hits)
    v, rst = rt.read(rst, "hot", hot)
    assert torch.equal(v, torch.full((32,), 7.0))
    assert float(rst.tenant_metrics[1].hits) - before == 4.0
    rt.assert_metrics_consistent(rst)


def test_bfs_on_runtime_tenant_matches_oracle():
    """A BFS through ``BamGraph.from_runtime`` while another tenant shares
    the cache: depths equal the host oracle's, the neighbour still reads
    its own data, and the metrics stay consistent."""
    from repro_torch.graph.analytics import (BamGraph, bfs, bfs_oracle,
                                             random_graph)

    indptr, dst = random_graph(128, 4.0, seed=3)
    rt, rst = TRT.build([TTS("bfs", dst.astype(np.int32), BE),
                         TTS("noise", np.arange(256, dtype=np.float32), BE)],
                        num_sets=8, ways=4, device="cpu")
    noise = torch.arange(64, dtype=torch.int32)
    _, rst = rt.read(rst, "noise", noise)
    g = BamGraph.from_runtime(rt, rst, "bfs", indptr)
    depth, g_state = bfs(g, source=0)
    rst = rt.absorb(rst, "bfs", g_state)
    np.testing.assert_array_equal(depth, bfs_oracle(indptr, dst, 0))
    v, rst = rt.read(rst, "noise", noise)
    np.testing.assert_array_equal(v.numpy(), np.arange(64))
    rt.assert_metrics_consistent(rst)
    with pytest.raises(ValueError, match="edges"):
        BamGraph.from_runtime(rt, rst, "bfs", indptr[:-1])


def test_deferred_and_per_op_modes_agree_on_values():
    """The reference test's sequence (read one tenant, write the other,
    flush, drain, read the written tenant) under both drain modes, on both
    packages with the whole state compared after every op; both modes read
    the same values and error masks."""
    rng = np.random.default_rng(5)
    da = rng.standard_normal(1024).astype(np.float32)
    db = rng.standard_normal(1024).astype(np.float32)
    idx = rng.integers(0, 1024, N).astype(np.int32)
    # block 0 of the tenant is not written (ROADMAP §3)
    w = BE + rng.choice(1024 - BE, N, replace=False).astype(np.int32)
    wv = rng.standard_normal(N).astype(np.float32)
    outs = {}
    for mode in ("per_op", "deferred"):
        b = _faulted(mode, da, db)
        v0, e0 = b.wait("a", b.submit("a", idx))
        b.write("b", w, wv)
        b.flush()
        b.drain()
        v1, e1 = b.wait("b", b.submit("b", idx))
        outs[mode] = (v0, e0, v1, e1)
        if mode == "deferred":
            assert int(b.drain().count) > 0
        qs = b.trst.queues
        assert torch.equal(qs.tenant_enqueued, qs.tenant_completed)
    for x, y in zip(outs["per_op"], outs["deferred"]):
        np.testing.assert_array_equal(x, y)


def test_build_validation_and_way_quotas():
    """Every configuration the reference refuses is refused, the way
    windows are the reference's, and integer tenants beyond the cache
    dtype's exact range are refused (a wider ``cache_dtype`` is taken)."""
    z = np.zeros(8, np.float32)
    bad = [
        dict(specs=[]),
        dict(specs=[("a", z, {}), ("b", z, {})], isolation="exclusive"),
        dict(specs=[("a", z, {})], drain="lazy"),
        dict(specs=[("a", z, dict(ways=3)), ("b", z, dict(ways=3))]),
        dict(specs=[("a", z, dict(ways=4)), ("b", z, {})]),
        dict(specs=[("a", z, {}), ("a", z, {})]),
        dict(specs=[("a", z, {})], backend="disk"),
        dict(specs=[("e", np.asarray([0, 1 << 25], np.int32), {})]),
    ]
    for kw in bad:
        specs = kw.pop("specs")
        kw = dict(num_sets=4, ways=4, **kw)
        with pytest.raises(ValueError):
            JRT.build([JTS(n, d, BE, **o) for n, d, o in specs], **kw)
        with pytest.raises(ValueError):
            TRT.build([TTS(n, d, BE, **o) for n, d, o in specs],
                      device="cpu", **kw)
    with pytest.raises(ValueError, match="geometry"):
        TRT.build([TTS("a", z, 4), TTS("b", z, 8)], num_sets=4,
                  device="cpu")
    with pytest.raises(ValueError, match="exact-integer range"):
        TRT.build([TTS("e", np.asarray([0, 1 << 25], np.int32), BE)],
                  num_sets=4, ways=2, device="cpu")
    rt, rst = TRT.build([TTS("e", np.asarray([0, 1 << 25], np.int32), BE)],
                        num_sets=4, ways=2, cache_dtype=torch.float64,
                        device="cpu")
    v, rst = rt.read(rst, "e", torch.tensor([1], dtype=torch.int32))
    assert int(v[0]) == 1 << 25 and v.dtype == torch.int32
    specs = [("a", z, dict(ways=3)), ("b", z, {}), ("c", z, {})]
    jrt, _ = JRT.build([JTS(n, d, BE, **o) for n, d, o in specs],
                       num_sets=4, ways=8)
    trt, _ = TRT.build([TTS(n, d, BE, **o) for n, d, o in specs],
                       num_sets=4, ways=8, device="cpu")
    for n in ("a", "b", "c"):
        tc, jc = trt.array(n).tenant_ctx, jrt.array(n).tenant_ctx
        assert (tc.tenant, tc.way_lo, tc.way_hi) \
            == (jc.tenant, jc.way_lo, jc.way_hi)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TRT.build([TTS("a", z, BE)], num_sets=4)


@pytest.mark.cuda
def test_runtime_on_card_matches_cpu():
    """On the card: the deferred, weighted, fault-injected two-tenant
    rounds bit-identical to the CPU run after every op and drain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    from repro_torch.interop import runtime_state_to_numpy

    rng = np.random.default_rng(2)
    data = {n: rng.standard_normal(4096).astype(np.float32) for n in "ab"}
    ops = [(n, rng.integers(-3, 4100, 256).astype(np.int32))
           for _ in range(6) for n in "ab"]

    def run(device):
        rt, rst = TRT.build(
            [TTS("a", data["a"], BE, weight=3.0, ways=2),
             TTS("b", data["b"], BE, weight=1.0)],
            num_sets=64, ways=4, num_queues=4, queue_depth=256,
            ssd=TSSDs(INTEL_OPTANE_P5800X, 2, fault=TFault(
                transient_error_rate=0.1, seed=1)),
            drain="deferred", device=device)
        out = []
        for i, (n, idx) in enumerate(ops):
            rst, tok = rt.submit(rst, n, IORequest.read(
                torch.from_numpy(idx).to(device)))
            rst, v, e = rt.wait_ex(rst, n, tok)
            out.append(([v, e], runtime_state_to_numpy(rst)))
            if i % 2:
                rst, c = rt.drain(rst)
                out.append(([getattr(c, f) for f in
                             ("keys", "tenant", "valid", "status")],
                            runtime_state_to_numpy(rst)))
        return out

    for (ga, gs), (ca, cs) in zip(run("cuda"), run("cpu")):
        for x, y in zip(ga, ca):
            assert torch.equal(x.cpu(), y)
        for k in cs:
            np.testing.assert_array_equal(gs[k], cs[k], err_msg=k)
