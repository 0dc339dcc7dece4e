"""The port's core building blocks against the JAX package: hashing,
segment ranks, the coalescer, the cache ops and the SQ rings.  Inputs are
made with numpy from a seed and handed to both packages; every output and
the whole ``CacheState`` / ``QueueState`` after each op must be
bit-identical (no tolerance: all of it is integer or bool state, or line
data that is only copied).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import utils as jutils
from repro.core import cache as JC
from repro.core import queues as JQ
from repro.core.coalescer import coalesce as jcoalesce
from repro_torch import utils as tutils
from repro_torch.core import cache as TC
from repro_torch.core import queues as TQ
from repro_torch.core.coalescer import coalesce as tcoalesce
from repro_torch.core.ssd import device_histogram

from _torch_port import (  # noqa: F401
    assert_fields_equal, assert_states_equal, fast_reference_compiles)

jax.config.update("jax_platform_name", "cpu")


def T(a):
    return torch.from_numpy(np.array(a))


def test_mix_hash_and_segment_rank():
    rng = np.random.default_rng(0)
    keys = np.concatenate([rng.integers(-2 ** 31, 2 ** 31 - 1, 4000),
                           [0, -1, 2 ** 31 - 1, -2 ** 31]]).astype(np.int32)
    np.testing.assert_array_equal(tutils.mix_hash(T(keys)).numpy(),
                                  np.asarray(jutils.mix_hash(jnp.asarray(keys))))
    ids = rng.integers(0, 9, 500).astype(np.int32)
    valid = rng.random(500) < 0.7
    np.testing.assert_array_equal(
        tutils.segment_rank(T(ids), T(valid)).numpy(),
        np.asarray(jutils.segment_rank(jnp.asarray(ids), jnp.asarray(valid))))


@pytest.mark.parametrize("case", ["mixed", "all_invalid", "empty"])
def test_coalesce_matches_reference(case):
    rng = np.random.default_rng(1)
    n = {"mixed": 300, "all_invalid": 17, "empty": 0}[case]
    keys = rng.integers(-3, 40, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    if case == "all_invalid":
        valid[:] = False
    t = tcoalesce(T(keys), T(valid))
    j = jcoalesce(jnp.asarray(keys), jnp.asarray(valid))
    assert_fields_equal(t, j, case)


def _states(rng, S, W, L=8, dtype=np.float32):
    """One random-but-consistent directory as a JAX and a port CacheState."""
    tags = np.full((S, W), -1, np.int32)
    keys = rng.permutation(6 * S * W).astype(np.int32)
    sets = np.asarray(jutils.mix_hash(jnp.asarray(keys))) % S
    for k, s in zip(keys, sets):
        free = np.nonzero(tags[s] < 0)[0]
        if free.size and rng.random() < 0.8:
            tags[s, free[0]] = k
    f = dict(
        tags=tags,
        owner=rng.integers(0, 2, (S, W)).astype(np.int32),
        refcount=(rng.integers(0, 2, (S, W))
                  * rng.integers(1, 3, (S, W))).astype(np.int32),
        dirty=rng.random((S, W)) < 0.4,
        speculative=rng.random((S, W)) < 0.3,
        inflight=rng.random((S, W)) < 0.2,
        clock_hand=rng.integers(0, W, (S,)).astype(np.int32),
        data=(rng.standard_normal((S * W, L)) * 10).astype(dtype),
        hits=np.int32(3), misses=np.int32(5), bypasses=np.int32(1))
    j = JC.CacheState(num_sets=S, ways=W, line_elems=L,
                      **{k: jnp.asarray(v) for k, v in f.items()})
    t = TC.CacheState(num_sets=S, ways=W, line_elems=L,
                      **{k: T(v) for k, v in f.items()})
    return t, j


@pytest.mark.parametrize("kw", [dict(), dict(tenant=1, way_lo=1, way_hi=3,
                                              speculative=True)])
def test_cache_probe_allocate_and_bookkeeping(kw):
    """probe_allocate, grant_bookkeeping, probe, fill_complete, mark_dirty
    and release in the order submit/wait use them, the whole CacheState
    compared after each op."""
    rng = np.random.default_rng(len(kw) + 7 * kw.get("tenant", 0))
    S, W, m = 16, 4, 60
    t, j = _states(rng, S, W)
    keys = rng.integers(-1, 6 * S * W, m)
    keys[:15] = rng.choice(np.asarray(j.tags).reshape(-1), 15)
    keys = np.unique(keys).astype(np.int32)          # a coalesced wavefront
    valid = keys >= 0

    t, tpr, tal = TC.probe_allocate(t, T(keys), T(valid), **kw)
    j, jpr, jal = JC.probe_allocate(j, jnp.asarray(keys), jnp.asarray(valid),
                                    impl="ref", **kw)
    assert_fields_equal(tpr, jpr, "probe")
    assert_fields_equal(tal, jal, "alloc")
    assert_fields_equal(t, j, "after probe_allocate")
    assert bool(tal.ok.any()) and bool(tpr.hit.any())

    def both(fn_t, fn_j, *args):
        ta = [T(np.asarray(a)) for a in args]
        ja = [jnp.asarray(a) for a in args]
        return fn_t(t, *ta), fn_j(j, *ja)

    pin = np.where(np.asarray(jpr.hit), np.asarray(jpr.slot),
                   np.asarray(jal.slot)).astype(np.int32)
    promo = np.where(np.asarray(jpr.speculative), np.asarray(jpr.slot),
                     -1).astype(np.int32)
    t, j = both(TC.grant_bookkeeping, JC.grant_bookkeeping,
                np.int32(np.asarray(jpr.hit).sum()), promo, pin,
                np.asarray(jal.slot))
    assert_fields_equal(t, j, "after grant_bookkeeping")

    tpr2 = TC.probe(t, T(keys), T(valid), tenant=kw.get("tenant", 0))
    jpr2 = JC.probe(j, jnp.asarray(keys), jnp.asarray(valid),
                    tenant=kw.get("tenant", 0), impl="ref")
    assert_fields_equal(tpr2, jpr2, "re-probe")
    pend = np.asarray(jpr2.hit & jpr2.inflight)
    lines = (rng.standard_normal((keys.shape[0], 8)) * 5).astype(np.float32)
    t, j = both(TC.fill_complete, JC.fill_complete, np.asarray(jpr2.slot),
                pend, lines)
    assert_fields_equal(t, j, "after fill_complete")
    dslots = np.where(rng.random(keys.shape[0]) < 0.5, np.asarray(jpr2.slot),
                      -1).astype(np.int32)
    t, j = both(TC.mark_dirty, JC.mark_dirty, dslots)
    t, j = both(TC.release, JC.release, pin)
    assert_fields_equal(t, j, "after mark_dirty + release")
    # the step-by-step helpers the fused ones stand for
    t, j = both(TC.fill, JC.fill, np.asarray(jpr2.slot),
                np.asarray(jpr2.hit) & ~pend, lines)
    t, j = both(TC.clear_inflight, JC.clear_inflight, pin)
    t, j = both(TC.acquire, JC.acquire, dslots)
    t, j = both(TC.promote, JC.promote, pin)
    assert_fields_equal(t, j, "after fill, clear_inflight, acquire, promote")


def _queue_pair(nq, depth, nd):
    return (TQ.make_queues(nq, depth, n_devices=nd),
            JQ.make_queues(nq, depth, n_devices=nd))


def test_enqueue_segments_and_drain_with_back_pressure():
    """Several fused submissions, the last one overflowing the rings, then
    the drain: receipts and the whole QueueState match after each op."""
    rng = np.random.default_rng(5)
    tq, jq = _queue_pair(8, 4, 2)
    # the reference under jit: one compile for the fixed segment shapes
    jenq = jax.jit(lambda q, segs: JQ.enqueue_segments(q, segs, impl="ref"))
    for r in range(3):
        n = 16
        segs_np = []
        for s in range(3):
            keys = rng.integers(-1, 500, n).astype(np.int32)
            dst = rng.integers(-1, 64, n).astype(np.int32)
            w = rng.random(n) < 0.5 if s else None
            valid = rng.random(n) < 0.9 if s == 2 else None
            segs_np.append((keys, dst, w, valid, s % 2))

        def conv(f):
            return [tuple(None if x is None else
                          (f(x) if isinstance(x, np.ndarray) else x)
                          for x in seg) for seg in segs_np]

        tq, trec = TQ.enqueue_segments(tq, conv(T))
        jq, jrec = jenq(jq, conv(jnp.asarray))
        for a, b in zip(trec, jrec):
            assert_fields_equal(a, b, f"receipt round {r}")
        assert_fields_equal(tq, jq, f"queues after round {r}")
        np.testing.assert_array_equal(TQ.in_flight(tq).numpy(),
                                      np.asarray(JQ.in_flight(jq)))
        np.testing.assert_array_equal(
            TQ.in_flight_per_device(tq).numpy(),
            np.asarray(JQ.in_flight_per_device(jq)))
        np.testing.assert_array_equal(
            TQ.in_flight_per_tenant(tq).numpy(),
            np.asarray(JQ.in_flight_per_tenant(jq)))
    assert int(tq.dropped) > 0, "the last round should overflow the rings"
    tq, tdr = TQ.drain_accounting(tq)
    jq, jdr = JQ.drain_accounting(jq, impl="ref")
    for f in ("count", "count_dev", "count_tenant", "reads_dev",
              "writes_dev"):
        np.testing.assert_array_equal(getattr(tdr, f).numpy(),
                                      np.asarray(getattr(jdr, f)), err_msg=f)
    assert_fields_equal(tq, jq, "queues after drain")


def test_device_histogram_matches_reference():
    from repro.core.ssd import device_histogram as jhist

    rng = np.random.default_rng(9)
    keys = rng.integers(-5, 1000, 700).astype(np.int32)
    mask = rng.random(700) < 0.6
    for nd, sb in ((1, 1), (4, 1), (4, 3)):
        np.testing.assert_array_equal(
            device_histogram(T(keys), nd, T(mask), sb).numpy(),
            np.asarray(jhist(jnp.asarray(keys), nd, jnp.asarray(mask), sb)))


def test_sizing_helpers_match_reference():
    """The §II-C Little's-law sizing helpers and the device cost model:
    the reference's numbers exactly (host-side Python arithmetic)."""
    from repro.core import ssd as JS
    from repro_torch.core import ssd as TS

    for name, spec in TS.SSD_PRESETS.items():
        jspec = JS.SSD_PRESETS[name]
        for bb in (512, 1024, 4096):
            for write in (False, True):
                for target in (1e6, 5.1e7):
                    assert TS.min_ssds_for_target(spec, bb, target, write) \
                        == JS.min_ssds_for_target(jspec, bb, target, write)
            assert TS.target_iops_for_link(TS.PCIE_GEN4_X16_BW, bb) \
                == JS.target_iops_for_link(JS.PCIE_GEN4_X16_BW, bb)
        assert TS.required_queue_depth(5.1e7, spec.latency_s) \
            == JS.required_queue_depth(5.1e7, jspec.latency_s)
        for n in (1, 4, 10):
            assert TS.ArrayOfSSDs(spec, n).cost_usd(1600.0) \
                == JS.ArrayOfSSDs(jspec, n).cost_usd(1600.0)


def test_software_pipeline_matches_sequential():
    """``pipelined_bam_map`` (submit step t+1, then wait step t, so two
    wavefronts are in flight) against the reference's on the same data:
    every step's output and the whole state after the map.  Then
    ``software_pipeline``'s synchronous ``read_fn`` adapter with stacked
    tuple outputs, over a read whose state records the order of its
    reads, against the reference's: outputs, carry and read state."""
    from repro.core import BamArray as JArray
    from repro.core.pipeline import (pipelined_bam_map as jmap,
                                     software_pipeline as jpipe)
    from repro_torch.core.bam_array import BamArray
    from repro_torch.core.pipeline import pipelined_bam_map, software_pipeline

    rng = np.random.default_rng(0)
    data = rng.standard_normal(3000).astype(np.float32)
    idx_np = rng.integers(0, 3000, (5, 16)).astype(np.int32)
    idx_seq = torch.from_numpy(idx_np)
    cfg = dict(block_elems=16, num_sets=8, ways=2)
    ja, js = JArray.build(data, kernel_impl="ref", **cfg)
    jdata = jnp.asarray(data)

    def compute(carry, vals, idx):
        return carry + 1, (vals.max(), idx[0])

    def ref(s, q):
        ys, s = jmap(ja, s, q, jnp.max)
        order, n, out = jpipe(lambda o, i: (jdata[i], o * 7 + i[0]),
                              compute, q, jnp.int32(0), 0)
        return ys, s, order, n, out

    jys, js, jorder, jn, (jmx, jfirst) = jax.jit(ref)(js,
                                                      jnp.asarray(idx_np))
    arr, st = BamArray.build(data, device="cpu", **cfg)
    ys, st = pipelined_bam_map(arr, st, idx_seq, lambda v: v.max())
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
    np.testing.assert_array_equal(ys.numpy(), data[idx_np].max(axis=1))
    assert_states_equal(st, js, "pipelined_bam_map")
    assert float(st.metrics.max_tokens_in_flight) == 2

    tdata = torch.from_numpy(data)
    order, n, (mx, first) = software_pipeline(
        lambda o, i: (tdata[i], o * 7 + i[0]), compute, idx_seq,
        torch.tensor(0, dtype=torch.int32), 0)
    assert int(order) == int(jorder) and n == int(jn) == 5
    np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
    np.testing.assert_array_equal(mx.numpy(), np.asarray(jmx))
    with pytest.raises(ValueError):
        software_pipeline(None, compute, idx_seq, st, 0)
