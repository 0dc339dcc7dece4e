"""The legacy step-by-step path (``fused_rounds=False``) of ``repro_torch``
and the helpers it and the runtime use, against ``repro.core``.

* The port's legacy path against the reference's legacy path (values and
  the whole cache, ring and ``IOMetrics`` state after every op, storage
  after the flush), with a fault model and ring drops; the reference runs
  its own ``read_jit`` / ``write_jit`` and a jitted ``flush``.  (Readahead
  and prefetch on the legacy path are held against the fused path below,
  which ``test_torch_prefetch.py`` holds against the reference.)
* The port's legacy path against its fused path, bit for bit after every
  op: the cases of ``tests/test_fused_rounds.py`` (a mixed op sequence
  with and without faults, an out-of-order token window, stride
  readahead, ring back-pressure).
* ``service_all`` (the completion stream in its arbitration order, the
  fault counts and the retired rings), ``allocate``, ``count_hits``,
  ``pin_keys``, ``write_line``, ``metrics_accumulate`` and ``metrics_sum``
  directly, on the same inputs as the reference's.

Integers are compared bit for bit; simulated-time fields within
``TIME_RTOL`` (see ``_torch_port.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BamArray as JArray
from repro.core import cache as JC
from repro.core import metrics as JM
from repro.core import queues as JQ
from repro.core.ssd import (ArrayOfSSDs as JSSDs, FaultModel as JFault,
                            INTEL_OPTANE_P5800X as JP58)
from repro_torch.core import cache as TC
from repro_torch.core import metrics as TM
from repro_torch.core import queues as TQ
from repro_torch.core.bam_array import BamArray as TArray, IORequest
from repro_torch.core.prefetch import PrefetchConfig as TPC
from repro_torch.core.ssd import (ArrayOfSSDs as TSSDs, FaultModel as TFault,
                                  INTEL_OPTANE_P5800X)
from repro_torch.interop import state_to_numpy

from _torch_port import (  # noqa: F401
    assert_fields_equal, assert_metrics_equal, assert_states_equal,
    fast_reference_compiles)

jax.config.update("jax_platform_name", "cpu")

CFG = dict(block_elems=16, num_sets=16, ways=4)
SIZE = 8192
FAULT = dict(transient_error_rate=0.2, retry_budget=1, seed=3,
             failed_devices=(1,))


def test_legacy_path_matches_reference_legacy_path():
    rng = np.random.default_rng(0)
    data = rng.standard_normal(SIZE).astype(np.float32)
    kw = dict(CFG, num_queues=4, queue_depth=16)
    ja, js = JArray.build(data, ssd=JSSDs(JP58, 2, fault=JFault(**FAULT)),
                          kernel_impl="ref", **kw)
    ja = dataclasses.replace(ja, fused_rounds=False, _jit_ops={},
                             _trace_counts={})
    ta, ts = TArray.build(data, ssd=TSSDs(INTEL_OPTANE_P5800X, 2,
                                          fault=TFault(**FAULT)),
                          fused_rounds=False, device="cpu", **kw)
    assert not ta.fused_rounds
    jread, jwrite = ja.read_jit(), ja.write_jit()
    jflush = ja._jit_op("flush", lambda: ja.flush)
    for step in range(3):
        for idx in (rng.integers(-8, SIZE, 64).astype(np.int32),
                    np.arange(step * 512, step * 512 + 256, 4,
                              dtype=np.int32)):
            jv, js = jread(js, jnp.asarray(idx))
            tv, ts = ta.read(ts, torch.from_numpy(idx))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
            assert_states_equal(ts, js, f"read {step}")
        w = rng.choice(np.arange(16, SIZE), 64, replace=False).astype(
            np.int32)
        v = rng.standard_normal(64).astype(np.float32)
        js = jwrite(js, jnp.asarray(w), jnp.asarray(v))
        ts = ta.write(ts, torch.from_numpy(w), torch.from_numpy(v))
        assert_states_equal(ts, js, f"write {step}")
    js = jflush(js)
    ts = ta.flush(ts)
    assert_states_equal(ts, js, "flush")
    np.testing.assert_array_equal(ta.storage.data.numpy(),
                                  np.asarray(ja.storage.data))
    m = ts.metrics
    assert float(m.dropped) > 0 and float(m.failed_commands) > 0


def _pair(seed=0, queue_depth=64, prefetch=None, fault=None):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal(SIZE).astype(np.float32)
    ssd = TSSDs(INTEL_OPTANE_P5800X, 2,
                fault=TFault(**fault) if fault else TFault())
    kw = dict(CFG, num_queues=4, queue_depth=queue_depth, ssd=ssd,
              prefetch=prefetch, device="cpu")
    fused = TArray.build(data, **kw)
    legacy = TArray.build(data, fused_rounds=False, **kw)
    return fused, legacy, rng


def _same(fused, legacy, where):
    (fa, fs), (la, ls) = fused, legacy
    a, b = state_to_numpy(fs), state_to_numpy(ls)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} {k}")
    if fa.storage is not None:
        assert torch.equal(fa.storage.data, la.storage.data), where


@pytest.mark.parametrize("fault", [None, FAULT], ids=["clean", "faults"])
def test_legacy_equals_fused_mixed_ops(fault):
    """Reads (with invalid lanes), writes, prefetches and a flush."""
    fused, legacy, rng = _pair(fault=fault)
    arrs = [list(fused), list(legacy)]
    for step in range(4):
        idx = torch.from_numpy(rng.integers(-8, SIZE, 64).astype(np.int32))
        w = torch.from_numpy(rng.integers(0, SIZE, 48).astype(np.int32))
        v = torch.from_numpy(rng.standard_normal(48).astype(np.float32))
        p = torch.from_numpy(rng.integers(0, SIZE, 32).astype(np.int32))
        outs = []
        for a in arrs:
            vals, a[1] = a[0].read(a[1], idx)
            a[1] = a[0].write(a[1], w, v)
            a[1] = a[0].prefetch(a[1], p)
            outs.append(vals)
        assert torch.equal(outs[0], outs[1])
        _same(arrs[0], arrs[1], f"step {step}")
    for a in arrs:
        a[1] = a[0].flush(a[1])
    _same(arrs[0], arrs[1], "flush")


def test_legacy_equals_fused_outstanding_tokens():
    """Three tokens in flight, redeemed out of order: cross-op coalescing,
    the deferred fetches and the drain-everything wait line up."""
    fused, legacy, rng = _pair(seed=1)
    arrs = [list(fused), list(legacy)]
    toks = [[], []]
    for _ in range(3):
        idx = torch.from_numpy(rng.integers(0, SIZE, 40).astype(np.int32))
        for a, t in zip(arrs, toks):
            a[1], tok = a[0].submit(a[1], IORequest.read(idx))
            t.append(tok)
    _same(arrs[0], arrs[1], "submits")
    for i in (1, 0, 2):
        outs = []
        for a, t in zip(arrs, toks):
            a[1], vals = a[0].wait(a[1], t[i])
            outs.append(vals)
        assert torch.equal(outs[0], outs[1])
        _same(arrs[0], arrs[1], f"wait {i}")


@pytest.mark.parametrize("case", ["readahead", "backpressure"])
def test_legacy_equals_fused_readahead_and_drops(case):
    """Stride readahead (speculative fills in the low-priority lane), and a
    queue depth of 4 that rejects most of a 128-lane wavefront."""
    if case == "readahead":
        fused, legacy, rng = _pair(seed=2, prefetch=TPC(enabled=True,
                                                        window=8))
        waves = [torch.arange(s, s + 1024, 4, dtype=torch.int32)
                 for s in (0, 1024, 2048)]
    else:
        fused, legacy, rng = _pair(seed=3, queue_depth=4)
        waves = [torch.from_numpy(rng.integers(0, SIZE, 128).astype(
            np.int32))]
    arrs = [list(fused), list(legacy)]
    for idx in waves:
        outs = []
        for a in arrs:
            vals, a[1] = a[0].read(a[1], idx)
            outs.append(vals)
        assert torch.equal(outs[0], outs[1])
        _same(arrs[0], arrs[1], case)
    m = arrs[1][1].metrics
    if case == "readahead":
        assert float(m.prefetch_issued) > 0 and float(m.prefetch_hits) > 0
    else:
        assert float(m.dropped) > 0


def _rings(pkg, n_tenants, weights, failed=()):
    if pkg == "jax":
        return JQ.make_queues(8, 8, n_devices=2, n_tenants=n_tenants,
                              tenant_weights=weights, failed_devices=failed)
    return TQ.make_queues(8, 8, n_devices=2, n_tenants=n_tenants,
                          tenant_weights=weights, failed_devices=failed,
                          device="cpu")


SERVICE_CASES = {
    # one tenant, demand only: the ring order, no sort
    "demand": (1, None, [(0, 0)], None),
    # one tenant with readahead pending: a stable priority sort
    "readahead": (1, None, [(0, 0), (0, 1), (0, 0)], None),
    # weights 3 and 1 (vfinish ties), both priority classes, faults
    "wfq": (2, (3.0, 1.0), [(0, 0), (1, 0), (1, 1), (0, 1), (0, 0)],
            dict(transient_error_rate=0.3, retry_budget=1, seed=5,
                 failed_devices=(1,))),
}


@pytest.mark.parametrize("case", sorted(SERVICE_CASES))
def test_service_all_matches_reference(case):
    """Segments enqueued by one or two tenants (some beyond the ring
    depth), then ``service_all``: every ``Completions`` field equal to the
    reference's, in order, and the retired rings equal."""
    nt, weights, segs, fault = SERVICE_CASES[case]
    failed = fault["failed_devices"] if fault else ()
    rng = np.random.default_rng(7)
    jq, tq = _rings("jax", nt, weights, failed), _rings("torch", nt,
                                                        weights, failed)
    for tenant, prio in segs:
        keys = np.where(rng.random(24) < 0.8, rng.integers(0, 200, 24),
                        -1).astype(np.int32)
        w = rng.random(24) < 0.3
        dst = rng.integers(0, 64, 24).astype(np.int32)
        jq, _ = JQ.enqueue(jq, jnp.asarray(keys), dst=jnp.asarray(dst),
                           is_write=jnp.asarray(w), prio=prio, tenant=tenant)
        tq, _ = TQ.enqueue(tq, torch.from_numpy(keys),
                           dst=torch.from_numpy(dst),
                           is_write=torch.from_numpy(w), prio=prio,
                           tenant=tenant)
    assert_fields_equal(tq, jq, "enqueued")
    jfault = JFault(**fault) if fault else None
    tfault = TFault(**fault) if fault else None
    jq, jc = JQ.service_all(jq, fault=jfault)
    tq, tc = TQ.service_all(tq, fault=tfault)
    assert_fields_equal(tc, jc, "completions")
    assert_fields_equal(tq, jq, "retired")
    assert int(tc.count) > 0
    if case == "wfq":
        assert int(tc.status.sum()) > 0
        assert tc.tenant[tc.valid].unique().numel() == 2
    tq, tc = TQ.service_all(tq)                 # empty rings: a no-op
    assert int(tc.count) == 0


def _directory(pkg, seed=0):
    """A 16-set x 4-way cache with a mixed directory: resident, dirty,
    speculative and pinned lines of tenants 0 and 1."""
    rng = np.random.default_rng(seed)
    S, W = 16, 4
    tags = np.where(rng.random((S, W)) < 0.8, rng.integers(0, 400, (S, W)),
                    -1).astype(np.int32)
    d = dict(tags=tags, owner=rng.integers(0, 2, (S, W)).astype(np.int32),
             refcount=(rng.random((S, W)) < 0.15).astype(np.int32),
             dirty=rng.random((S, W)) < 0.3,
             speculative=rng.random((S, W)) < 0.2,
             clock_hand=rng.integers(0, W, S).astype(np.int32))
    if pkg == "jax":
        c = JC.make_cache(S, W, 4)
        return JC._replace_data(c, **{k: jnp.asarray(v) for k, v in
                                      d.items()})
    c = TC.make_cache(S, W, 4, device="cpu")
    for k, v in d.items():
        getattr(c, k).copy_(torch.from_numpy(v))
    return c


ALLOC_CASES = {
    "plain": dict(),
    "protected_speculative": dict(speculative=True, protect=True),
    "tenant_window": dict(tenant=1, way_lo=1, way_hi=3),
}


@pytest.mark.parametrize("case", sorted(ALLOC_CASES))
def test_cache_helpers_match_reference(case):
    """``allocate`` (the two-step victim grant) under its options, then
    ``count_hits``, ``pin_keys`` and ``write_line`` on the result."""
    kw = dict(ALLOC_CASES[case])
    protect = kw.pop("protect", False)
    rng = np.random.default_rng(1)
    keys = rng.integers(-2, 600, 40).astype(np.int32)
    valid = keys >= 0
    prot = rng.integers(-1, 64, 10).astype(np.int32) if protect else None
    slots_ok = rng.random(40) < 0.7
    lines = rng.standard_normal((40, 4)).astype(np.float32)
    tenant = kw.get("tenant", 0)

    def ref(c, keys, valid, prot, slots_ok, lines):
        c, a = JC.allocate(c, keys, valid, protect_slots=prot, **kw)
        after = c
        c = JC.count_hits(c, jnp.int32(5))
        c = JC.pin_keys(c, keys, tenant=tenant)
        c = JC.write_line(c, a.slot, a.ok & slots_ok, lines)
        return a, after, c

    ja, jc_alloc, jc = jax.jit(ref)(
        _directory("jax"), jnp.asarray(keys), jnp.asarray(valid),
        None if prot is None else jnp.asarray(prot), jnp.asarray(slots_ok),
        jnp.asarray(lines))
    tc = _directory("torch")
    tc, ta = TC.allocate(tc, torch.from_numpy(keys), torch.from_numpy(valid),
                         protect_slots=None if prot is None
                         else torch.from_numpy(prot), **kw)
    assert_fields_equal(ta, ja, "alloc")
    assert_fields_equal(tc, jc_alloc, "cache after allocate")
    assert bool(ta.ok.any())
    tc = TC.count_hits(tc, torch.tensor(5, dtype=torch.int32))
    tc = TC.pin_keys(tc, torch.from_numpy(keys), tenant=tenant)
    tc = TC.write_line(tc, ta.slot, ta.ok & torch.from_numpy(slots_ok),
                       torch.from_numpy(lines))
    assert_fields_equal(tc, jc, "cache after count/pin/write")


def test_metrics_accumulate_and_sum():
    """``metrics_accumulate`` and ``metrics_sum`` equal the reference's and
    leave their arguments as they were."""
    rng = np.random.default_rng(2)

    def pair():
        t = TM.IOMetrics.zeros(2, "cpu")
        kw = {}
        for f in dataclasses.fields(t):
            v = getattr(t, f.name)
            x = rng.integers(0, 1000, v.shape)
            getattr(t, f.name).copy_(torch.from_numpy(x).to(v.dtype))
            kw[f.name] = jnp.asarray(x, jnp.int32 if v.dtype == torch.int32
                                     else jnp.float32)
        return t, JM.IOMetrics(**kw)

    parts = [pair() for _ in range(3)]
    before = [p[0].clone() for p in parts]
    acc = TM.metrics_accumulate(parts[0][0], parts[1][0])
    assert_metrics_equal(acc, JM.metrics_accumulate(parts[0][1],
                                                    parts[1][1]), "acc")
    total = TM.metrics_sum([p[0] for p in parts])
    assert_metrics_equal(total, JM.metrics_sum([p[1] for p in parts]), "sum")
    for (t, _), b in zip(parts, before):
        for f in dataclasses.fields(t):
            assert torch.equal(getattr(t, f.name), getattr(b, f.name))
    assert acc is not parts[0][0] and total is not parts[0][0]
