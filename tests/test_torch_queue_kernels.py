"""The port's two queue kernels, ``sq_enqueue`` (the fused multi-segment
SQ enqueue) and ``wfq_drain`` (the closed-form drain accounting).

On the CPU, ``ops`` sends CPU tensors to the plain versions, and those are
held against the JAX package's ``enqueue_segments`` / ``drain_accounting``
(its jnp oracles, ``impl="ref"``) in the variants
``tests/test_torch_core.py`` leaves out: a hard-failed device, a stripe of
2 blocks, tenant 2 of 3, an empty and an all-invalid segment, rings filled
to within a few slots of their depth (so back-pressure drops lanes), and
the drain's fault fields.  The ``cuda``-marked test holds each CUDA kernel
against its plain version on the card in the same variants.

Tolerance: none.  Every output is integer or bool state, bit-identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import queues as JQ
from repro.core.ssd import FaultModel as JFault
from repro_torch.core import queues as TQ
from repro_torch.core.ssd import FaultModel as TFault
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sq_enqueue as K_enq
from repro_torch.kernels import wfq_drain as K_drain

from _torch_port import assert_fields_equal
from _torch_port import fast_reference_compiles  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

NQ, DEPTH = 8, 16
# each variant: devices, stripe, tenants, the submitting tenant, failed
# devices, the segments' lengths (None: all-invalid), and the drain's
# fault model
VARIANTS = {
    "failed_device_1": dict(
        nd=4, stripe=1, nt=1, tenant=0, failed=(1,), segs=(24, 24, 24),
        fault=dict(transient_error_rate=0.3, retry_budget=2,
                   failed_devices=(1,), seed=3)),
    "stripe_2_tenant_2_of_3_empty_and_invalid": dict(
        nd=4, stripe=2, nt=3, tenant=2, failed=(), segs=(24, 0, None),
        fault=dict(transient_error_rate=0.3, retry_budget=1, seed=7)),
}
RING_FIELDS = ("sq_key", "sq_dst", "sq_is_write", "sq_prio", "sq_tenant",
               "sq_ticket")
PER_SEG = ("n_accepted", "n_dropped", "n_doorbells", "n_tickets",
           "dev_dropped", "dev_accepted")


def _state(v, seed):
    """Queue state as numpy: rings holding pending entries (some without a
    ticket), each ring filled to 2-6 slots of its depth."""
    rng = np.random.default_rng(seed)
    nd, nt = v["nd"], v["nt"]
    head = rng.integers(0, 40, NQ).astype(np.int32)
    tail = (head + rng.integers(DEPTH - 6, DEPTH - 1, NQ)).astype(np.int32)
    st = dict(sq_key=np.full((NQ, DEPTH), -1, np.int32),
              sq_dst=np.full((NQ, DEPTH), -1, np.int32),
              sq_is_write=np.zeros((NQ, DEPTH), bool),
              sq_prio=np.zeros((NQ, DEPTH), np.int32),
              sq_tenant=np.zeros((NQ, DEPTH), np.int32),
              sq_ticket=np.full((NQ, DEPTH), -1, np.int32),
              sq_tail=tail, sq_head=head,
              rr_ptr=rng.integers(0, NQ // nd, nd).astype(np.int32),
              dev_enqueued=rng.integers(0, 100, nd).astype(np.int32))
    for q in range(NQ):
        for s in range(head[q], tail[q]):
            st["sq_key"][q, s % DEPTH] = rng.integers(0, 400)
            st["sq_dst"][q, s % DEPTH] = rng.integers(0, 64)
            st["sq_is_write"][q, s % DEPTH] = rng.random() < 0.4
            st["sq_prio"][q, s % DEPTH] = rng.integers(0, 2)
            st["sq_tenant"][q, s % DEPTH] = rng.integers(0, nt)
            st["sq_ticket"][q, s % DEPTH] = (rng.integers(0, 500)
                                             if rng.random() < 0.9 else -1)
    return st


def _segments(v, seed):
    """The submission: ``(keys, dst, is_write, valid, prio)`` a segment, as
    numpy (keys with negatives; the last segment readahead)."""
    rng = np.random.default_rng(seed + 1)
    segs = []
    for i, n in enumerate(v["segs"]):
        m = 24 if n is None else n
        keys = rng.integers(-2, 400, m).astype(np.int32)
        valid = (rng.random(m) < 0.9) & (n is not None)
        segs.append((keys, rng.integers(-1, 64, m).astype(np.int32),
                     rng.random(m) < 0.5, valid, 1 if i == 2 else 0))
    return segs


def _port_queues(v, st):
    qs = TQ.make_queues(NQ, DEPTH, n_devices=v["nd"],
                        stripe_blocks=v["stripe"], n_tenants=v["nt"],
                        failed_devices=v["failed"], device="cpu")
    for k, a in st.items():
        getattr(qs, k).copy_(torch.from_numpy(a))
    return qs


def _ref_queues(v, st):
    qs = JQ.make_queues(NQ, DEPTH, n_devices=v["nd"],
                        stripe_blocks=v["stripe"], n_tenants=v["nt"],
                        failed_devices=v["failed"])
    return dataclasses.replace(qs, **{k: jnp.asarray(a)
                                      for k, a in st.items()})


_JIT = {}


def _ref_ops():
    """The reference's enqueue and drain, each one ``jax.jit`` made while
    the module runs (so under ``fast_reference_compiles``) and shared by
    every case."""
    if not _JIT:
        _JIT["enqueue"] = jax.jit(JQ.enqueue_segments,
                                  static_argnames=("tenant", "impl"))
        _JIT["drain"] = jax.jit(JQ.drain_accounting,
                                static_argnames=("impl", "fault"))
    return _JIT["enqueue"], _JIT["drain"]


def test_ops_send_cpu_tensors_to_the_plain_versions():
    """CPU tensors go to ``sq_enqueue_ref`` / ``wfq_drain_ref``: the same
    outputs and ring writes as calling them directly, and no kernel
    launch counted."""
    v = VARIANTS["failed_device_1"]
    st = _state(v, 0)
    keys, dst, w, valid, _ = _segments(v, 0)[0]
    lanes = [torch.from_numpy(x) for x in (keys, dst, w)]
    lanes += [torch.zeros(len(keys), dtype=torch.int32),
              torch.from_numpy(valid & (keys >= 0))]
    kw = dict(seg_bounds=((0, 10), (10, len(keys))), n_devices=v["nd"],
              stripe_blocks=v["stripe"], tenant=0, failed_devices=(1,))
    n_enq, n_drain = K_enq.launches.n, K_drain.launches.n
    outs = []
    for fn in (tops.sq_enqueue, tref.sq_enqueue_ref):
        rings = [torch.from_numpy(st[k].copy()) for k in RING_FIELDS]
        state = [torch.from_numpy(st[k].copy()) for k in
                 ("sq_tail", "sq_head", "rr_ptr", "dev_enqueued")]
        out = fn(*rings, *state, *lanes, **kw)
        outs.append((out, rings))
    (a, ra), (b, rb) = outs
    for x, y in zip(a[:6] + tuple(ra), b[:6] + tuple(rb)):
        assert torch.equal(x, y)
    for k in PER_SEG:
        assert torch.equal(a[6][k], b[6][k]), k
    fault = TFault(**v["fault"])
    rings = [torch.from_numpy(st[k]) for k in
             ("sq_key", "sq_is_write", "sq_tenant", "sq_ticket")]
    da = tops.wfq_drain(*rings, n_devices=v["nd"], n_tenants=1, fault=fault,
                        entry_status=True)
    db = tref.wfq_drain_ref(*rings, n_devices=v["nd"], n_tenants=1,
                            fault=fault, entry_status=True)
    for x, y in zip(da[:5], db[:5]):
        assert torch.equal(x, y)
    assert da[5].keys() == db[5].keys() and "status" in da[5]
    for k in da[5]:
        assert torch.equal(da[5][k], db[5][k]), k
    assert (K_enq.launches.n, K_drain.launches.n) == (n_enq, n_drain)


@pytest.mark.parametrize("fn", [K_enq.sq_enqueue_cuda,
                                K_drain.wfq_drain_cuda],
                         ids=["sq_enqueue", "wfq_drain"])
def test_cuda_wrappers_refuse_cpu_tensors(fn):
    """The CUDA wrappers raise on CPU tensors (no silent plain fallback)."""
    z = torch.zeros((NQ, DEPTH), dtype=torch.int32)
    b = torch.zeros((NQ, DEPTH), dtype=torch.bool)
    zq, zd, k = (torch.zeros(NQ, dtype=torch.int32),
                 torch.zeros(1, dtype=torch.int32),
                 torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        if fn is K_enq.sq_enqueue_cuda:
            fn(z, z, b, z, z, z, zq, zq, zd, zd, k, k, k != 0, k, k == 0,
               seg_bounds=((0, 4),), n_devices=1, stripe_blocks=1,
               tenant=0)
        else:
            fn(z, b, z, z, n_devices=1, n_tenants=1)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_plain_versions_match_reference(name):
    """``enqueue_segments`` then ``drain_accounting`` under a fault model,
    on the port's plain versions and the reference's jnp oracles: every
    receipt, the drain's counts and fault fields, and the whole
    ``QueueState`` after each, bit for bit; back-pressure drops lanes."""
    v = VARIANTS[name]
    st, segs = _state(v, 1), _segments(v, 1)
    jenq, jdrain = _ref_ops()
    tq, jq = _port_queues(v, st), _ref_queues(v, st)

    def conv(f):
        return [tuple(f(x) if isinstance(x, np.ndarray) else x for x in s)
                for s in segs]

    tq, trec = TQ.enqueue_segments(tq, conv(torch.from_numpy),
                                   tenant=v["tenant"])
    jq, jrec = jenq(jq, conv(jnp.asarray), tenant=v["tenant"], impl="ref")
    for i, (a, b) in enumerate(zip(trec, jrec)):
        assert_fields_equal(a, b, f"{name} receipt {i}")
    assert_fields_equal(tq, jq, f"{name} queues after the enqueue")
    assert int(tq.dropped) > 0 and int(tq.tenant_enqueued.sum()) > 0
    if v["segs"][1] == 0:
        assert int(trec[1].n_accepted) == 0 == int(trec[2].n_accepted)
    tq, tdr = TQ.drain_accounting(tq, fault=TFault(**v["fault"]))
    jq, jdr = jdrain(jq, impl="ref", fault=JFault(**v["fault"]))
    assert_fields_equal(tdr, jdr, f"{name} drain receipt")
    assert_fields_equal(tq, jq, f"{name} queues after the drain")
    assert int(tdr.transient_errors) > 0 and int(tdr.errors_dev.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(VARIANTS))
def test_cuda_queue_kernels_match_plain_versions(name):
    """On the card: both kernels bit-identical to their plain versions in
    each variant (every output, the ring fields after the enqueue, the
    drain with and without its fault model, each entry's status under
    it), and across two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    v = VARIANTS[name]
    st, segs = _state(v, 2), _segments(v, 2)
    keys, dst, w, valid, prio = (torch.from_numpy(np.concatenate(
        [s[j] if j < 4 else np.full(len(s[0]), s[4], np.int32)
         for s in segs])).cuda() for j in range(5))
    edges = np.cumsum([0] + [len(s[0]) for s in segs])
    kw = dict(seg_bounds=tuple(zip(edges[:-1].tolist(), edges[1:].tolist())),
              n_devices=v["nd"], stripe_blocks=v["stripe"],
              tenant=v["tenant"], failed_devices=v["failed"])
    results = []
    for fn in (K_enq.sq_enqueue_cuda, tref.sq_enqueue_ref,
               K_enq.sq_enqueue_cuda):
        rings = [torch.from_numpy(st[k].copy()).cuda() for k in RING_FIELDS]
        state = [torch.from_numpy(st[k]).cuda() for k in
                 ("sq_tail", "sq_head", "rr_ptr", "dev_enqueued")]
        out = fn(*rings, *state, keys, dst, w, prio, valid & (keys >= 0),
                 **kw)
        results.append((list(out[:6]) + [out[6][k] for k in PER_SEG],
                        rings))
    for other in results[1:]:
        for x, y in zip(results[0][0] + results[0][1],
                        other[0] + other[1]):
            assert x.dtype == y.dtype and torch.equal(x, y)
    rings = results[0][1]
    drain_in = (rings[0], rings[2], rings[4], rings[5])
    for fault in (None, TFault(**v["fault"])):
        a = K_drain.wfq_drain_cuda(*drain_in, n_devices=v["nd"],
                                   n_tenants=v["nt"], fault=fault,
                                   entry_status=True)
        b = tref.wfq_drain_ref(*drain_in, n_devices=v["nd"],
                               n_tenants=v["nt"], fault=fault,
                               entry_status=True)
        for x, y in zip(a[:5], b[:5]):
            assert x.dtype == y.dtype and torch.equal(x, y)
        assert a[5].keys() == b[5].keys()
        for k in a[5]:
            assert torch.equal(a[5][k], b[5][k]), k
