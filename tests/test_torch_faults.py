"""The fault path of ``repro_torch`` against the JAX package: the counter
hash and retry loop (``FaultModel.command_status``), block routing around
hard-failed devices, and ``tests/test_faults.py``'s op sequences run
through both packages (a failed device under transient errors with ring
drops, readahead on sequential reads and explicit prefetch hints, and
``rate=1.0`` where every fetch fails).

Compared after every op: values, the per-lane error and drop masks, the
command tickets, the whole cache and ring state and ``IOMetrics``
(counters exact, simulated-time fields within rtol 1e-6), and storage after
every flush.  A numpy oracle of the surviving lanes is kept as
``run_fault_ops`` keeps it: an errored read lane is 0, an errored write
never lands.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BamArray as JArray
from repro.core import ssd as JS
from repro.core.prefetch import PrefetchConfig as JPC
from repro_torch.core import ssd as TS
from repro_torch.core.bam_array import BamArray as TArray
from repro_torch.core.prefetch import PrefetchConfig as TPC

from _torch_port import Both, fast_reference_compiles  # noqa: F401

jax.config.update("jax_platform_name", "cpu")


@pytest.mark.parametrize("seed", [0, 0x5EED])
@pytest.mark.parametrize("rate", [2.0 ** -24, 0.3, 1.0])
def test_command_status_and_routing_match_reference(rate, seed):
    rng = np.random.default_rng(seed)
    dev = rng.integers(0, 8, 4096).astype(np.int32)
    ticket = rng.integers(-1, 2 ** 31 - 1, 4096).astype(np.int32)
    ticket[:4] = [-1, 0, 1, 2 ** 31 - 1]
    kw = dict(transient_error_rate=rate, tail_latency_mult=2.0,
              retry_budget=2, failed_devices=(5,), seed=seed)
    got = TS.FaultModel(**kw).command_status(torch.from_numpy(dev),
                                             torch.from_numpy(ticket))
    want = JS.FaultModel(**kw).command_status(jnp.asarray(dev),
                                              jnp.asarray(ticket))
    for name, g, w in zip(("ok", "retries", "transient"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    if rate == 1.0:
        assert not got[0][ticket >= 0].any()
    keys = rng.integers(-3, 1 << 20, 4096).astype(np.int32)
    for nd, stripe, failed in ((8, 1, (5,)), (4, 3, (0, 2)), (2, 1, ())):
        np.testing.assert_array_equal(
            TS.device_of_block(torch.from_numpy(keys), nd, stripe,
                               failed).numpy(),
            np.asarray(JS.device_of_block(jnp.asarray(keys), nd, stripe,
                                          failed)))


N = 24           # lanes a wavefront: one shape, one reference compile
SIZE = 300
_SEQS = {
    # a dead device's stripes remap to the survivors; transient errors on
    # the rest; depth-4 rings drop part of every burst (read-through);
    # readahead claims lines ahead of sequential reads ("seq") and
    # prefetch hints warm lines, some of whose fetches fail
    "failed_device": dict(n_devices=4, rate=0.3, budget=1, failed=(1,),
                          depth=4, seed=3, readahead=True,
                          ops=["read", "write", "seq", "pair", "hint",
                               "seq", "read", "flush", "write", "seq",
                               "hint", "pair", "seq", "read", "flush"]),
    # every command fails: nothing is ever filled and nothing leaks
    "total_failure": dict(n_devices=2, rate=1.0, budget=0, failed=(),
                          depth=64, seed=4, readahead=False,
                          ops=["read", "write", "pair", "flush", "read"]),
}


@pytest.mark.parametrize("name", sorted(_SEQS))
def test_fault_op_sequences_match_reference(name):
    c = _SEQS[name]
    rng = np.random.default_rng(c["seed"])
    data = rng.standard_normal(SIZE).astype(np.float32)
    oracle = data.copy()
    fk = dict(transient_error_rate=c["rate"], tail_latency_mult=2.0,
              retry_budget=c["budget"], failed_devices=c["failed"],
              seed=c["seed"])
    cfg = dict(block_elems=4, num_sets=8, ways=2,
               num_queues=2 * c["n_devices"], queue_depth=c["depth"])
    ra = dict(enabled=c["readahead"], window=4)
    ja, js = JArray.build(data, kernel_impl="ref", ssd=JS.ArrayOfSSDs(
        JS.INTEL_OPTANE_P5800X, c["n_devices"], fault=JS.FaultModel(**fk)),
        prefetch=JPC(**ra), **cfg)
    ta, ts = TArray.build(data, device="cpu", ssd=TS.ArrayOfSSDs(
        TS.INTEL_OPTANE_P5800X, c["n_devices"], fault=TS.FaultModel(**fk)),
        prefetch=TPC(**ra), **cfg)
    b = Both(ja, js, ta, ts)
    lanes = np.arange(-2, SIZE + 3, dtype=np.int32)
    errors = 0

    def read_toks():
        idx = rng.integers(-2, SIZE + 3, N).astype(np.int32)
        return idx, b.submit("read", idx)

    def seq_toks():
        start = int(rng.integers(0, SIZE - 2 * N))
        idx = np.arange(start, start + N, dtype=np.int32)
        return idx, b.submit("read", idx)

    def check_read(idx, toks):
        nonlocal errors
        vals, err = b.wait(toks)
        valid = (idx >= 0) & (idx < SIZE)
        assert not err[~valid].any()
        ok = valid & ~err
        np.testing.assert_array_equal(vals[ok],
                                      oracle[np.clip(idx, 0, SIZE - 1)][ok])
        assert not vals[err].any()
        errors += int(err.sum())
        if c["rate"] == 1.0:
            assert err[valid].all()

    def write_toks():
        idx = rng.choice(lanes, N, replace=False)
        vals = rng.standard_normal(N).astype(np.float32)
        return idx, vals, b.submit("write", idx, vals)

    def check_write(idx, vals, toks):
        nonlocal errors
        _, err = b.wait(toks)
        landed = (idx >= 0) & (idx < SIZE) & ~err
        oracle[idx[landed]] = vals[landed]
        errors += int(err.sum())

    for op in c["ops"]:
        if op == "read":
            check_read(*read_toks())
        elif op == "seq":
            check_read(*seq_toks())
        elif op == "hint":           # a hint, redeemed after a read
            hint = b.submit("prefetch",
                            rng.integers(-2, SIZE + 3, N).astype(np.int32))
            check_read(*read_toks())
            vals, err = b.wait(hint)
            assert not vals.any()
            errors += int(err.sum())
        elif op == "write":
            check_write(*write_toks())
        elif op == "pair":           # two tokens outstanding, then both
            r, w = read_toks(), write_toks()
            check_read(*r)
            check_write(*w)
        else:
            b.flush()
            np.testing.assert_array_equal(
                ta.storage.data.numpy().reshape(-1)[:SIZE], oracle)
    b.flush()
    np.testing.assert_array_equal(
        ta.storage.data.numpy().reshape(-1)[:SIZE], oracle)
    cache, qs, mt = b.ts.cache, b.ts.queues, b.ts.metrics
    assert not bool(cache.refcount.any()) and not bool(cache.inflight.any())
    assert torch.equal(qs.dev_enqueued, qs.dev_completed)
    assert float(mt.failed_commands) == float(mt.dev_errors.sum()) > 0
    assert float(mt.degraded_reads) == errors > 0
    if c["failed"]:
        assert float(mt.retries) > 0 and float(mt.dropped) > 0
        assert float(mt.dev_reads[1]) == 0 == float(mt.dev_writes[1])
    if c["readahead"]:
        assert float(mt.prefetch_issued) > 0 and float(mt.prefetch_hits) > 0
    if c["rate"] == 1.0:
        assert bool((cache.tags == -1).all())
