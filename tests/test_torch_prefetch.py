"""Readahead and explicit prefetch in ``repro_torch`` against the JAX
package: the stride detector, a readahead scan with two tokens in flight
(ascending, descending and strided wavefronts, readahead evicting dirty
lines), an explicit-prefetch warm-up, and ``bfs``/``cc(prefetch=True)``.

Compared after every op: values (exact), the whole cache and ring state
(bit-identical), the readahead keys and command tickets of each token, and
``IOMetrics`` (counters exact, simulated-time fields within rtol 1e-6).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BamArray as JArray
from repro.core import prefetch as JP
from repro.core.ssd import ArrayOfSSDs as JSSDs, INTEL_OPTANE_P5800X as JP58
from repro.graph import analytics as JG
from repro_torch.core import prefetch as TP
from repro_torch.core.bam_array import BamArray as TArray
from repro_torch.core.ssd import ArrayOfSSDs as TSSDs, INTEL_OPTANE_P5800X
from repro_torch.graph import analytics as TG

from _torch_port import (  # noqa: F401
    Both, assert_states_equal, fast_reference_compiles)

jax.config.update("jax_platform_name", "cpu")


def _unique_padded(raw, n):
    """Sorted unique keys of ``raw`` padded with -1 to ``n`` rows, as the
    coalescer hands them to the detector."""
    u = np.unique(raw[raw >= 0]).astype(np.int32)
    return np.concatenate([u, np.full(n - len(u), -1, np.int32)])


_RNG = np.random.default_rng(7)
# name: (raw block keys of the wavefront, window, num_blocks, min_support,
#        max_stride)
_CASES = {
    "ascending": (np.repeat(np.arange(100, 132, 2), 3), 8, 1000, 0.75, 64),
    "descending": (np.repeat(np.arange(300, 200, -4), 2), 6, 1000, 0.75, 64),
    "clamped": (np.arange(960, 992, 4), 8, 1000, 0.75, 64),
    "low_support": (_RNG.choice(5000, 24, replace=False), 8, 5000, 0.75, 64),
    "zero_window": (np.arange(10, 20), 0, 1000, 0.75, 64),
    "over_max_stride": (np.arange(0, 800, 100), 4, 1000, 0.75, 64),
}


_LANES = 64    # every case padded to one width: one reference compile


@functools.lru_cache(maxsize=None)
def _jax_fns():
    return (jax.jit(JP.modal_stride),
            jax.jit(JP.readahead_keys, static_argnames=(
                "window", "num_blocks", "min_support", "max_stride")))


@pytest.mark.parametrize("case", sorted(_CASES))
def test_modal_stride_and_readahead_keys_match_reference(case):
    raw, window, nb, sup, mxs = _CASES[case]
    raw = np.concatenate([raw, np.full(_LANES - len(raw), -1)]).astype(
        np.int32)                                    # invalid lanes
    keys = _unique_padded(raw, _LANES)
    valid = keys >= 0
    j_modal, j_readahead = _jax_fns()
    got = TP.modal_stride(torch.from_numpy(keys), torch.from_numpy(valid))
    want = j_modal(jnp.asarray(keys), jnp.asarray(valid))
    for g, w in zip(got, want):
        assert int(g) == int(w), (case, got, want)
    kw = dict(window=window, num_blocks=nb, min_support=sup, max_stride=mxs)
    got = TP.readahead_keys(torch.from_numpy(keys), torch.from_numpy(valid),
                            raw_keys=torch.from_numpy(raw),
                            raw_valid=torch.from_numpy(raw >= 0), **kw)
    want = j_readahead(jnp.asarray(keys), jnp.asarray(valid),
                       raw_keys=jnp.asarray(raw),
                       raw_valid=jnp.asarray(raw >= 0), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    hits = (got >= 0).sum().item()
    expect = {"ascending": 8, "descending": 6, "clamped": 2,
              "low_support": 0, "zero_window": 0, "over_max_stride": 0}
    assert hits == expect[case], (case, got)


BLOCK, SIZE = 16, 4096
CFG = dict(block_elems=BLOCK, num_sets=4, ways=4, num_queues=4,
           queue_depth=32)
N = 64          # lanes a wavefront: four lines


@pytest.fixture(scope="module")
def readahead_ref():
    """One reference array with readahead on, and so one set of compiled
    ops, for the two tests below; each starts from the initial state and
    builds its port array from the reference's storage as it stands."""
    data = (np.random.default_rng(0).standard_normal(SIZE) * 10).astype(
        np.float32)
    return JArray.build(data, ssd=JSSDs(JP58, 2), kernel_impl="ref",
                        prefetch=JP.PrefetchConfig(enabled=True, window=4),
                        **CFG)


def _port_like(ja):
    host = np.asarray(ja.storage.data).reshape(-1)[:SIZE].copy()
    ta, ts = TArray.build(host, ssd=TSSDs(INTEL_OPTANE_P5800X, 2),
                          device="cpu",
                          prefetch=TP.PrefetchConfig(enabled=True, window=4),
                          **CFG)
    return host, ta, ts


def test_readahead_scan_matches_reference(readahead_ref):
    """Dirty a few lines, then scan with two tokens in flight: ascending
    line by line, then descending, then every other line.  Readahead must
    have claimed lines, hit on them and evicted dirty ones on its way."""
    ja, js = readahead_ref
    shadow, ta, ts = _port_like(ja)
    b = Both(ja, js, ta, ts)
    rng = np.random.default_rng(1)
    w_idx = rng.choice(SIZE, N, replace=False).astype(np.int32)
    w_val = rng.standard_normal(N).astype(np.float32)
    b.wait(b.submit("write", w_idx, w_val))
    shadow[w_idx] = w_val
    waves = [np.arange(s, s + N, dtype=np.int32) for s in range(0, 512, N)]
    waves += [np.arange(s + N - 1, s - 1, -1, dtype=np.int32)
              for s in range(3072, 2560, -N)]
    waves += [(np.arange(N, dtype=np.int32) // BLOCK) * 2 * BLOCK
              + np.arange(N, dtype=np.int32) % BLOCK + s
              for s in range(1024, 1536, 2 * N)]
    pending = []
    for idx in waves:
        pending.append((idx, b.submit("read", idx)))
        if len(pending) == 2:
            idx0, tok = pending.pop(0)
            vals, err = b.wait(tok)
            np.testing.assert_array_equal(vals, shadow[idx0])
            assert not err.any()
    idx0, tok = pending.pop(0)
    np.testing.assert_array_equal(b.wait(tok)[0], shadow[idx0])
    b.flush()
    m = b.ts.metrics
    assert float(m.prefetch_issued) > 0 and float(m.prefetch_hits) > 0
    assert float(m.cross_op_coalesced) > 0


def test_explicit_prefetch_warmup_matches_reference(readahead_ref):
    """An IORequest.prefetch token warms lines (unpinned, speculative) while
    a read of other lines is outstanding; reads of the warmed lines then
    hit, and a second hint of resident lines claims nothing."""
    ja, js = readahead_ref
    data, ta, ts = _port_like(ja)
    b = Both(ja, js, ta, ts)
    rng = np.random.default_rng(2)
    lanes = rng.permutation(SIZE).astype(np.int32)
    other, hint = lanes[:8], lanes[N:N + 8]
    pad = np.full(N - 8, -1, np.int32)         # one wavefront shape
    other, hint = np.concatenate([other, pad]), np.concatenate([hint, pad])
    t_read = b.submit("read", other)
    t_hint = b.submit("prefetch", hint)
    vals, _ = b.wait(t_hint)
    assert not vals.any()
    np.testing.assert_array_equal(b.wait(t_read)[0][:8], data[other[:8]])
    issued = float(b.ts.metrics.prefetch_issued)
    assert issued > 0
    np.testing.assert_array_equal(b.wait(b.submit("read", hint))[0][:8],
                                  data[hint[:8]])
    assert float(b.ts.metrics.prefetch_hits) > 0
    b.wait(b.submit("prefetch", hint))
    assert float(b.ts.metrics.prefetch_issued) == issued
    assert not bool(b.ts.cache.refcount.any())


GRAPH = dict(cacheline_bytes=64, cache_bytes=1024, ways=4, n_devices=2)


@pytest.fixture(scope="module")
def graphs():
    indptr, dst = JG.random_graph(300, 6, seed=4)
    gj = JG.BamGraph.build(indptr, dst, **GRAPH)
    gt = TG.BamGraph.build(indptr, dst, device="cpu", **GRAPH)
    return indptr, dst, gj, gt


@pytest.mark.parametrize("algo", ["bfs", "cc"])
def test_graph_prefetch_matches_oracle_and_reference(graphs, algo,
                                                    monkeypatch):
    indptr, dst, gj, gt = graphs
    if algo == "bfs":
        want, sj = JG.bfs(gj, 0, prefetch=True)
        got, st = TG.bfs(gt, 0, prefetch=True)
        oracle = TG.bfs_oracle(indptr, dst, 0)
    else:
        # cc(prefetch=True) calls the reference's prefetch eagerly, op by
        # op; its jitted form (the same function) compiles in a fraction of
        # that.  bfs traces it inside its own jitted step.
        monkeypatch.setattr(gj.edges, "prefetch", jax.jit(
            functools.partial(JArray.prefetch, gj.edges)), raising=False)
        want, sj = JG.cc(gj, prefetch=True)
        got, st = TG.cc(gt, prefetch=True)
        oracle = TG.cc_oracle(indptr, dst)
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, want)
    assert_states_equal(st, sj, f"{algo} prefetch")
    assert float(st.metrics.prefetch_issued) > 0
    with pytest.raises(ValueError, match="pick one"):
        getattr(TG, algo)(gt, *([0] if algo == "bfs" else []),
                          prefetch=True, async_tokens=True)
