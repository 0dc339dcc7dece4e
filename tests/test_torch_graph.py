"""BFS and CC on ``repro_torch`` against the JAX package and the oracles,
with ``async_tokens`` False and True, on ``random_graph(300, 6)`` behind a
cache small enough to evict (16 lines of 16 edges, 4 ways) and striped over
two simulated devices.

Depths and labels must equal ``bfs_oracle`` / ``cc_oracle`` and the JAX
run exactly; the final BaM state (cache, rings, ``IOMetrics``) must equal
the JAX run's, integer-valued counters exactly and simulated-time fields
within rtol 1e-6 (float32 charges summed in float32 by the reference and in
float64 by the port).
"""
import jax
import numpy as np
import pytest

from repro.graph import analytics as JG
from repro_torch.graph import analytics as TG

from _torch_port import assert_states_equal, fast_reference_compiles  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

GRAPH = dict(cacheline_bytes=64, cache_bytes=1024, ways=4, n_devices=2)


@pytest.fixture(scope="module")
def graphs():
    indptr, dst = JG.random_graph(300, 6, seed=4)
    gj = JG.BamGraph.build(indptr, dst, **GRAPH)
    gt = TG.BamGraph.build(indptr, dst, device="cpu", **GRAPH)
    return indptr, dst, gj, gt


@pytest.mark.parametrize("seed,n,deg", [(0, 300, 6), (3, 1000, 32)])
def test_random_graph_identical(seed, n, deg):
    a = JG.random_graph(n, deg, seed=seed)
    b = TG.random_graph(n, deg, seed=seed)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("async_tokens", [False, True])
def test_bfs_matches_oracle_and_reference(graphs, async_tokens):
    indptr, dst, gj, gt = graphs
    dj, sj = JG.bfs(gj, 0, async_tokens=async_tokens)
    dt, st = TG.bfs(gt, 0, async_tokens=async_tokens)
    np.testing.assert_array_equal(dt, TG.bfs_oracle(indptr, dst, 0))
    np.testing.assert_array_equal(dt, dj)
    assert_states_equal(st, sj, f"bfs async={async_tokens}")
    assert float(st.metrics.misses) > 0 and float(st.metrics.hits) > 0


@pytest.mark.parametrize("async_tokens", [False, True])
def test_cc_matches_oracle_and_reference(graphs, async_tokens):
    indptr, dst, gj, gt = graphs
    lj, sj = JG.cc(gj, async_tokens=async_tokens)
    lt, st = TG.cc(gt, async_tokens=async_tokens)
    np.testing.assert_array_equal(lt, TG.cc_oracle(indptr, dst))
    np.testing.assert_array_equal(lt, lj)
    assert_states_equal(st, sj, f"cc async={async_tokens}")
    assert float(st.metrics.write_ops) == 0


def test_traversal_leaves_graph_state_untouched(graphs):
    _, _, _, gt = graphs
    before = float(gt.state.metrics.requests)
    TG.bfs(gt, 5)
    assert float(gt.state.metrics.requests) == before == 0.0
