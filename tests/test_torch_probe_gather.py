"""The port's ``cache_probe`` and ``gather_blocks`` against the JAX
package's Pallas kernels (interpret mode) and jnp oracles, bit for bit.
Split from ``test_torch_kernels.py``, whose directory helper it uses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

from _torch_port import fast_reference_compiles  # noqa: F401
from test_torch_kernels import _consistent_tags

jax.config.update("jax_platform_name", "cpu")


@pytest.mark.parametrize("W", [16, 32])
def test_cache_probe_wide_sets_match_ref(W):
    rng = np.random.default_rng(W)
    S, m = 4, 200
    tags = _consistent_tags(rng, S, W, 4 * S * W)
    owner = rng.integers(0, 2, (S, W)).astype(np.int32)
    keys = np.concatenate([tags.reshape(-1), rng.integers(-3, 4 * S * W,
                                                          m - S * W)])
    keys = rng.permutation(keys).astype(np.int32)
    hit_t, slot_t = tops.cache_probe(torch.from_numpy(tags),
                                     torch.from_numpy(keys),
                                     owner=torch.from_numpy(owner), tenant=1)
    hit_j, slot_j = jops.cache_probe(jnp.asarray(tags), jnp.asarray(keys),
                                     owner=jnp.asarray(owner), tenant=1,
                                     impl="ref")
    np.testing.assert_array_equal(hit_t.numpy(), np.asarray(hit_j))
    np.testing.assert_array_equal(slot_t.numpy(), np.asarray(slot_j))
    assert bool(hit_t.any()) and not bool(hit_t.all())


@pytest.mark.parametrize("with_owner", [False, True])
def test_cache_probe_matches_pallas_and_ref(with_owner):
    rng = np.random.default_rng(11 + with_owner)
    S, W, m = 16, 4, 300
    tags = _consistent_tags(rng, S, W, 4 * S * W)
    owner = rng.integers(0, 2, (S, W)).astype(np.int32)
    keys = np.concatenate([tags.reshape(-1), rng.integers(-3, 4 * S * W,
                                                          m - S * W)])
    keys = rng.permutation(keys).astype(np.int32)
    kw = dict(tenant=1) if with_owner else {}
    jo = dict(owner=jnp.asarray(owner)) if with_owner else {}
    to = dict(owner=torch.from_numpy(owner)) if with_owner else {}
    hit_t, slot_t = tops.cache_probe(torch.from_numpy(tags),
                                     torch.from_numpy(keys), **to, **kw)
    for impl in ("pallas", "ref"):
        extra = dict(interpret=True, block_m=128) if impl == "pallas" else {}
        hit_j, slot_j = jops.cache_probe(jnp.asarray(tags), jnp.asarray(keys),
                                         impl=impl, **jo, **kw, **extra)
        np.testing.assert_array_equal(hit_t.numpy(), np.asarray(hit_j))
        np.testing.assert_array_equal(slot_t.numpy(), np.asarray(slot_j))
    assert bool(hit_t.any()) and not bool(hit_t.all())


def _to_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_gather_blocks_matches_pallas_and_ref(dtype):
    rng = np.random.default_rng(7)
    n_lines, line, n = 12, 16, 40
    base = rng.standard_normal((n_lines, line)) * 100
    slots = rng.integers(-2, n_lines, n).astype(np.int32)
    off = rng.integers(0, line, n).astype(np.int32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
           "int32": jnp.int32}[dtype]
    jdata = jnp.asarray(base).astype(jdt)
    tdata = torch.from_numpy(np.array(jdata.astype(jnp.float32))).to(
        getattr(torch, dtype))
    lines_t = tops.gather_blocks(tdata, torch.from_numpy(slots))
    elems_t = tops.gather_blocks(tdata, torch.from_numpy(slots),
                                 off=torch.from_numpy(off))
    for impl, extra in (("pallas", dict(interpret=True)), ("ref", {})):
        lines_j = jops.gather_blocks(jdata, jnp.asarray(slots), impl=impl,
                                     **extra)
        elems_j = jops.gather_blocks(jdata, jnp.asarray(slots),
                                     off=jnp.asarray(off), impl=impl, **extra)
        np.testing.assert_array_equal(
            _to_np(lines_t), np.asarray(lines_j.astype(jnp.float32)))
        np.testing.assert_array_equal(
            _to_np(elems_t), np.asarray(elems_j.astype(jnp.float32)))
