"""The port's serving engine on the hybrid (hymba) and SSM (xLSTM) families
against the JAX package's, on the same requests and parameters (the JAX
package's ``init``, carried across with ``params_from_numpy``), in float32
on the smoke configs (hymba at 4 layers: one window layer, three paged).

Hymba's engine primes its cache with the meta tokens at construction; a
``keep_last`` of 8 makes its paged layers spill and fetch; more requests
than slots make retired slots come back, to the primed state.  Exact:
greedy tokens, engine steps, page tables, ring positions, seq_lens, spill
and fetch counts and every ``IOMetrics`` counter.  Within 1e-4: K/V,
``conv``, ``state`` and the xLSTM states left in the cache.
``spill_cold_pages`` and ``fetch_holes`` on hymba's tuple layers move the
pages the reference's move and keep each layer's SSM state; an xLSTM
cache, with no paged layer, moves nothing.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as jax_smoke
from repro.models.model import build_model as jax_build
from repro.serving import PagedKVManager as JaxKV
from repro.serving import ServeEngine as JaxEngine
from repro.serving import kv_cache as jkv
from repro.serving.engine import Request as JaxRequest
from repro.utils import Tagged as JTagged
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.serving import (PagedKVManager, Request, ServeEngine,
                                 fetch_holes, spill_cold_pages)
from repro_torch.serving.engine import _leaves

from _torch_port import assert_metrics_equal
from _torch_port import fast_reference_compiles  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

MAX_SEQ = 48
DEPTH = {"hymba_1_5b": 4}
TOL = dict(atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _models(name):
    kw = dict(n_layers=DEPTH[name]) if name in DEPTH else {}
    jcfg = jax_smoke(name).replace(**kw)
    tcfg = smoke_config(name).replace(**kw)
    api = jax_build(jcfg)
    params = jax.jit(lambda key: api.init(key, MAX_SEQ)[0])(
        jax.random.PRNGKey(1))
    model = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray,
                                                           params), "cpu")
    return jcfg, tcfg, params, model


def _pairs(tc, jc):
    """(port tensor, reference array, exact) over two caches' leaves."""
    out = [(tc["seq_lens"], jc["seq_lens"], True)]
    for tl, jl in zip(tc["layers"], jc["layers"]):
        if isinstance(tl, tuple):
            for k in ("conv", "state"):
                out.append((tl[1][k], jl[1][k], False))
            tl, jl = tl[0], jl[0]
        assert tl.kind == jl.kind
        if isinstance(tl.value, dict):
            out += [(v, jl.value[k], k in ("pos", "page_table"))
                    for k, v in tl.value.items()]
        else:
            out += [(a, b, False) for a, b in zip(tl.value, jl.value)]
    return out


def _assert_cache_close(tc, jc):
    for a, b, exact in _pairs(tc, jc):
        if exact:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


CASES = {
    # name: (prompt lengths, new tokens, slots, keep_last)
    "hymba_1_5b": ((14, 9, 20, 11, 17), 6, 2, 8),
    "xlstm_1_3b": ((22, 9, 18, 13), 4, 3, 8),
}


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_jax(name):
    lens, new_tokens, slots, keep_last = CASES[name]
    jcfg, tcfg, params, model = _models(name)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, jcfg.vocab, n).tolist() for n in lens]
    je = JaxEngine(jcfg, params, batch_slots=slots, max_seq=MAX_SEQ,
                   kv_manager=JaxKV(keep_last=keep_last))
    te = ServeEngine(tcfg, model, batch_slots=slots, max_seq=MAX_SEQ,
                     kv_manager=PagedKVManager(keep_last=keep_last),
                     device="cpu")
    _assert_cache_close(te.cache, je.cache)           # after prime
    jr = [JaxRequest(rid=i, prompt=list(p), max_new_tokens=new_tokens)
          for i, p in enumerate(prompts)]
    tr = [Request(rid=i, prompt=list(p), max_new_tokens=new_tokens)
          for i, p in enumerate(prompts)]
    for eng, reqs in ((je, jr), (te, tr)):
        for r in reqs:
            eng.submit(r)
        eng.run()
    assert all(r.done and len(r.out) == new_tokens for r in tr)
    assert [r.out for r in tr] == [r.out for r in jr]
    assert te.n_steps == je.n_steps
    assert len(lens) > slots                          # slots were reused
    _assert_cache_close(te.cache, je.cache)
    assert_metrics_equal(te.kv.metrics, je.kv.metrics, name)
    if jcfg.family == "hybrid":
        assert max(lens) + jcfg.n_meta_tokens > jcfg.window
        assert float(te.kv.metrics.write_ops) > 0
        assert float(te.kv.metrics.write_ops) == float(te.kv.metrics.misses)
    else:
        assert float(te.kv.metrics.write_ops) == 0
        assert float(te.kv.metrics.misses) == 0


def test_retired_slot_is_reset_to_primed_row():
    """One request on two slots (an idle slot decodes too, as in the
    reference): when it retires, its row is row 0 of the primed batch
    cache, bit for bit, and equals a fresh primed cache's row, the meta
    tokens' K/V, conv and SSM state included."""
    _, tcfg, _, model = _models("hymba_1_5b")
    te = ServeEngine(tcfg, model, batch_slots=2, max_seq=MAX_SEQ,
                     device="cpu")
    primed = [t[0].clone() for t in _leaves(te.cache)]
    te.submit(Request(rid=0, prompt=[3, 4, 5], max_new_tokens=2))
    te.step()
    assert te.cache["seq_lens"].tolist() == [tcfg.n_meta_tokens + 1] * 2
    te.run()
    assert te.cache["seq_lens"].tolist() == [tcfg.n_meta_tokens,
                                             tcfg.n_meta_tokens + 4]
    api = build_model(tcfg, "cpu")
    fresh = api.prime(model, api.init_decode_cache(1, MAX_SEQ))
    for now, snap, want in zip(_leaves(te.cache), primed, _leaves(fresh)):
        assert torch.equal(now[0], snap)
        np.testing.assert_allclose(now[0].numpy(), want[0].numpy(), **TOL)


def _hymba_caches():
    """A port and a reference hymba cache (B 2, 60 positions a pool), their
    pools random and equal, sequences of 30 and 52 tokens."""
    _, tcfg, _, _ = _models("hymba_1_5b")
    api = build_model(tcfg, "cpu")
    tc = api.init_decode_cache(2, 56)
    gen = torch.Generator().manual_seed(7)
    for layer in tc["layers"]:
        for k, v in layer[0].value.items():
            if k in ("k", "v", "k_pages", "v_pages"):
                v.copy_(torch.randn(v.shape, generator=gen))
        for v in layer[1].values():
            v.copy_(torch.randn(v.shape, generator=gen))
    tc["seq_lens"] = torch.tensor([30, 52], dtype=torch.int32)

    def to_jax(item):
        t, ssm = item
        return (JTagged(t.kind, {k: jnp.asarray(v.numpy())
                                 for k, v in t.value.items()}),
                {k: jnp.asarray(v.numpy()) for k, v in ssm.items()})
    jc = {"seq_lens": jnp.asarray(tc["seq_lens"].numpy()),
          "layers": tuple(map(to_jax, tc["layers"]))}
    return tc, jc


def test_spill_and_fetch_on_tuple_layers():
    """keep_last 8 spills the same (layer, sequence, page) keys with the
    same contents as the reference, leaves each layer's SSM state alone,
    and the fetch puts every page back where the reference's does."""
    tc, jc = _hymba_caches()
    t_store, j_store = {}, {}

    def t_store_fn(layer, bs, lps, k, v):
        for j, (b, lp) in enumerate(zip(bs, lps)):
            t_store[(layer, b, lp)] = (k[j], v[j])

    def j_store_fn(layer, b, lp, k, v):
        j_store[(layer, b, lp)] = (np.asarray(k), np.asarray(v))

    ssm_before = [layer[1] for layer in tc["layers"]]
    tc2, n = spill_cold_pages(tc, 8, t_store_fn)
    jc2, jn = jkv.spill_cold_pages(jc, 8, j_store_fn)
    assert n == jn > 0 and sorted(t_store) == sorted(j_store)
    assert {k[0] for k in t_store} == {0, 2, 3}       # the paged layers
    for key, (k, v) in t_store.items():
        np.testing.assert_array_equal(k.numpy(), j_store[key][0])
        np.testing.assert_array_equal(v.numpy(), j_store[key][1])
    assert [layer[1] for layer in tc2["layers"]] == ssm_before
    _assert_cache_close(tc2, jc2)

    tc3, n = fetch_holes(tc2, lambda li, b, lp: t_store.get((li, b, lp)))
    jc3, jn = jkv.fetch_holes(jc2, lambda li, b, lp: j_store.get((li, b, lp)))
    assert n == jn == len(t_store)
    assert [layer[1] for layer in tc3["layers"]] == ssm_before
    _assert_cache_close(tc3, jc3)


def test_xlstm_cache_spills_nothing():
    """No paged layer: spill and fetch return the cache and 0, and the
    manager counts nothing."""
    _, tcfg, _, _ = _models("xlstm_1_3b")
    cache = build_model(tcfg, "cpu").init_decode_cache(2, MAX_SEQ)
    cache["seq_lens"] = torch.tensor([40, 47], dtype=torch.int32)

    def store_fn(*a):
        raise AssertionError("an xLSTM cache has no page to store")

    assert spill_cold_pages(cache, 1, store_fn) == (cache, 0)
    assert fetch_holes(cache, store_fn) == (cache, 0)
    kv = PagedKVManager(keep_last=1)
    assert kv.maybe_spill(cache)[1] == 0 and kv.ensure_resident(cache)[1] == 0
    assert float(kv.metrics.write_ops) == float(kv.metrics.misses) == 0
