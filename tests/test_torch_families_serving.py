"""The port's serving engine on the new families against the JAX
package's, on the same requests and parameters (the JAX package's
``init``, carried across with ``params_from_numpy``), in float32 on the
smoke configs: gemma3-12b with its ring layers (prompts past the window of
8, more requests than slots so slots are reused, pages of the global layer
spilled and fetched), olmoe (MoE) and whisper (learned positions, the
cross-attention over an ``xkv`` the engine never fills; 3 slots, so the
batch is not the layer count).

Exact: greedy tokens, engine steps, page tables, ring positions,
seq_lens, spill and fetch counts and every ``IOMetrics`` counter.  Within
1e-4: the ring and paged K/V left in the cache (float32 sums in another
order).
"""
import functools

import jax
import numpy as np
import pytest

from repro.configs.base import smoke_config as jax_smoke
from repro.models.model import build_model as jax_build
from repro.serving import PagedKVManager as JaxKV
from repro.serving import ServeEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.serving import PagedKVManager, Request, ServeEngine

from _torch_port import assert_metrics_equal
from _torch_port import fast_reference_compiles  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

MAX_SEQ = 48


@functools.lru_cache(maxsize=None)
def _models(name):
    jcfg, tcfg = jax_smoke(name), smoke_config(name)
    api = jax_build(jcfg)
    params = jax.jit(lambda key: api.init(key, MAX_SEQ)[0])(
        jax.random.PRNGKey(1))
    model = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray,
                                                           params), "cpu")
    return jcfg, tcfg, params, model


CASES = {
    # name: (prompt lengths, new tokens, slots, keep_last)
    "gemma3_12b": ((14, 9, 20, 11, 17), 6, 2, 8),
    "olmoe_1b_7b": ((22, 9, 18, 13), 4, 3, 8),
    "whisper_large_v3": ((6, 11, 4, 9), 5, 3, None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_jax(name):
    lens, new_tokens, slots, keep_last = CASES[name]
    jcfg, tcfg, params, model = _models(name)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, jcfg.vocab, n).tolist() for n in lens]
    jkw = {} if keep_last is None else dict(kv_manager=JaxKV(
        keep_last=keep_last))
    tkw = {} if keep_last is None else dict(kv_manager=PagedKVManager(
        keep_last=keep_last))
    je = JaxEngine(jcfg, params, batch_slots=slots, max_seq=MAX_SEQ, **jkw)
    te = ServeEngine(tcfg, model, batch_slots=slots, max_seq=MAX_SEQ,
                     device="cpu", **tkw)
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
    if jcfg.window is not None:
        assert max(lens) > jcfg.window
    if jcfg.enc_dec:
        assert slots != jcfg.n_layers and not te.cache["xkv"].any()
    np.testing.assert_array_equal(te.cache["seq_lens"].numpy(),
                                  np.asarray(je.cache["seq_lens"]))
    kinds = [t.kind for t in te.cache["layers"]]
    assert kinds == [t.kind for t in je.cache["layers"]]
    assert ("ring" in kinds) == (jcfg.window is not None)
    for tl, jl in zip(te.cache["layers"], je.cache["layers"]):
        for k, v in tl.value.items():
            want = np.asarray(jl.value[k])
            if k in ("pos", "page_table"):
                np.testing.assert_array_equal(v.numpy(), want)
            else:
                np.testing.assert_allclose(v.numpy(), want, atol=1e-4,
                                           rtol=1e-4)
    if keep_last is not None:
        assert float(te.kv.metrics.write_ops) > 0
        assert float(te.kv.metrics.misses) > 0
        assert_metrics_equal(te.kv.metrics, je.kv.metrics, name)
