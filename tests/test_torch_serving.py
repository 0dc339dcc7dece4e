"""The port's serving path (``repro_torch.serving``) against the JAX
package's: the three cases of ``tests/test_serving.py`` run through both
packages on the same parameters (the JAX package's ``init``, carried across
with ``params_from_numpy``), plus an engine run that spills and fetches,
and the KV manager on scrambled page tables.

Exact: greedy tokens, page tables, spill and fetch counts and every
``IOMetrics`` counter.  Within ``_torch_port.TIME_RTOL``: simulated time
(float32 sums in the reference, float64 in the port).  Within 1e-4:
logits (float32 sums in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import smoke_config as jax_smoke
from repro.models.model import build_model as jax_build
from repro.serving import PagedKVManager as JaxKV
from repro.serving import ServeEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro.utils import Tagged as JaxTagged
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.serving import PagedKVManager, Request, ServeEngine
from repro_torch.utils import Tagged

from _torch_port import assert_metrics_equal
from _torch_port import fast_reference_compiles  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

ALL_GLOBAL = dict(window=None, local_ratio=(0, 1))


@functools.lru_cache(maxsize=None)
def _models(name, seed, max_seq, **kw):
    jcfg = jax_smoke(name).replace(**kw)
    tcfg = smoke_config(name).replace(**kw)
    api = jax_build(jcfg)
    params = jax.jit(lambda key: api.init(key, max_seq)[0])(
        jax.random.PRNGKey(seed))
    model = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray,
                                                           params), "cpu")
    return jcfg, tcfg, api, params, model


def _serve_both(name, seed, prompts, new_tokens, slots, max_seq,
                keep_last=None):
    """Run both engines on the same requests; returns (port requests, jax
    requests, port engine, jax engine)."""
    jcfg, tcfg, _, params, model = _models(name, seed, max_seq)
    kw = {}
    if keep_last is not None:
        kw = dict(kv_manager=JaxKV(keep_last=keep_last))
    je = JaxEngine(jcfg, params, batch_slots=slots, max_seq=max_seq, **kw)
    if keep_last is not None:
        kw = dict(kv_manager=PagedKVManager(keep_last=keep_last))
    te = ServeEngine(tcfg, model, batch_slots=slots, max_seq=max_seq,
                     device="cpu", **kw)
    jr = [JaxRequest(rid=i, prompt=list(p), max_new_tokens=new_tokens)
          for i, p in enumerate(prompts)]
    tr = [Request(rid=i, prompt=list(p), max_new_tokens=new_tokens)
          for i, p in enumerate(prompts)]
    for eng, reqs in ((je, jr), (te, tr)):
        for r in reqs:
            eng.submit(r)
        eng.run()
    return tr, jr, te, je


def test_engine_completes_requests_like_jax():
    tr, jr, te, je = _serve_both(
        "qwen2_5_14b", 0, [[1, 2, 3, 4 + i] for i in range(5)], 6, 2, 64)
    assert all(r.done and len(r.out) == 6 for r in tr)
    assert [r.out for r in tr] == [r.out for r in jr]
    assert te.n_steps == je.n_steps
    # slots reset after their last request (and decoded idle since) hold
    # the reference's lengths and identity page tables
    np.testing.assert_array_equal(te.cache["seq_lens"].numpy(),
                                  np.asarray(je.cache["seq_lens"]))
    for tl, jl in zip(te.cache["layers"], je.cache["layers"]):
        np.testing.assert_array_equal(tl.value["page_table"].numpy(),
                                      np.asarray(jl.value["page_table"]))


def test_engine_spills_and_fetches_like_jax():
    """Prompts long enough that the engine's every-16-steps spill evicts
    pages, which the next step fetches back: the same tokens and the same
    page traffic and simulated time as the reference."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, 256, n).tolist() for n in (30, 21, 26)]
    tr, jr, te, je = _serve_both("qwen2_5_14b", 0, prompts, 5, 2, 64,
                                 keep_last=8)
    assert [r.out for r in tr] == [r.out for r in jr]
    assert float(te.kv.metrics.write_ops) > 0
    assert float(te.kv.metrics.misses) == float(te.kv.metrics.write_ops)
    assert te.kv.page_bytes == je.kv.page_bytes
    assert_metrics_equal(te.kv.metrics, je.kv.metrics, "engine kv")


def test_engine_greedy_matches_manual_decode():
    """Engine output == the reference engine's == the port's manual
    prefill + greedy decode with the model API."""
    jcfg, tcfg, _, params, model = _models("minitron_4b", 1, 32)
    prompt = [3, 1, 4, 1, 5]
    je = JaxEngine(jcfg, params, batch_slots=1, max_seq=32)
    jr = JaxRequest(rid=0, prompt=list(prompt), max_new_tokens=4)
    je.submit(jr)
    je.run()
    te = ServeEngine(tcfg, model, batch_slots=1, max_seq=32, device="cpu")
    r = Request(rid=0, prompt=list(prompt), max_new_tokens=4)
    te.submit(r)
    te.run()

    lg, cache = T.prefill(tcfg, model, {"tokens": torch.tensor([prompt])},
                          32)
    out = []
    for _ in range(4):
        tok = int(lg[0].argmax())
        out.append(tok)
        lg, cache = T.decode_step(tcfg, model, cache, torch.tensor([tok]))
    assert r.out == out == jr.out


def test_spill_and_fetch_roundtrip_like_jax():
    """Spilling cold pages and fetching them back: the same page tables,
    counts and metrics as the reference, and the next step's logits within
    1e-4 of the reference's and equal to the port's own without the
    spill."""
    S = 48
    jcfg, tcfg, api, params, model = _models("gemma3_12b", 2, S,
                                             **ALL_GLOBAL)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, 24)
    step = jax.jit(api.decode_step)
    jc, _ = api.init_decode_cache(1, S)
    tc = T.init_decode_cache(tcfg, 1, S, "cpu")
    for t in toks[:-1]:
        _, jc = step(params, jc, jnp.asarray([t], jnp.int32))
        _, tc = T.decode_step(tcfg, model, tc, torch.tensor([int(t)]))
    last = torch.tensor([int(toks[-1])])
    lg_plain, _ = T.decode_step(tcfg, model, tc, last)

    jkv, tkv = JaxKV(keep_last=8), PagedKVManager(keep_last=8)
    jc2, jn = jkv.maybe_spill(jc)
    tc2, tn = tkv.maybe_spill(tc)
    assert tn == jn > 0
    for te, je in zip(tc2["layers"], jc2["layers"]):
        pt = te.value["page_table"].numpy()
        np.testing.assert_array_equal(pt, np.asarray(je.value["page_table"]))
        assert (pt < 0).any()
    jc3, jf = jkv.ensure_resident(jc2)
    tc3, tf = tkv.ensure_resident(tc2)
    assert tf == jf == tn
    for te, je in zip(tc3["layers"], jc3["layers"]):
        np.testing.assert_array_equal(te.value["page_table"].numpy(),
                                      np.asarray(je.value["page_table"]))
    assert_metrics_equal(tkv.metrics, jkv.metrics, "roundtrip")
    jlg, _ = step(params, jc3, jnp.asarray([int(toks[-1])], jnp.int32))
    tlg, _ = T.decode_step(tcfg, model, tc3, last)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=1e-4,
                               rtol=1e-4)
    assert torch.equal(tlg, lg_plain)


def _scrambled_cache(rng, B=3, P=7, NP=5, page=4, Hkv=2, D=8, n_layers=2):
    """Pools of random values, page tables that are permutations (with
    spare physical pages), and per-sequence lengths."""
    layers = []
    for _ in range(n_layers):
        kp = rng.standard_normal((B, P, page, Hkv, D)).astype(np.float32)
        vp = rng.standard_normal((B, P, page, Hkv, D)).astype(np.float32)
        pt = np.stack([rng.permutation(P)[:NP] for _ in range(B)])
        layers.append((kp, vp, pt.astype(np.int32)))
    seq_lens = np.array([NP * page, 13, 7], np.int32)
    return layers, seq_lens


def test_kv_manager_scrambled_tables_like_jax():
    """Fetched pages take the lowest free physical page of their sequence,
    as the reference's ``set.pop()`` does: page tables, pools and metrics
    equal the reference's after a spill, a fetch and a deferred drain."""
    layers, seq_lens = _scrambled_cache(np.random.default_rng(7))
    jc = {"seq_lens": jnp.asarray(seq_lens),
          "layers": tuple(JaxTagged("paged", {
              "k_pages": jnp.asarray(k), "v_pages": jnp.asarray(v),
              "page_table": jnp.asarray(pt)}) for k, v, pt in layers)}
    for deferred in (False, True):
        # a fresh port cache each time: a fetch writes into the pools in
        # place, so the cache from before the spill is spent after it
        tc = {"seq_lens": torch.from_numpy(seq_lens),
              "layers": tuple(Tagged("paged", {
                  "k_pages": torch.from_numpy(k.copy()),
                  "v_pages": torch.from_numpy(v.copy()),
                  "page_table": torch.from_numpy(pt.copy())})
                  for k, v, pt in layers)}
        jkv = JaxKV(keep_last=5, deferred=deferred)
        tkv = PagedKVManager(keep_last=5, deferred=deferred)
        jc2, jn = jkv.maybe_spill(jc)
        tc2, tn = tkv.maybe_spill(tc)
        jc3, jf = jkv.ensure_resident(jc2)
        tc3, tf = tkv.ensure_resident(tc2)
        assert (tn, tf) == (jn, jf) and tn > 0
        assert tkv.drain() == jkv.drain()
        for te, je in zip(tc3["layers"], jc3["layers"]):
            pt = te.value["page_table"].numpy()
            np.testing.assert_array_equal(pt,
                                          np.asarray(je.value["page_table"]))
            for k in ("k_pages", "v_pages"):
                b, lp = np.nonzero(pt >= 0)
                np.testing.assert_array_equal(
                    te.value[k].numpy()[b, pt[b, lp]],
                    np.asarray(je.value[k])[b, pt[b, lp]])
        assert_metrics_equal(tkv.metrics, jkv.metrics, f"deferred={deferred}")
