"""The port's transformer (``repro_torch.models``) against the JAX
package's, on the smoke configs the serving slice runs: qwen-smoke (QKV
bias, gated SiLU), minitron-smoke (non-gated GELU MLP) and gemma3-smoke
made all-global (qk-norm, tied embeddings, sqrt(d_model) embedding scale).
The JAX package's ``init`` draws the parameters; ``params_from_numpy``
carries them across.  Everything runs in float32.

Tolerances: layers, forward and decode logits within 1e-4 (float32 sums in
another order; gemma's scaled embeddings make its logits the largest); the
port's decode against its own forward within 2e-3, the tolerance of
``tests/test_models.py``'s decode-vs-forward check.  Integer cache state
(page tables, seq_lens) is exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as jax_smoke
from repro.models import layers as JL
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config, smoke_config
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model

from _torch_port import fast_reference_compiles  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

ALL_GLOBAL = dict(window=None, local_ratio=(0, 1))
CONFIGS = {"qwen2_5_14b": {}, "minitron_4b": {}, "gemma3_12b": ALL_GLOBAL}
S, B, MAX_SEQ = 12, 2, 32
TOL = dict(atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(jax cfg, port cfg, jax api, jax params, port model, tokens)."""
    jcfg = jax_smoke(name).replace(**CONFIGS[name])
    tcfg = smoke_config(name).replace(**CONFIGS[name])
    api = jax_build(jcfg)
    params = jax.jit(lambda key: api.init(key, MAX_SEQ)[0])(
        jax.random.PRNGKey(0))
    model = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray,
                                                           params), "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S))
    return jcfg, tcfg, api, params, model, toks.astype(np.int32)


def _close(a, b, **tol):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), **(tol or TOL))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_layers_match_jax(name):
    jcfg, tcfg, _, params, model, toks = _setup(name)
    bp = jax.tree_util.tree_map(lambda a: a[0], params["blocks"])
    tb = model.blocks[0]
    x = np.random.default_rng(1).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    tx, pos = torch.from_numpy(x), np.arange(S)

    @jax.jit
    def jax_layers(bp, params, jx):
        return (JL.norm_apply(jcfg, bp["ln1"], jx),
                JL.rope(jx, jnp.asarray(pos), jcfg.rope_theta),
                JL.attention(jcfg, bp["attn"], jx),
                JL.mlp(jcfg, bp["mlp"], jx),
                JL.embed(jcfg, params["embed"], jnp.asarray(toks)),
                JL.logits_head(jcfg, params.get("head"), params["embed"], jx))

    want = jax_layers(bp, params, jnp.asarray(x))
    got = (TL.norm_apply(tcfg, tb.ln1, tx),
           TL.rope(tx, torch.from_numpy(pos), tcfg.rope_theta),
           TL.attention(tcfg, tb.attn, tx),
           TL.mlp(tcfg, tb.mlp, tx),
           TL.embed(tcfg, model.embed, torch.from_numpy(toks)),
           TL.logits_head(tcfg, model.head, model.embed, tx))
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_and_decode_match_jax(name):
    """forward logits; then 12 decode steps: logits, pools, page tables and
    seq_lens; and the port's decode against its own forward."""
    jcfg, tcfg, api, params, model, toks = _setup(name)
    jl, _ = jax.jit(api.forward)(params, {"tokens": jnp.asarray(toks)})
    tl, _ = T.forward(tcfg, model, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)

    jc, _ = api.init_decode_cache(B, MAX_SEQ)
    tc = T.init_decode_cache(tcfg, B, MAX_SEQ, "cpu")
    step = jax.jit(api.decode_step)
    for t in range(S):
        jlg, jc = step(params, jc, jnp.asarray(toks[:, t]))
        tlg, tc = T.decode_step(tcfg, model, tc, torch.from_numpy(toks[:, t]))
    _close(tlg, jlg)
    np.testing.assert_array_equal(tc["seq_lens"].numpy(),
                                  np.asarray(jc["seq_lens"]))
    assert len(tc["layers"]) == len(jc["layers"]) == tcfg.n_layers
    for te, je in zip(tc["layers"], jc["layers"]):
        assert te.kind == je.kind == "paged"
        np.testing.assert_array_equal(te.value["page_table"].numpy(),
                                      np.asarray(je.value["page_table"]))
        for k in ("k_pages", "v_pages"):
            _close(te.value[k], je.value[k])
    _close(tlg, tl[:, -1], atol=2e-3, rtol=2e-3)


def test_params_round_trip_and_model_api():
    """params_to_numpy inverts params_from_numpy; the model API builds on
    the CPU when asked and its init follows the reference's scheme."""
    jcfg, tcfg, _, params, model, _ = _setup("qwen2_5_14b")
    back = params_to_numpy(model)
    want = jax.tree_util.tree_map(np.asarray, params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    api = build_model(tcfg, "cpu")
    m = api.init(0)
    assert torch.equal(m.blocks[0].attn.wq.b, torch.zeros_like(
        m.blocks[0].attn.wq.b))
    assert torch.equal(m.ln_f.scale, torch.ones_like(m.ln_f.scale))
    w = m.blocks[1].mlp.w2.w
    assert abs(float(w.std()) * tcfg.d_ff ** 0.5 - 1.0) < 0.1


@pytest.mark.parametrize("name,kw,cls", [
    ("xlstm_1_3b", {}, "XLSTMLM"),              # configs now ported
    ("hymba_1_5b", {}, "HymbaLM"),
    ("qwen2_5_14b", dict(family="ssm"), "XLSTMLM"),     # families now
    ("qwen2_5_14b", dict(family="hybrid"), "HymbaLM"),  # ported
    ("qwen2_5_14b", dict(flash_decode_shards=True), None),  # still raises
])
def test_unported_parts_raise(name, kw, cls):
    """Every config and family builds the model of its family on the CPU;
    ``flash_decode_shards`` still raises."""
    cfg = smoke_config(name).replace(**kw)
    if cls is None:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(cfg, "cpu")
    else:
        model = build_model(cfg, "cpu").init(0)
        assert type(model).__name__ == cls
        assert model.blocks[0].__class__.__module__ == (
            "repro_torch.models.xlstm" if cfg.family == "ssm"
            else "repro_torch.models.hymba")
    assert get_config("qwen2.5-14b").n_layers == 48
