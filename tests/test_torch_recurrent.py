"""The port's hybrid (hymba) and SSM (xLSTM) families against the JAX
package's, on the smoke configs in float32.  The JAX package's ``init``
draws the parameters; ``params_from_numpy`` carries them across.

Per family (hymba at 4 layers, so that one is a window layer): forward
logits; ``prime`` (hymba's meta tokens) and
token-by-token decode of S = 12 tokens, past the smoke window of 8 (the
last logits and the whole decode cache).  Per module: ``mamba_apply``'s
prefill at an S its chunk does not divide (the identity-step padding) and
its decode from a carried conv and SSM state; ``mlstm_chunkwise`` at
chunks 4 and 8 from zero and from a carried state; ``slstm_block`` and
``slstm_block_step``.  Integer cache state (ring ``pos``, page tables,
seq_lens) is exact; logits, K/V, ``conv``, ``state`` and the xLSTM states
within 1e-4 (float32 sums in another order).  ``init_random_`` gives the
reference's constants; ``params_to_numpy`` inverts ``params_from_numpy``
bit for bit; the full configs count the reference's parameters.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke_config as jax_smoke
from repro.models import hymba as JH
from repro.models import xlstm as JX
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config, smoke_config
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import hymba as H
from repro_torch.models import xlstm as X
from repro_torch.models.model import build_model, count_params, family_module

from _torch_port import fast_reference_compiles  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

FAMILIES = ["hymba_1_5b", "xlstm_1_3b"]
S, B, MAX_SEQ = 12, 2, 32
# hymba's smoke config at 4 layers: its global layers are {0, 2, 3}, so
# layer 1 attends over a window (its smoke depth of 3 makes every layer
# global)
DEPTH = {"hymba_1_5b": 4}
TOL = dict(atol=1e-4, rtol=1e-4)


def _close(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), **TOL)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(jax cfg, port cfg, jax params, port model, numpy tokens)."""
    kw = dict(n_layers=DEPTH[name]) if name in DEPTH else {}
    jcfg = jax_smoke(name).replace(**kw)
    tcfg = smoke_config(name).replace(**kw)
    api = jax_build(jcfg)
    params = jax.jit(lambda key: api.init(key, MAX_SEQ)[0])(
        jax.random.PRNGKey(0))
    model = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray,
                                                           params), "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S)).astype(
        np.int32)
    return jcfg, tcfg, params, model, toks


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's forward logits, and its last logits and cache after
    prime and S decode steps.  One jit each of forward, decode_step and
    the step ``prime_cache`` loops over (``decode_embed_step`` on each meta
    row), which compiles in a third of the time of the unrolled loop;
    ``tests/test_torch_recurrent_serving.py`` runs ``prime_cache`` itself,
    in the reference's engine."""
    jcfg, _, params, _, toks = _setup(name)
    api = jax_build(jcfg)
    toks = jnp.asarray(toks)
    logits = jax.jit(lambda p, t: api.forward(p, {"tokens": t})[0])(
        params, toks)
    cache, _ = api.init_decode_cache(B, MAX_SEQ)
    if api.prime is not None:
        meta_step = jax.jit(lambda p, c, x: JH.decode_embed_step(
            jcfg, p, c, x)[1])
        for m in range(jcfg.n_meta_tokens):
            cache = meta_step(params, cache, jnp.broadcast_to(
                params["meta"][m][None, None], (B, 1, jcfg.d_model)))
    step = jax.jit(api.decode_step)
    for t in range(S):
        lg, cache = step(params, cache, toks[:, t])
    return logits, lg, cache


def _assert_cache_close(tc, jc):
    np.testing.assert_array_equal(tc["seq_lens"].numpy(),
                                  np.asarray(jc["seq_lens"]))
    assert len(tc["layers"]) == len(jc["layers"])
    for tl, jl in zip(tc["layers"], jc["layers"]):
        if isinstance(jl, tuple):                    # hymba: (attn, ssm)
            (tt, tssm), (jt, jssm) = tl, jl
            assert sorted(tssm) == sorted(jssm) == ["conv", "state"]
            for k in tssm:
                _close(tssm[k], jssm[k])
        else:
            tt, jt = tl, jl
        assert tt.kind == jt.kind
        if isinstance(jt.value, dict):
            assert sorted(tt.value) == sorted(jt.value)
            for k, v in tt.value.items():
                if k in ("pos", "page_table"):
                    np.testing.assert_array_equal(v.numpy(),
                                                  np.asarray(jt.value[k]))
                else:
                    _close(v, jt.value[k])
        else:                                        # xLSTM states
            assert len(tt.value) == len(jt.value)
            for a, b in zip(tt.value, jt.value):
                _close(a, b)


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_jax(name):
    jcfg, tcfg, _, model, toks = _setup(name)
    jl, _, _ = _reference(name)
    tl, aux = build_model(tcfg, "cpu").forward(
        model, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (B, S, jcfg.vocab) and aux == {}
    _close(tl, jl)


@pytest.mark.parametrize("name", FAMILIES)
def test_prime_and_decode_match_jax(name):
    """prime, then 12 tokens one at a time (hymba's rings wrap: 4 meta
    tokens and 12 tokens pass the window of 8): the last logits and the
    whole decode cache."""
    jcfg, tcfg, _, model, toks = _setup(name)
    _, jlg, jc = _reference(name)
    api = build_model(tcfg, "cpu")
    assert (api.prime is None) == (jcfg.family == "ssm")
    cache = api.init_decode_cache(B, MAX_SEQ)
    if api.prime is not None:
        cache = api.prime(model, cache)
        assert cache["seq_lens"].tolist() == [jcfg.n_meta_tokens] * B
    for t in range(S):
        tlg, cache = api.decode_step(model, cache,
                                     torch.from_numpy(toks[:, t]))
    _close(tlg, jlg)
    _assert_cache_close(cache, jc)
    if jcfg.family == "hybrid":
        kinds = [layer[0].kind for layer in cache["layers"]]
        assert kinds == ["paged", "ring", "paged", "paged"]
        ring = cache["layers"][1][0].value
        assert (ring["pos"] >= jcfg.n_meta_tokens + S - jcfg.window).all()
        pool = cache["layers"][0][0].value["k_pages"]
        assert pool.shape[1] == -(-(MAX_SEQ + jcfg.n_meta_tokens)
                                  // jcfg.kv_page_size)
    else:
        kinds = [t.kind for t in cache["layers"]]
        assert kinds == ["mlstm", "mlstm", "slstm"]


@functools.lru_cache(maxsize=None)
def _mamba_reference(chunk):
    jcfg = jax_smoke("hymba_1_5b")

    @jax.jit
    def run(p, x, xs):
        y, st = JH.mamba_apply(jcfg, p, x, chunk=chunk)
        y1, st1 = JH.mamba_apply(jcfg, p, xs, conv_state=st[0],
                                 ssm_state=st[1])
        return y, st, y1, st1
    return run


def test_mamba_apply_matches_jax():
    """Prefill of 10 steps at chunk 4 (two identity steps pad the last
    chunk), then one decode step from the carried conv and SSM state."""
    jcfg, tcfg, params, model, _ = _setup("hymba_1_5b")
    p = jax.tree_util.tree_map(lambda a: np.asarray(a)[1],
                               params["blocks"]["mamba"])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 10, jcfg.d_model)).astype(np.float32)
    xs = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    y, st, y1, st1 = _mamba_reference(4)(p, jnp.asarray(x),
                                             jnp.asarray(xs))
    mp = model.blocks[1].mamba
    ty, tst = H.mamba_apply(tcfg, mp, _t(x), chunk=4)
    _close(ty, y)
    _close(tst[0], st[0])
    _close(tst[1], st[1])
    ty1, tst1 = H.mamba_apply(tcfg, mp, _t(xs), conv_state=tst[0],
                              ssm_state=tst[1])
    _close(ty1, y1)
    _close(tst1[0], st1[0])
    _close(tst1[1], st1[1])
    assert float(np.abs(np.asarray(st[1])).max()) > 1e-3   # a real carry
    # the padded scan against one plain recurrence step by step
    a = torch.rand((1, 10, 3, 2)) * 0.5 + 0.5
    b = torch.randn((1, 10, 3, 2))
    h0 = torch.randn((1, 3, 2))
    hs, last = H.ssm_scan_chunked(a, b, h0, 4)
    h = h0
    for t in range(10):
        h = a[:, t] * h + b[:, t]
        torch.testing.assert_close(hs[:, t], h, **TOL)
    torch.testing.assert_close(last, h, **TOL)


@functools.lru_cache(maxsize=None)
def _mlstm_reference(chunk):
    @jax.jit
    def run(q, k, v, il, gl, state):
        return (JX.mlstm_chunkwise(q, k, v, il, gl, chunk=chunk),
                JX.mlstm_chunkwise(q, k, v, il, gl, chunk=chunk,
                                   state=state))
    return run


@pytest.mark.parametrize("chunk", [4, 8])
def test_mlstm_chunkwise_matches_jax(chunk):
    """S 16 at chunk 4 and 8, from the zero state and from a carried one
    (the state of a first run over 16 other steps)."""
    rng = np.random.default_rng(chunk)
    Bq, Hh, Sq, d = 2, 2, 16, 8

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def inputs():
        return (f(Bq, Hh, Sq, d) / np.sqrt(d), f(Bq, Hh, Sq, d),
                f(Bq, Hh, Sq, d), f(Bq, Hh, Sq),
                np.asarray(jax.nn.log_sigmoid(f(Bq, Hh, Sq) + 2.0)))

    _, carried = X.mlstm_chunkwise(*map(_t, inputs()), chunk=chunk)
    q, k, v, il, gl = inputs()
    state = tuple(c.numpy() for c in carried)
    want = _mlstm_reference(chunk)(q, k, v, il, gl, state)
    for st, (jh, jst) in zip((None, carried), want):
        th, tst = X.mlstm_chunkwise(*map(_t, (q, k, v, il, gl)), chunk=chunk,
                                    state=st)
        _close(th, jh)
        for a, b in zip(tst, jst):
            _close(a, b)
    with pytest.raises(AssertionError):
        X.mlstm_chunkwise(*map(_t, (q[:, :, :10], k[:, :, :10], v[:, :, :10],
                                    il[:, :, :10], gl[:, :, :10])), chunk=4)


@functools.lru_cache(maxsize=None)
def _slstm_reference():
    jcfg = jax_smoke("xlstm_1_3b")

    @jax.jit
    def run(p, x, xs, state):
        return (JX.slstm_block(jcfg, p, x),
                JX.slstm_block_step(jcfg, p, xs, state))
    return run


def test_slstm_matches_jax():
    """slstm_block over 9 steps and slstm_block_step from a random
    state."""
    jcfg, tcfg, params, model, _ = _setup("xlstm_1_3b")
    assert [X._is_slstm(tcfg, i) for i in range(tcfg.n_layers)] == \
        [False, False, True]
    p = jax.tree_util.tree_map(np.asarray, params["blocks"][2])
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 9, jcfg.d_model)).astype(np.float32)
    xs = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    inner = int(jcfg.proj_factor * jcfg.d_model)
    state = tuple(rng.standard_normal((B, inner)).astype(np.float32)
                  for _ in range(4))
    state = state[:2] + (np.abs(state[2]) + 0.5, state[3])
    y, (y1, st1) = _slstm_reference()(p, x, xs, state)
    bp = model.blocks[2]
    assert isinstance(bp, X.SLSTMBlock)
    _close(X.slstm_block(tcfg, bp, _t(x)), y)
    ty1, tst1 = X.slstm_block_step(tcfg, bp, _t(xs), tuple(map(_t, state)))
    _close(ty1, y1)
    for a, b in zip(tst1, st1):
        _close(a, b)


@pytest.mark.parametrize("name", FAMILIES)
def test_init_random_constants(name):
    """The port's init gives the reference's constants: dt_bias -4,
    a_log log(1..N) on every row, d_skip and the norm scales 1; and
    draws its random tensors at the reference's scales."""
    _, tcfg, params, _, _ = _setup(name)
    m = build_model(tcfg, "cpu").init(3)
    if tcfg.family == "hybrid":
        for i, bp in enumerate(m.blocks):
            for k in ("dt_bias", "a_log", "d_skip"):
                np.testing.assert_array_equal(
                    getattr(bp.mamba, k).numpy(),
                    np.asarray(params["blocks"]["mamba"][k][i]))
            for k in ("n_attn", "n_ssm"):
                np.testing.assert_array_equal(
                    getattr(bp, k).numpy(), np.asarray(params["blocks"][k][i]))
            assert abs(float(bp.mamba.w_dt.std()) - 0.01) < 0.002
            assert abs(float(bp.mamba.conv.std()) - 0.5) < 0.1
        assert abs(float(m.meta.std()) - 0.02) < 0.005
    else:
        for bp, jp in zip(m.blocks, params["blocks"]):
            np.testing.assert_array_equal(bp.ln.scale.numpy(),
                                          np.asarray(jp["ln"]["scale"]))
            if isinstance(bp, X.MLSTMBlock):
                np.testing.assert_array_equal(bp.hn.numpy(),
                                              np.asarray(jp["hn"]))
                assert abs(float(bp.wq.std()) - 0.5) < 0.1
            else:
                hd = bp.r.shape[-1]
                assert abs(float(bp.r.std()) * hd ** 0.5 - 1.0) < 0.2
    np.testing.assert_array_equal(m.ln_f.scale.numpy(),
                                  np.asarray(params["ln_f"]["scale"]))


@pytest.mark.parametrize("name", FAMILIES)
def test_params_round_trip(name):
    """params_to_numpy inverts params_from_numpy bit for bit, hymba's
    stacked blocks and xLSTM's tuple of per-layer blocks alike."""
    _, tcfg, params, model, _ = _setup(name)
    back = params_to_numpy(model)
    want = jax.tree_util.tree_map(np.asarray, params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    again = params_to_numpy(params_from_numpy(tcfg, back, "cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(again),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["hymba-1.5b", "xlstm-1.3b"])
def test_count_params_full_config(name):
    """The full configs' parameter counts equal the reference's, from
    ``jax.eval_shape`` of its init (no allocation on either side: the
    port's model is built on the meta device)."""
    cfg = get_config(name)
    _, cls = family_module(cfg)
    n = count_params(cls(cfg, device="meta"))
    shapes = jax.eval_shape(lambda k: jax_build(jax_get_config(name)).init(
        k)[0], jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes))
    assert n == want
    assert n > 1e9
