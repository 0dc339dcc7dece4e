"""The port's transformer families against the JAX package's, on the smoke
configs in float32: gemma3-12b and gemma3-1b with their sliding windows
(ring decode layers), olmoe and moonshot (MoE), llava (patch embeddings
prepended) and whisper (encoder, cross-attention, learned positions).  The
JAX package's ``init`` draws the parameters; ``params_from_numpy`` carries
them across.

Per family: forward logits (and the MoE aux losses), whisper's ``encode``,
and ``prefill`` of S = 12 tokens, past the smoke window of 8 (the last
decode logits and the whole decode cache).  Integer cache state (ring
``pos``, page tables, seq_lens) is exact; logits, ring and paged K/V and
``xkv`` within 1e-4 (float32 sums in another order).  ``moe_ffn`` in all
three ``moe_combine`` modes at a capacity that drops choices, and with
planted router ties, within 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as jax_smoke
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config, smoke_config
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model

from _torch_port import fast_reference_compiles  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

FAMILIES = ["gemma3_12b", "gemma3_1b", "olmoe_1b_7b", "moonshot_v1_16b_a3b",
            "llava_next_mistral_7b", "whisper_large_v3"]
S, B, MAX_SEQ = 12, 2, 32
TOL = dict(atol=1e-4, rtol=1e-4)


def _close(a, b, **tol):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), **(tol or TOL))


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(jax cfg, port cfg, jax params, port model, numpy batch)."""
    jcfg, tcfg = jax_smoke(name), smoke_config(name)
    api = jax_build(jcfg)
    params = jax.jit(lambda key: api.init(key, MAX_SEQ)[0])(
        jax.random.PRNGKey(0))
    model = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray,
                                                           params), "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)}
    if jcfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, jcfg.n_patches, jcfg.d_model)).astype(np.float32)
    if jcfg.enc_dec:
        batch["enc_frames"] = rng.standard_normal(
            (B, jcfg.enc_seq, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, params, model, batch


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's forward (with encode) and prefill, one jit."""
    jcfg, _, params, _, batch = _setup(name)
    api = jax_build(jcfg)

    @jax.jit
    def run(params, batch):
        enc = (JT.encode(jcfg, params, batch["enc_frames"])
               if jcfg.enc_dec else None)
        pb = {k: v for k, v in batch.items() if k != "patch_embeds"}
        return api.forward(params, batch), enc, JT.prefill(
            jcfg, params, pb, MAX_SEQ)

    return run(params, {k: jnp.asarray(v) for k, v in batch.items()})


def _assert_cache_close(tc, jc):
    np.testing.assert_array_equal(tc["seq_lens"].numpy(),
                                  np.asarray(jc["seq_lens"]))
    assert [t.kind for t in tc["layers"]] == [t.kind for t in jc["layers"]]
    for te, je in zip(tc["layers"], jc["layers"]):
        tv, jv = te.value, je.value
        assert sorted(tv) == sorted(jv)
        for k in tv:
            if k in ("pos", "page_table"):
                np.testing.assert_array_equal(tv[k].numpy(),
                                              np.asarray(jv[k]))
            else:
                _close(tv[k], jv[k])
    assert ("xkv" in tc) == ("xkv" in jc)
    if "xkv" in tc:
        _close(tc["xkv"], jc["xkv"])


@pytest.mark.parametrize("name", FAMILIES)
def test_family_matches_jax(name):
    """forward logits and MoE aux; encode; prefill of 12 tokens past the
    window: last logits and the whole decode cache."""
    jcfg, tcfg, _, model, batch = _setup(name)
    (jl, jaux), jenc, (jlg, jc) = _reference(name)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl, taux = T.forward(tcfg, model, tb)
    n_prefix = jcfg.n_patches if jcfg.family == "vlm" else 0
    assert tl.shape == (B, n_prefix + S, jcfg.vocab)
    _close(tl, jl)
    assert sorted(jaux) == sorted(k for k in taux if k != "dropped")
    for k in jaux:
        _close(taux[k], jaux[k])
    if jcfg.enc_dec:
        _close(T.encode(tcfg, model, tb["enc_frames"]), jenc)

    windows = tcfg.layer_windows(MAX_SEQ)
    if jcfg.window is not None:
        assert S > jcfg.window and any(w < MAX_SEQ for w in windows)
    tb.pop("patch_embeds", None)
    tlg, tc = T.prefill(tcfg, model, tb, MAX_SEQ)
    _close(tlg, jlg)
    _assert_cache_close(tc, jc)
    kinds = [t.kind for t in tc["layers"]]
    assert kinds == ["ring" if w < MAX_SEQ else "paged" for w in windows]
    for t in tc["layers"]:
        if t.kind == "ring":          # wrapped: every slot holds a live pos
            assert (t.value["pos"] >= S - jcfg.window).all()


@pytest.mark.parametrize("name", FAMILIES)
def test_params_round_trip(name):
    """params_to_numpy inverts params_from_numpy, the stacked encoder and
    the MoE experts included; a learned table keeps its length."""
    _, tcfg, params, model, _ = _setup(name)
    back = params_to_numpy(model)
    want = jax.tree_util.tree_map(np.asarray, params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    again = params_from_numpy(tcfg, back, "cpu")
    if tcfg.pos_emb == "learned":
        assert again.pos.table.shape == model.pos.table.shape


@functools.lru_cache(maxsize=None)
def _moe_reference(cf):
    """The reference's moe_ffn in the three combine modes, one jit."""
    jcfg = jax_smoke("olmoe_1b_7b")

    @jax.jit
    def run(p, x):
        return [JL.moe_ffn(jcfg.replace(moe_combine=mode), p, x,
                           capacity_factor=cf)
                for mode in ("gather", "allgather", "scatter")]
    return run


@pytest.mark.parametrize("case", ["drops", "all_tied", "pairs_tied"])
def test_moe_ffn_matches_jax(case):
    """64 tokens a sequence at a dropping capacity (factor 0.25), a zero
    router (every expert tied: the lowest-indexed K win, and their capacity
    overflows) and a router with equal column pairs, in all three combine
    modes.  The port's ``dropped`` equals the choices past capacity
    counted from the reference's routing."""
    jcfg, tcfg, params, model, _ = _setup("olmoe_1b_7b")
    p = jax.tree_util.tree_map(np.asarray, params["blocks"]["moe"])
    p = {k: v[0].copy() for k, v in p.items()}
    if case == "all_tied":
        p["router"][:] = 0
    elif case == "pairs_tied":
        p["router"][:, 1::2] = p["router"][:, ::2]
    x = np.random.default_rng(3).standard_normal(
        (3, 64, jcfg.d_model)).astype(np.float32)
    cf = 0.25 if case == "drops" else None
    want = _moe_reference(cf)(p, jnp.asarray(x))
    tp = TL.MoE(tcfg)
    with torch.no_grad():
        for k, v in p.items():
            getattr(tp, k).copy_(torch.from_numpy(v))
    # the drops the reference's routing implies: per sequence and expert,
    # the choices past the capacity C
    K, E = jcfg.top_k, jcfg.n_experts
    Sx = x.shape[1]
    C = max(8, int(np.ceil(Sx * K * (cf or jcfg.capacity_factor) / E / 8))
            * 8)
    topi = np.asarray(jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x) @ p["router"], axis=-1), K)[1])
    counts = np.stack([np.bincount(r.reshape(-1), minlength=E)
                       for r in topi])
    dropped = int(np.maximum(counts - C, 0).sum())
    assert dropped > 0 or case == "pairs_tied"
    for mode, (jy, jaux) in zip(("gather", "allgather", "scatter"), want):
        y, aux = TL.moe_ffn(tcfg.replace(moe_combine=mode), tp,
                            torch.from_numpy(x), capacity_factor=cf)
        _close(y, jy)
        for k in jaux:
            _close(aux[k], jaux[k])
        assert int(aux["dropped"]) == dropped
    if case == "all_tied":
        _, ti = TL._top_k(torch.full((2, E), 1.0 / E), K)
        assert ti.tolist() == [list(range(K))] * 2


def test_learned_positions_and_model_api():
    """A learned table has max(max_seq, 1024) rows; decoding past it
    raises rather than wrapping; build_model's init takes max_seq; the
    gemma3-12b smoke config decodes with rings at max_seq 1280."""
    _, tcfg, _, model, _ = _setup("whisper_large_v3")
    assert model.pos.table.shape[0] == 1024
    api = build_model(tcfg, "cpu")
    assert api.init(0, max_seq=2000).pos.table.shape[0] == 2000
    cache = T.init_decode_cache(tcfg, 1, 32, "cpu")
    cache["seq_lens"].fill_(1024)
    with pytest.raises(ValueError, match="learned table"):
        T.decode_step(tcfg, model, cache, torch.tensor([1]))
    gcfg = smoke_config("gemma3_12b")
    g = build_model(gcfg, "cpu")
    cache = g.init_decode_cache(2, 1280)
    assert [t.kind for t in cache["layers"]] == ["ring", "ring", "paged"]
    lg, cache = g.decode_step(g.init(0), cache, torch.tensor([1, 2]))
    assert lg.shape == (2, gcfg.vocab) and bool(torch.isfinite(lg).all())
    assert get_config("gemma3-1b").window == 512
