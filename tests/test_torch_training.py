"""The port's training path against the JAX package's, on the CPU in f32.

* Every family's ``loss_fn`` and every parameter's gradient against
  ``jax.value_and_grad`` of the reference's ``loss_fn``, one smoke config
  per family (``dtype="float32"``): gemma3-1b (sliding windows, tied
  embeddings, qk-norm), olmoe-1b-7b (the MoE aux terms), llava (the patch
  prefix cut), whisper (the encoder's gradients through non-causal flash),
  hymba-1.5b at 4 layers (so one layer is windowed) and xlstm-1.3b.  The
  port runs flash through its autograd function, whose CPU backward is
  ``flash_attention_bwd_ref``; the reference autodiffs its dense
  ``flash_attention_ref`` at these sizes.  The loss within 1e-5 relative;
  each gradient within ``GRAD_TOL`` of the reference's largest element of
  that leaf (both f32, summed in other orders).
* ``adamw_update`` fed the same numpy gradients and moments, the decay
  mask taken on the reference's layout (norm scales inside stacked blocks
  decayed, ``ln_f`` and xLSTM's per-layer norms not), ``cosine_schedule``,
  ``global_norm`` and ``quantize_int8``, and the port's versions of
  ``tests/test_training.py``'s optimizer cases.

The train step's cases are in ``test_torch_train_step.py``.

Weights and moments cross through ``repro_torch.interop``; inputs come from
numpy seeds.  Each family's reference ``value_and_grad`` compiles once and
is shared by its cases.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as jax_smoke
from repro.models.model import build_model as jax_build
from repro.training import optimizer as jopt
from repro_torch import interop
from repro_torch.configs import smoke_config
from repro_torch.models.model import build_model
from repro_torch.training import optimizer as opt

from _torch_port import fast_reference_compiles  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

FAMILIES = ["gemma3_1b", "olmoe_1b_7b", "llava_next_mistral_7b",
            "whisper_large_v3", "hymba_1_5b", "xlstm_1_3b"]
DEPTH = {"hymba_1_5b": dict(n_layers=4)}  # global {0, 2, 3}: layer 1 windowed
B, S, MAX_SEQ = 2, 12, 32       # S past the smoke window of 8
# A gradient element against the reference's: f32 on both sides, summed in
# other orders (chunked logits, the flash backward's blocks, the MoE
# scatter), through a few layers; held to 1e-4 of the leaf's largest
# magnitude (and 1e-4 relative).
GRAD_TOL = 1e-4


def _jax_cfg(name):
    return jax_smoke(name).replace(**DEPTH.get(name, {}))


def _port_cfg(name):
    return smoke_config(name).replace(**DEPTH.get(name, {}))


def _batch(cfg, rng, b=B):
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        batch["enc_frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(port cfg, the parameters in the reference's layout as numpy, numpy
    batch).  The port draws the weights (the reference's own init would
    add a compile a family; ``tests/test_torch_families.py`` and
    ``tests/test_torch_recurrent.py`` carry the reference's weights across
    the other way)."""
    cfg = _port_cfg(name)
    model = build_model(cfg, "cpu").init(0, MAX_SEQ)
    return (cfg, interop.params_to_numpy(model),
            _batch(cfg, np.random.default_rng(1)))


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(name):
    _, params, batch = _setup(name)
    api = jax_build(_jax_cfg(name))
    vg = jax.jit(jax.value_and_grad(api.loss, has_aux=True))
    (loss, metrics), grads = vg(params, batch)
    return (float(loss), jax.tree_util.tree_map(np.asarray, metrics),
            jax.tree_util.tree_map(np.asarray, grads))


def _port_model(name):
    cfg, params, _ = _setup(name)
    model = interop.params_from_numpy(cfg, params, "cpu")
    return cfg, model.requires_grad_(True)


def _assert_tree_close(got: dict, want: dict, tol, path=()):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _assert_tree_close(got[k], want[k], tol, path + (k,))
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_close(g, w, tol, path + (i,))
    else:
        w = np.asarray(want)
        np.testing.assert_allclose(
            np.asarray(got), w, rtol=tol,
            atol=tol * max(float(np.abs(w).max()), 1e-30),
            err_msg="/".join(map(str, path)))


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_match_jax(name):
    want_loss, want_metrics, want_grads = _reference_loss_and_grads(name)
    cfg, model = _port_model(name)
    api = build_model(cfg, "cpu")
    loss, metrics = api.loss(model, _torch_batch(_setup(name)[2]))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    assert set(metrics) == set(want_metrics)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v),
                                   rtol=1e-5,
                                   err_msg=k)
    got = interop.named_to_numpy(model, dict(zip(names, grads)))
    _assert_tree_close(got, want_grads, GRAD_TOL)


def test_loss_chunks_and_pads_like_a_whole_sequence():
    """lm_loss_from_hidden over chunks of 5 with a padded tail equals the
    unchunked cross_entropy of the same logits, in value and gradient."""
    from repro_torch.models import layers as L

    cfg, model = _port_model("gemma3_1b")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 13, cfg.d_model)).astype(
        np.float32)).requires_grad_(True)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 13)))
    mask = torch.from_numpy((rng.random((2, 13)) < 0.8).astype(np.float32))
    a = L.lm_loss_from_hidden(cfg, model.head, model.embed, x, labels, mask,
                              chunk=5)
    b = L.cross_entropy(L.logits_head(cfg, model.head, model.embed, x),
                        labels, mask)
    ga, gb = (torch.autograd.grad(t, x)[0] for t in (a, b))
    torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    torch.testing.assert_close(ga, gb, rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------ optimizer ----
def _random_like(tree, rng, positive=False):
    def one(a):
        x = rng.standard_normal(np.shape(a)).astype(np.float32)
        return np.abs(x) * 1e-2 if positive else x * 1e-2
    return jax.tree_util.tree_map(one, tree)


@pytest.mark.parametrize("name", ["gemma3_1b", "xlstm_1_3b"])
def test_adamw_update_matches_jax(name):
    """Two AdamW steps from the same parameters, moments and gradients
    (weight decay 0.1, clipping active): parameters, moments and metrics
    within 1e-6 (f32 elementwise arithmetic; XLA may fuse a multiply-add)."""
    cfg, params, _ = _setup(name)
    rng = np.random.default_rng(3)
    acfg = opt.AdamWConfig(lr=1e-2, warmup=1, total_steps=10, clip_norm=0.5)
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup=1, total_steps=10, clip_norm=0.5)
    jstate = {"step": np.asarray(3, np.int32),
              "mu": _random_like(params, rng),
              "nu": _random_like(params, rng, positive=True)}
    model = interop.params_from_numpy(cfg, params, "cpu")
    tstate = interop.opt_state_from_numpy(model, jstate, "cpu")
    upd = jax.jit(lambda g, s, p: jopt.adamw_update(g, s, p, jcfg))
    jparams = params
    for _ in range(2):
        g = _random_like(params, rng)
        jparams, jstate, jm = upd(g, jstate, jparams)
        model, tstate, tm = opt.adamw_update(
            interop.named_from_numpy(model, g, "cpu"), tstate, model, acfg)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    got = interop.opt_state_to_numpy(model, tstate)
    assert int(got["step"]) == int(jstate["step"]) == 5
    for k in ("mu", "nu"):
        _assert_tree_close(got[k], jstate[k], 1e-6)
    _assert_tree_close(interop.params_to_numpy(model), jparams, 1e-6)


@pytest.mark.parametrize("name", ["gemma3_1b", "hymba_1_5b", "xlstm_1_3b"])
def test_decay_mask_is_the_reference_layouts(name):
    """ndim >= 2 on the reference's leaves: stacked blocks' norm scales are
    decayed (a (layers, D) leaf there), ``ln_f`` is not, and neither are
    xLSTM's per-layer 1-D leaves."""
    cfg, params, _ = _setup(name)
    model = interop.params_from_numpy(cfg, params, "cpu")
    mask = opt.decay_mask(model)
    full = jax.tree_util.tree_map(
        lambda p, m: np.full(np.shape(p), float(m), np.float32), params,
        jopt._decay_mask(params))
    want = interop.named_from_numpy(model, full, "cpu")
    assert mask == {n: bool(t.flatten()[0]) for n, t in want.items()}
    if name != "xlstm_1_3b":
        assert mask["blocks.0.ln1.scale"] and not mask["ln_f.scale"]
    else:
        assert not mask["blocks.0.ln.scale"]
    assert mask["embed.table"]


def test_schedule_norm_and_int8_match_jax():
    lr = opt.cosine_schedule(3e-3, 10, 100)
    jlr = jopt.cosine_schedule(3e-3, 10, 100)
    steps = np.array([0, 1, 5, 10, 11, 50, 99, 100, 150], np.int32)
    np.testing.assert_allclose(lr(torch.from_numpy(steps)).numpy(),
                               np.asarray(jlr(jnp.asarray(steps))),
                               rtol=1e-6)
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((3, 4), (7,), (2, 2, 2))]
    np.testing.assert_allclose(
        float(opt.global_norm(torch.from_numpy(x) for x in xs)),
        float(jopt.global_norm([jnp.asarray(x) for x in xs])), rtol=1e-6)
    x = rng.standard_normal(300).astype(np.float32) * 3
    x[17] = 0.5 * float(np.abs(x).max()) / 127 * 3     # a rounding tie
    q, s = opt.quantize_int8(torch.from_numpy(x))
    jq, js = jopt.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


class _Toy(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(w), requires_grad=False)


def test_adamw_reduces_quadratic():
    w = _Toy([3.0, -2.0, 5.0])
    acfg = opt.AdamWConfig(lr=0.1, warmup=0, total_steps=200,
                           weight_decay=0.0, clip_norm=10.0)
    state = opt.adamw_init(w, acfg)
    lr_fn = opt.cosine_schedule(acfg.lr, 0, 200)
    for _ in range(150):
        w, state, _ = opt.adamw_update({"w": 2 * w.w}, state, w, acfg, lr_fn)
    assert float(w.w.abs().max()) < 0.2


def test_grad_clip_applies():
    w = _Toy([1.0] * 4)
    acfg = opt.AdamWConfig(lr=1.0, warmup=0, total_steps=10, clip_norm=1.0)
    state = opt.adamw_init(w, acfg)
    _, _, m = opt.adamw_update({"w": torch.full((4,), 100.0)}, state, w, acfg)
    assert float(m["grad_norm"]) == pytest.approx(200.0, rel=1e-5)
