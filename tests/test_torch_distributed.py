"""The port's mesh paths against the JAX package, in one gloo group of 8
ranks on the CPU: the mesh train step (dense and MoE, tensor-parallel
along ``model``: qwen2.5-14b, gemma3 and olmoe against the reference's
whole-batch step, each rank holding only its ``model`` shards), the
tensor-parallel forward, prefill and decode, the pod-compressed step,
``pod_compressed_mean``, checkpoints resharded and written by the JAX
package, shard-local flash-decoding, GPipe and ``launch/train --mesh``.
Everything runs once (``_torch_port.dist_main``, a module fixture); each
test below reads its part of what the ranks found and compares it with the
JAX package or the port's plain path in this process.  The spec tables,
which need no process, are in ``test_torch_sharding.py``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import smoke_config as jax_smoke
from repro.distributed import sharding as jshd
from repro.kernels import ref as jref
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training.train_loop import make_train_step as jax_train_step
from repro.training.train_loop import state_shardings as jstate_shardings
from repro_torch import interop
from repro_torch.configs import smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import make_train_step

import _torch_port
from _torch_port import (  # noqa: F401
    fast_reference_compiles, flash_decode_inputs, ref_node, reference_axes)

jax.config.update("jax_platform_name", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_TOL = dict(atol=2e-3, rtol=2e-3)      # the reference's mesh-step check
LOSS_TOL = 1e-3
DECODE_TOL = dict(atol=3e-5, rtol=3e-5)    # tests/test_distributed.py's
GPIPE_TOL = dict(atol=2e-5, rtol=2e-5)
# The steps start from adamw_init's zero moments, so each element's update
# is the gradient's own (about lr times its sign at the first step).  Each
# rank's local update of each parameter (after minus before) is held to
# UPDATE_TOL of the plain step's update over the slice of that rank's
# coordinate, in relative norm: a skipped update is 1 off, another
# coordinate's slice about 1.4.  The largest error of a sound run was
# 1.4e-6 (mesh step) and 3.7e-6 (pod step).  The key biases are left out
# (STEP_TOL still holds them): a bias added to every key of a query shifts
# its scores alike, so the loss does not depend on it, its gradient is
# rounding noise and Adam's update of it that noise's sign (7.7e-5 off in
# a sound run).
UPDATE_TOL = 1e-4
NOISE_LEAVES = ("attn.wk.b",)
# The MoE step's update of each parameter after two steps against the
# reference's whole-batch step, in relative norm: a sound run's largest was
# 1.5e-4 (blocks.1.attn.wq.w; the packages sum the expert scatter in other
# orders); a step that averaged the slices' load statistics, or did not
# scale their gradient back to the whole batch's, was 1.8e-3 to 0.29 off
# on several leaves.
MOE_UPDATE_TOL = 5e-4
# The tensor-parallel steps (qwen2.5-14b, gemma3, olmoe on (2, 4)) against
# the reference's whole-batch step after two steps: each rank's update of
# each shard within STEP_TOL and, in relative norm, within the case's
# tolerance (the NOISE_LEAVES left out).  A sound run's largest: qwen
# 1.6e-5, gemma3 7.5e-5; olmoe 6.1e-4 (one shard of blocks.1.attn.wq.w;
# the same step with its compute replicated along model, as before
# tensor parallelism, gave 4.3e-4 there: the packages' expert choices
# differ where the router's probabilities nearly tie).  A step that got
# the router's statistics wrong was 1.8e-3 to 0.29 off (MOE_UPDATE_TOL).
TP_CASES = {"mesh_step": ("qwen2.5-14b", {}, 5e-4),
            "tp_gemma3": ("gemma3-12b",
                          {"logit_softcap": _torch_port.TP_SOFTCAP}, 5e-4),
            "moe_step": ("olmoe-1b-7b", {}, 1e-3)}


POD_SHAPES = {"a": (64, 32), "b": (7,), "c": (3, 5, 2)}
LAUNCH_ARGV = ["--arch", "qwen2.5-14b", "--smoke", "--device", "cpu",
               "--steps", "3", "--seq", "16", "--batch", "4"]


def _inputs(work) -> dict:
    """What the ranks read: the batches, the attention and GPipe inputs,
    each pod's gradient and residual, a checkpoint the JAX package wrote
    and the corpus for ``launch/train``."""
    from repro_torch.data import synth_corpus

    rng = np.random.default_rng(1)
    inp = dict(flash_decode_inputs())
    inp["tokens"] = rng.integers(0, 256, (4, 16)).astype(np.int32)
    inp["prompt"] = rng.integers(0, 256, (2, 24)).astype(np.int32)
    inp["tp_plain"] = _torch_port.tp_plain_runs(inp["prompt"], inp["tokens"])
    inp["ws"] = (rng.standard_normal((4, 32, 32)) / np.sqrt(32)).astype(
        np.float32)
    inp["x"] = rng.standard_normal((16, 32)).astype(np.float32)
    inp["pod_g"] = {k: rng.standard_normal((2,) + s).astype(np.float32)
                    for k, s in POD_SHAPES.items()}
    inp["pod_e"] = {k: (rng.standard_normal((2,) + s) * 0.01).astype(
        np.float32) for k, s in POD_SHAPES.items()}
    # gemma3-1b's smoke state in the reference's tree (random values of its
    # shapes; the moments made from them), written by the JAX package
    shapes, _ = reference_axes("gemma3_1b")
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    jstate = {"params": params, "opt": {
        "step": np.asarray(5, np.int32),
        "mu": jax.tree_util.tree_map(lambda a: a * 0.5, params),
        "nu": jax.tree_util.tree_map(np.square, params)}}
    jckpt.save_checkpoint(str(work / "jax_ckpt"), 5, jstate)
    inp["jax_ckpt"] = str(work / "jax_ckpt")
    inp["jax_state"] = jstate
    inp["launch_argv"] = LAUNCH_ARGV
    (work / "launch").mkdir()
    synth_corpus(work / "launch" / "corpus.bin", n_tokens=5_000, vocab=256)
    return inp


def run_ranks(work, inp, group):
    """Every rank's results of ``_torch_port.DIST_GROUPS[group]`` (one
    gloo group of 8 ranks, one thread each), the ranks reading ``inp``
    (saved under ``work``)."""
    torch.save({k: v for k, v in inp.items() if k != "jax_state"},
               work / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(REPO, "src"), os.path.join(REPO, "tests")]))
    r = subprocess.run(
        [sys.executable, "-c",
         f"import _torch_port; _torch_port.dist_main({str(work)!r}, "
         f"{group!r})"],
        capture_output=True, text=True, env=env, cwd=REPO,
        timeout=_torch_port.DIST_TIMEOUT_S + 60)
    assert r.returncode == 0, f"{r.stdout[-2000:]}\n{r.stderr[-6000:]}"
    return [torch.load(work / f"rank{k}.pt", weights_only=False)
            for k in range(_torch_port.DIST_WORLD)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of the ``mesh`` group's checks and the inputs
    they read."""
    work = tmp_path_factory.mktemp("dist")
    inp = _inputs(work)
    return run_ranks(work, inp, "mesh"), inp, work


def _plain_run(cfg, acfg, tokens, steps):
    """The port's plain step (held against the JAX package by
    ``test_torch_training.py``) from the ranks' seed and zero moments."""
    api, state, _ = _torch_port._dist_state(cfg, 0, acfg)
    step = make_train_step(cfg, api, adamw=acfg)
    metrics = []
    for _ in range(steps):
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _initial_params(cfg) -> dict:
    model = _torch_port._dist_state(cfg, 0, opt.AdamWConfig())[1]["params"]
    return {n: p.detach().numpy().astype(np.float64)
            for n, p in model.named_parameters()}


def _check_local_updates(out, key, want, shape, names):
    """Every rank's local update of every parameter in ``out[r][key]``
    against the slice of ``want`` (full updates, f64) at its coordinate,
    in relative norm (the NOISE_LEAVES left out)."""
    cfg = smoke_config("qwen2.5-14b")
    axes = interop.param_axes(build_model(cfg, "cpu").init(0, 16))
    jmesh = AbstractMesh(shape, names)
    for o in out:
        r = o[key]
        for n, w in want.items():
            if n.endswith(NOISE_LEAVES):
                continue
            spec = tuple(jshd._spec_for_shape(axes[n], w.shape, jmesh,
                                              jshd.current_rules()))
            w = _slice(w, spec, r["coord"], shape, names)
            got = r["update"][n]
            assert got.shape == w.shape, (n, got.shape, w.shape)
            err = np.linalg.norm(got - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= UPDATE_TOL, (r["coord"], n, err)


def test_mesh_train_step_matches_plain_step(ranks):
    """Two steps on (2, 4) data/model against the plain step: losses and
    gradient norms within 1e-3, parameters and moments within 2e-3 (the
    reference's limits); every rank agrees, holds its 1/8, 1/2 or 1/4 of
    each weight (ZeRO over data, heads over model), and its shard's update
    is the plain update's slice at its coordinate within UPDATE_TOL."""
    out, inp, _ = ranks
    cfg = smoke_config("qwen2.5-14b")
    acfg = opt.AdamWConfig(lr=1e-3, warmup=1, total_steps=10)
    before = _initial_params(cfg)
    state, metrics = _plain_run(cfg, acfg, inp["tokens"], 2)
    got = out[0]["mesh_step"]
    for a, b in zip(got["metrics"], metrics):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(a[k] - b[k]) <= LOSS_TOL * max(1.0, abs(b[k])), k
    assert all(o["mesh_step"]["metrics"] == got["metrics"] for o in out)
    want = {}
    for n, p in state["params"].named_parameters():
        p = p.detach().numpy()
        np.testing.assert_allclose(got["params"][n], p, err_msg=n,
                                   **STEP_TOL)
        np.testing.assert_allclose(got["mu"][n],
                                   state["opt"]["mu"][n].numpy(),
                                   err_msg=n, **STEP_TOL)
        want[n] = p.astype(np.float64) - before[n]
    _check_local_updates(out, "mesh_step", want, (2, 4), ("data", "model"))
    wq = got["update"]["blocks.0.attn.wq.w"]
    assert wq.shape == (cfg.d_model // 2, cfg.n_heads * cfg.hd // 4)


def test_moe_mesh_step_matches_whole_batch_reference(ranks):
    """olmoe-1b-7b's smoke config, two steps on (2, 4) with the batch split
    over data 2, against the reference's ``make_train_step`` on the whole
    batch from the same weights: the loss, ``nll``, ``load_balance``,
    ``router_z`` and the gradient norm within 1e-3 (the router's load
    statistics are the whole batch's, not a mean of the slices'), the
    parameters within 2e-3 and each one's update within MOE_UPDATE_TOL of
    the reference's in relative norm; every rank the same metrics."""
    out, inp, _ = ranks
    cfg = smoke_config("olmoe-1b-7b")
    kw = dict(lr=1e-3, warmup=1, total_steps=10)
    model = _torch_port._dist_state(cfg, 0, opt.AdamWConfig(**kw))[1][
        "params"]
    params = interop.params_to_numpy(model)
    jstep = jax.jit(jax_train_step(jax_smoke("olmoe_1b_7b"),
                                   adamw=jopt.AdamWConfig(**kw)))
    jstate = {"params": params,
              "opt": jopt.adamw_init(params, jopt.AdamWConfig(**kw))}
    got = out[0]["moe_step"]
    assert all(o["moe_step"]["metrics"] == got["metrics"] for o in out)
    for m in got["metrics"]:
        jstate, jm = jstep(jstate, {"tokens": inp["tokens"]})
        for k in ("loss", "nll", "load_balance", "router_z", "grad_norm"):
            want = float(jm[k])
            assert abs(m[k] - want) <= LOSS_TOL * max(1.0, abs(want)), \
                (k, m[k], want)
    before = _initial_params(cfg)
    ref = interop.params_from_numpy(cfg, jax.tree_util.tree_map(
        np.asarray, jstate["params"]), "cpu")
    for n, p in ref.named_parameters():
        p = p.detach().numpy()
        np.testing.assert_allclose(got["params"][n], p, err_msg=n,
                                   **STEP_TOL)
        want = p.astype(np.float64) - before[n]
        err = np.linalg.norm(got["params"][n] - p) / np.linalg.norm(want)
        assert err <= MOE_UPDATE_TOL, (n, err)


def _pod_mean_ref(g, e):
    """The reference's ``pod_compressed_mean`` over a stacked pod axis."""
    return jax.jit(jax.vmap(lambda g, e: jopt.pod_compressed_mean(
        g, e, "pod"), axis_name="pod"))(g, e)


def test_pod_compressed_step(ranks):
    """One pod-compressed step on (2, 2, 2): the loss the mean of the two
    pods' losses, the gradients the reference's ``pod_compressed_mean`` of
    each pod's gradient (held with ``jax.vmap``), then AdamW; every rank's
    shard's update the slice of that emulation's within UPDATE_TOL; each
    pod keeps its own residual, within scale / 2 of zero and equal to the
    emulation's."""
    out, inp, _ = ranks
    cfg = smoke_config("qwen2.5-14b")
    acfg = opt.AdamWConfig(lr=1e-3, warmup=1, total_steps=10)
    api, _, _ = _torch_port._dist_state(cfg, 0, acfg)
    before = _initial_params(cfg)
    grads, losses = [], []
    for p in range(2):
        model = _torch_port._dist_state(cfg, 0, acfg)[1]["params"]
        tok = torch.from_numpy(inp["tokens"][2 * p:2 * p + 2])
        loss, _ = api.loss(model, {"tokens": tok})
        names, params = zip(*model.named_parameters())
        grads.append(dict(zip(names, (g.numpy() for g in
                                      torch.autograd.grad(loss, params)))))
        losses.append(float(loss.detach()))
    stack = {n: np.stack([g[n] for g in grads]) for n in grads[0]}
    zeros = {n: np.zeros_like(v) for n, v in stack.items()}
    mean, ef = _pod_mean_ref(stack, zeros)
    _, state, _ = _torch_port._dist_state(cfg, 0, acfg)
    opt.adamw_update({n: torch.from_numpy(np.array(v[0]))
                      for n, v in mean.items()}, state["opt"],
                     state["params"], acfg)
    for o in out:
        assert abs(o["pod_step"]["metrics"]["loss"] - np.mean(losses)) \
            <= LOSS_TOL
    want = {n: p.detach().numpy().astype(np.float64) - before[n]
            for n, p in state["params"].named_parameters()}
    _check_local_updates(out, "pod_step", want, (2, 2, 2),
                         ("pod", "data", "model"))
    firsts = [o["pod_step"] for o in out if "ef" in o["pod_step"]]
    assert sorted(f["pod"] for f in firsts) == [0, 0, 1, 1]
    for f in firsts:
        for n, p in state["params"].named_parameters():
            np.testing.assert_allclose(f["params"][n], p.detach().numpy(),
                                       err_msg=n, **STEP_TOL)
            want = np.asarray(ef[n][f["pod"]])
            scale = np.abs(stack[n]).max() / 127
            assert np.abs(f["ef"][n]).max() <= scale / 2 * (1 + 1e-3)
            close = np.abs(f["ef"][n] - want) <= 1e-3 * scale
            assert close.mean() >= 0.999, (n, close.mean())
    assert not np.array_equal(firsts[0]["ef"]["embed.table"],
                              next(f for f in firsts if f["pod"] == 1)
                              ["ef"]["embed.table"])


def _local_shape(shape, spec):
    """A weight's shape in a (2, 4) data/model mesh step's work copy:
    whole over data, a quarter over model."""
    return tuple(d // 4 if r == "model" else d for d, r in zip(shape, spec))


def check_tp_step(ranks, check, arch, kw, tol):
    """``check``'s two tensor-parallel steps of ``arch``'s smoke config
    (``kw`` over it) on (2, 4) data/model from zero moments against the
    reference's ``make_train_step`` on the whole batch from the same
    weights: the loss and the gradient norm within STEP_TOL, every rank's
    update of every shard within STEP_TOL of the reference's at its
    coordinate and within ``tol`` in relative norm (the NOISE_LEAVES left
    out); each rank's work copy holds every ``model``-split weight as its
    quarter (whole over data) and no tensor of the steps is as large as
    the largest such weight whole (but for those of the shape of a
    parameter every rank holds whole)."""
    out, inp, _ = ranks
    cfg = smoke_config(arch).replace(**kw)
    jcfg = jax_smoke(arch.replace("-", "_").replace(".", "_")).replace(**kw)
    akw = dict(lr=1e-3, warmup=1, total_steps=10)
    model = _torch_port._dist_state(cfg, 0, opt.AdamWConfig(**akw))[1][
        "params"]
    params = interop.params_to_numpy(model)
    jstep = jax.jit(jax_train_step(jcfg, adamw=jopt.AdamWConfig(**akw)))
    jstate = {"params": params,
              "opt": jopt.adamw_init(params, jopt.AdamWConfig(**akw))}
    got = out[0][check]
    assert all(o[check]["metrics"] == got["metrics"] for o in out)
    for m in got["metrics"]:
        jstate, jm = jstep(jstate, {"tokens": inp["tokens"]})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[k], float(jm[k]), err_msg=k,
                                       **STEP_TOL)
    before = _initial_params(cfg)
    ref = interop.params_from_numpy(cfg, jax.tree_util.tree_map(
        np.asarray, jstate["params"]), "cpu")
    axes = interop.param_axes(model)
    jmesh = AbstractMesh((2, 4), ("data", "model"))
    largest = 0
    for n, p in ref.named_parameters():
        w = p.detach().numpy().astype(np.float64) - before[n]
        spec = tuple(jshd._spec_for_shape(axes[n], w.shape, jmesh,
                                          jshd.current_rules()))
        if "model" in spec:
            largest = max(largest, w.size)
        for o in out:
            r = o[check]
            assert r["work_shapes"][n] == _local_shape(w.shape, spec), n
            want = _slice(w, spec, r["coord"], (2, 4), ("data", "model"))
            np.testing.assert_allclose(r["update"][n], want, err_msg=n,
                                       **STEP_TOL)
            if n.endswith(NOISE_LEAVES):
                continue
            err = np.linalg.norm(r["update"][n] - want) / max(
                np.linalg.norm(want), 1e-30)
            assert err <= tol, (r["coord"], n, err)
    assert all(0 < o[check]["largest"] < largest for o in out), \
        ([o[check]["largest"] for o in out], largest)


@pytest.mark.parametrize("check", list(TP_CASES))
def test_tp_step_matches_reference(ranks, check):
    """Two tensor-parallel steps on (2, 4) data/model against the
    reference's whole-batch step (:func:`check_tp_step`): qwen2.5-14b (q
    heads divide over model 4, its kv heads' columns do not: gathered),
    gemma3 (window layers, softcap, a tied vocab-parallel table) and
    olmoe (experts over model, the router's statistics over data)."""
    check_tp_step(ranks, check, *TP_CASES[check])


def check_tp_decode(out, plain, configs):
    """Every rank's ``_torch_port._tp_decode_runs`` of ``configs`` against
    the plain path's (``plain``, from ``_torch_port.tp_plain_runs``):
    ``forward(last_only=True)``'s logits, the prompt's and the decode
    steps' within DECODE_TOL; each rank's copy holds each ``model``-split
    weight as its quarter, and some weight is split."""
    for key, (arch, kw) in configs.items():
        model = build_model(smoke_config(arch).replace(**kw), "cpu").init(0)
        axes = interop.param_axes(model)
        jmesh = AbstractMesh((2, 4), ("data", "model"))
        n_split = 0
        for r in out:
            r = r[key]
            np.testing.assert_allclose(r["forward"], plain[key]["forward"],
                                       **DECODE_TOL)
            assert len(r["steps"]) == 1 + _torch_port.TP_DECODE_STEPS
            for a, b in zip(r["steps"], plain[key]["steps"]):
                np.testing.assert_allclose(a, b, **DECODE_TOL)
            for n, p in model.named_parameters():
                spec = tuple(jshd._spec_for_shape(
                    axes[n], p.shape, jmesh, jshd.current_rules()))
                assert r["work_shapes"][n] == _local_shape(p.shape, spec), n
                n_split += "model" in spec
        assert n_split > 0


def test_tp_prefill_and_decode_match_plain(ranks):
    """Tensor-parallel on (2, 4) from the sharded parameters' work copy,
    qwen2.5-14b's smoke model, gemma3's with ``flash_decode_shards`` (the
    pools split over model too) and qwen's with 10 over 5 heads, whose
    q heads straddle GQA groups on every rank: ``forward(last_only=True)``'s
    logits, ``prefill``'s and four decode steps' within DECODE_TOL of the
    plain path's (:func:`check_tp_decode`); the straddling config's train
    step within STEP_TOL of the plain step."""
    out, inp, _ = ranks
    plain = inp["tp_plain"]
    check_tp_decode([o["tp_decode"] for o in out], plain,
                    _torch_port.TP_CONFIGS)
    want = plain["train"]
    for o in out:
        got = o["tp_decode"]["train"]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][k],
                                       want["metrics"][k], err_msg=k,
                                       **STEP_TOL)
        for n, p in want["params"].items():
            np.testing.assert_allclose(got["params"][n], p, err_msg=n,
                                       **STEP_TOL)


def test_pod_compressed_mean_matches_reference_bit_for_bit(ranks):
    """Each pod's mean and residual equal the reference's under
    ``jax.vmap(axis_name="pod")`` bit for bit."""
    out, inp, _ = ranks
    mean, ef = _pod_mean_ref(inp["pod_g"], inp["pod_e"])
    for o in out:
        r = o["pod_mean"]
        for k in POD_SHAPES:
            np.testing.assert_array_equal(r["mean"][k],
                                          np.asarray(mean[k][r["pod"]]))
            np.testing.assert_array_equal(r["ef"][k],
                                          np.asarray(ef[k][r["pod"]]))


def _slice(a, spec, coord, mesh_shape, names):
    """numpy's slice of ``a`` that a NamedSharding of ``spec`` gives the
    device at ``coord`` of a mesh (tuple entries major to minor)."""
    for d, rule in enumerate(spec):
        axes = () if rule is None else (rule,) if isinstance(rule, str) \
            else tuple(rule)
        idx, n = 0, 1
        for ax in axes:
            i = names.index(ax)
            idx, n = idx * mesh_shape[i] + coord[i], n * mesh_shape[i]
        c = a.shape[d] // n
        a = np.take(a, range(idx * c, (idx + 1) * c), axis=d)
    return a


def test_checkpoint_saved_on_4x2_restores_on_2x2(ranks):
    """A sharded state saved from (4, 2) (rank 0 writes) and restored onto
    (2, 2) by ``elastic_restore``: the full parameters and moments
    bit-identical, each rank's shard the slice of its coordinate."""
    out, _, work = ranks
    saved = out[0]["reshard"]["saved"]
    assert (work / "ckpt42" / "LATEST").read_text() == "3"
    model = build_model(smoke_config("gemma3-1b"), "cpu").init(0, 16)
    axes = interop.param_axes(model)
    shapes = dict(model.named_parameters())
    for o in out[:4]:
        r = o["reshard"]
        assert r["step"] == 3
        for key, local in (("params", r["local"]), ("mu", r["local_mu"])):
            for n, a in saved[key].items():
                np.testing.assert_array_equal(r[key][n], a, err_msg=n)
                spec = tuple(jshd._spec_for_shape(
                    axes[n], shapes[n].shape,
                    AbstractMesh((2, 2), ("data", "model")),
                    jshd.current_rules()))
                np.testing.assert_array_equal(
                    local[n], _slice(a, spec, r["coord"], (2, 2),
                                     ("data", "model")), err_msg=n)
    assert all("local" not in o["reshard"] for o in out[4:])


def test_jax_checkpoint_restores_on_2x2(ranks):
    """A checkpoint the JAX package wrote, restored onto (2, 2): each
    rank's shard of every parameter and moment equals numpy's slice of the
    reference's spec for its coordinate."""
    out, inp, _ = ranks
    jcfg = jax_smoke("gemma3_1b")
    shapes, axes = reference_axes("gemma3_1b")
    jmesh = AbstractMesh((2, 2), ("data", "model"))
    jsh = jstate_shardings(jcfg, axes, jmesh, shapes, jopt.AdamWConfig())
    model = build_model(smoke_config("gemma3-1b"), "cpu").init(0, 16)
    paths = interop.reference_paths(model)
    full = inp["jax_state"]
    for o in out[:4]:
        r = o["jax_checkpoint"]
        assert r["step"] == 5
        for key, tree, shtree in (
                ("local", full["params"], jsh["params"]),
                ("mu", full["opt"]["mu"], jsh["opt"]["mu"]),
                ("nu", full["opt"]["nu"], jsh["opt"]["nu"])):
            for n, path in paths.items():
                a = interop._leaf(tree, path)
                spec = tuple(ref_node(shtree, path, True).spec)[1:] \
                    if path[0] in interop.STACKED \
                    else tuple(ref_node(shtree, path, True).spec)
                np.testing.assert_array_equal(
                    r[key][n], _slice(a, spec, r["coord"], (2, 2),
                                      ("data", "model")), err_msg=(key, n))


def test_sharded_flash_decode_matches_ref(ranks):
    """Flash-decoding over model 4 from pools split on the page axis
    against ``repro.kernels.ref.paged_attention_ref`` within 3e-5, the row
    with no live key 0; every rank the same; whole pools raise."""
    out, inp, _ = ranks
    want = np.asarray(jref.paged_attention_ref(
        *(jnp.asarray(inp[k]) for k in ("q", "k_pages", "v_pages",
                                        "page_table", "seq_lens"))))
    assert not np.abs(want[2]).any()
    for o in out:
        got = o["flash_decode"]["split"]
        np.testing.assert_allclose(got, want, **DECODE_TOL)
        np.testing.assert_array_equal(got, out[0]["flash_decode"]["split"])
        assert not np.abs(got[2]).any()
        assert "whole" in o["flash_decode"]["whole_raised"]


def test_decode_step_under_mesh_matches_plain_decode(ranks):
    """``prefill`` of 24 tokens of qwen's smoke model with
    ``flash_decode_shards`` under the (2, 4) mesh: the pools split 2 of 8
    pages of 8 a rank (model ranks 2 and 3 own no live page), the logits
    within 3e-5 of the plain decode's."""
    out, _, _ = ranks
    for o in out:
        r = o["decode_step"]
        np.testing.assert_allclose(r["sharded"], r["plain"], **DECODE_TOL)
        assert all(s == T.POOL_SPEC for s in r["pool_spec"])
        assert all(shape[1] == 2 for shape in r["local_pages"])


def test_gpipe_matches_sequential_stages(ranks):
    """GPipe over 4 pods with 8 microbatches against the JAX stages run in
    order."""
    out, inp, _ = ranks
    want = jnp.asarray(inp["x"])
    for s in range(4):
        want = jax.nn.tanh(want @ jnp.asarray(inp["ws"][s]))
    for o in out:
        np.testing.assert_allclose(o["gpipe"]["y"], np.asarray(want),
                                   **GPIPE_TOL)


def test_launch_train_with_a_mesh(ranks, tmp_path):
    """``launch/train --mesh 2x4`` for 3 steps: every rank's losses within
    1e-3 of the same run without a mesh; rank 0 wrote the checkpoint."""
    from repro_torch.data import synth_corpus
    from repro_torch.launch import train as launch_train

    out, _, work = ranks
    synth_corpus(tmp_path / "corpus.bin", n_tokens=5_000, vocab=256)
    plain = launch_train.run(launch_train.parser().parse_args(
        LAUNCH_ARGV + ["--workdir", str(tmp_path)]))
    want = [m["loss"] for m in plain.metrics_history]
    for o in out:
        r = o["launch_train"]
        assert r["step"] == 3
        np.testing.assert_allclose(r["losses"], want, atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
    assert (work / "launch" / "ckpt" / "LATEST").read_text() == "3"


def test_constrain_redistributes_a_dtensor(ranks):
    """Under the (2, 4) mesh a replicated (4, 25, 8) DTensor constrained to
    ("batch", "act_heads", None) splits dim 0 over data and skips the 25
    heads; its values do not change."""
    out, _, _ = ranks
    for o in out:
        assert o["flash_decode"]["constrained_spec"] == ("data", None, None)
        assert o["flash_decode"]["constrained_same"]
