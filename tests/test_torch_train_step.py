"""The port's train step against the JAX package's, on the CPU in f32:
three ``make_train_step`` steps at ``microbatches`` 1 and 2 from the same
parameters and batches (loss, ``grad_norm`` and ``lr`` tight, each
parameter's update within ``UPDATE_TOL`` relative norm of the
reference's), a mesh step's construction, ``quantize_int8``'s error
feedback, the parameter and FLOP counts of every config, and
``launch/train`` on the CPU.  Split from ``test_torch_training.py``, whose
smoke setup it shares.
"""
import jax
import numpy as np
import pytest
import torch

from repro.training import optimizer as jopt
from repro.training.train_loop import make_train_step as jax_train_step
from repro_torch import interop
from repro_torch.models.model import build_model
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import make_train_step

from _torch_port import fast_reference_compiles  # noqa: F401
from test_torch_training import S, _jax_cfg, _port_cfg, _setup, _torch_batch

jax.config.update("jax_platform_name", "cpu")


def test_quantize_int8_error_feedback_converges():
    """Quantisation error is bounded by the scale; error feedback re-injects
    it, so the mean over steps approaches the true mean."""
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(256)
                         .astype(np.float32))
    q, scale = opt.quantize_int8(g)
    assert float((g - q.float() * scale).abs().max()) <= float(scale) / 2 \
        + 1e-6
    acc, e = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(64):
        q, s = opt.quantize_int8(g + e)
        deq = q.float() * s
        e = (g + e) - deq
        acc = acc + deq
    np.testing.assert_allclose((acc / 64).numpy(), g.numpy(),
                               atol=float(scale))


# ----------------------------------------------------------- train step ----
# lr 1e-3 over three steps.  Each leaf's update (after minus before) is
# held to UPDATE_TOL of the reference's update in relative norm: an update
# that never ran is 1 off, one with the wrong sign 2.  The losses, grad
# norms and lr are held within 1e-5 relative (the gradients themselves
# within GRAD_TOL in test_loss_and_grads_match_jax).  Under Adam an element
# whose gradient is noise near zero (summed in another order) could move
# by +-lr either way; none does here: the largest leaf error measured was
# 8.6e-6 relative norm (wq, microbatches 1), the largest element 1.1e-6
# absolute, three orders under lr.
TRAIN_LR = 1e-3


UPDATE_TOL = 1e-4


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    name = "gemma3_1b"
    cfg, params, _ = _setup(name)
    jcfg = _jax_cfg(name)
    kw = dict(lr=TRAIN_LR, warmup=1, total_steps=10)
    jstep = jax.jit(jax_train_step(jcfg, adamw=jopt.AdamWConfig(**kw),
                                   microbatches=microbatches))
    tstep = make_train_step(cfg, build_model(cfg, "cpu"),
                            adamw=opt.AdamWConfig(**kw),
                            microbatches=microbatches)
    before = jax.tree_util.tree_map(np.array, params)
    jstate = {"params": params,
              "opt": jopt.adamw_init(params, jopt.AdamWConfig(**kw))}
    model = interop.params_from_numpy(cfg, params, "cpu")
    tstate = {"params": model, "opt": opt.adamw_init(model,
                                                      opt.AdamWConfig(**kw))}
    rng = np.random.default_rng(5)
    for _ in range(3):
        batch = {"tokens": rng.integers(0, cfg.vocab, (4, S)).astype(
            np.int32)}
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, _torch_batch(batch))
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
    got = interop.params_to_numpy(tstate["params"])

    def check_update(path, a, b, b0):
        want = np.asarray(b, np.float64) - b0
        err = np.linalg.norm((a - b0) - want) / np.linalg.norm(want)
        assert err <= UPDATE_TOL, (jax.tree_util.keystr(path), err)

    jax.tree_util.tree_map_with_path(check_update, got, jstate["params"],
                                     before)
    assert int(tstate["opt"]["step"]) == 3


def test_train_step_with_a_mesh_raises():
    """A mesh step builds for a dense model and for MoE, with a batch axis
    larger than 1 (its router statistics are summed over the slices) and
    of 1; given a state that is not sharded it raises.
    ``test_torch_distributed.py`` runs the mesh step."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_mesh

    cfg = _port_cfg("gemma3_1b")
    moe = _port_cfg("olmoe_1b_7b")
    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0,
                                         world_size=8)
    try:
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        assert callable(make_train_step(cfg, build_model(cfg, "cpu"),
                                        mesh=mesh))
        step = make_train_step(moe, build_model(moe, "cpu"), mesh=mesh)
        assert callable(make_train_step(
            moe, build_model(moe, "cpu"),
            mesh=make_mesh((1, 8), ("data", "model"), "cpu")))
        model = build_model(moe, "cpu").init(0, 16)
        state = {"params": model, "opt": opt.adamw_init(model,
                                                         opt.AdamWConfig())}
        with pytest.raises(ValueError, match="sharded state"):
            step(state, {"tokens": torch.zeros((4, 16), dtype=torch.int32)})
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("name", [
    "qwen2_5_14b", "minitron_4b", "gemma3_12b", "gemma3_1b", "olmoe_1b_7b",
    "moonshot_v1_16b_a3b", "llava_next_mistral_7b", "whisper_large_v3",
    "hymba_1_5b", "xlstm_1_3b"])
def test_param_and_flop_counts_match_jax(name):
    from repro.configs.base import get_config as jax_config
    from repro.models import model as JM
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM

    jcfg, tcfg = jax_config(name), get_config(name)
    assert TM.active_params(tcfg) == JM.active_params(jcfg)
    assert TM.total_params(tcfg) == JM.total_params(jcfg)
    for seq in (1024, 4096):
        assert TM.model_flops_per_token(tcfg, seq) == \
            JM.model_flops_per_token(jcfg, seq)


def test_launch_train_runs_on_the_cpu(tmp_path, capsys):
    """``launch/train`` end to end on the smoke config (a small corpus put
    in its workdir first): the flags, the f32 override, the loss line
    every 10 steps and a checkpoint at the end that a second run resumes
    from; ``--mesh`` raises unless its ranks are the process group's."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.data import synth_corpus
    from repro_torch.launch import train as launch_train

    synth_corpus(tmp_path / "corpus.bin", n_tokens=5_000, vocab=128)
    argv = ["--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--steps",
            "10", "--seq", "16", "--batch", "2", "--workdir", str(tmp_path)]
    res = launch_train.main(argv)
    params = list(res.state["params"].parameters())
    assert all(p.dtype == torch.float32 for p in params) and res.step == 10
    assert res.restarts == 0 and len(res.metrics_history) == 10
    assert all(np.isfinite(m["loss"]) for m in res.metrics_history)
    text = capsys.readouterr().out
    assert "step    10 loss" in text and "tok/s" in text
    assert (tmp_path / "ckpt" / "LATEST").read_text() == "10"
    again = launch_train.main(argv)               # resumes at step 10
    assert again.step == 10 and again.metrics_history == []
    # --mesh needs D x M ranks (test_torch_distributed.py trains on 2x4)
    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0,
                                         world_size=4)
    try:
        with pytest.raises(ValueError, match="8 ranks"):
            launch_train.main(argv + ["--mesh", "2x4"])
    finally:
        torch.distributed.destroy_process_group()
