"""The port's checkpoints, fault-tolerant loop and data against the JAX
package's, on the CPU.

* Checkpoints: a training state written by either package restores in the
  other (the reference's layout and flatten order: ``opt`` (``ef``,
  ``mu``, ``nu``, ``step``) before ``params``, blocks stacked, xLSTM's a
  tuple), bit for bit; the port's keep-N, ``LATEST``, atomicity and
  structure-mismatch error, as ``tests/test_training.py`` holds the
  reference's.
* ``run_training``: with failures injected it recovers with the same
  history, restarts and final state as the reference's; a real train step
  restored from a checkpoint ends bit-identical to an uninterrupted run.
* Data: ``synth_corpus`` writes the same bytes, and ``Loader`` gives the
  same batches (per step, per rank, through ``iterate``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DataConfig as JDataConfig
from repro.data import Loader as JLoader
from repro.data import TokenStore as JTokenStore
from repro.data import synth_corpus as jax_synth_corpus
from repro.training import checkpoint as jckpt
from repro.training.fault_tolerance import FailureInjector as JInjector
from repro.training.fault_tolerance import run_training as jax_run_training
from repro_torch import interop
from repro_torch.configs import smoke_config
from repro_torch.data import DataConfig, Loader, TokenStore, synth_corpus
from repro_torch.models.model import build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training.fault_tolerance import (FailureInjector,
                                                  run_training)
from repro_torch.training.train_loop import make_train_step

from _torch_port import fast_reference_compiles  # noqa: F401

jax.config.update("jax_platform_name", "cpu")


def _port_state(name, seed, pod_compression=False):
    """A port training state of the smoke config: weights from ``seed``,
    random moments and step 7."""
    cfg = smoke_config(name)
    model = build_model(cfg, "cpu").init(seed, 32)
    st = opt.adamw_init(model, opt.AdamWConfig(
        pod_compression=pod_compression))
    gen = torch.Generator().manual_seed(seed)
    for key in ("mu", "nu", "ef"):
        for t in st.get(key, {}).values():
            t.copy_(torch.randn(t.shape, generator=gen))
    st["step"].fill_(7)
    return {"params": model, "opt": st}


def _as_reference(state):
    model = state["params"]
    return {"params": interop.params_to_numpy(model),
            "opt": interop.opt_state_to_numpy(model, state["opt"])}


def _assert_trees_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("name,pod", [("gemma3_1b", False),
                                      ("xlstm_1_3b", True)])
def test_port_checkpoint_restores_in_jax(tmp_path, name, pod):
    state = _port_state(name, 1, pod)
    ckpt.save_checkpoint(tmp_path, 7, state, extra={"data_pos": 5})
    want = _as_reference(state)
    template = jax.tree_util.tree_map(jnp.zeros_like, want)
    got, step, extra = jckpt.restore_checkpoint(tmp_path, template)
    assert step == 7 and extra == {"data_pos": 5}
    _assert_trees_equal(got, want)
    assert got["opt"]["step"].dtype == jnp.int32


@pytest.mark.parametrize("name,pod", [("gemma3_1b", True),
                                      ("xlstm_1_3b", False)])
def test_jax_checkpoint_restores_in_port(tmp_path, name, pod):
    want = _as_reference(_port_state(name, 2, pod))
    jckpt.save_checkpoint(tmp_path, 11, jax.tree_util.tree_map(
        jnp.asarray, want), keep=2)
    template = _port_state(name, 3, pod)
    got, step, _ = ckpt.restore_checkpoint(tmp_path, template)
    assert step == 11 and got["params"] is template["params"]
    assert int(got["opt"]["step"]) == 7
    _assert_trees_equal(_as_reference(got), want)


def _tree(rng):
    return {"params": {"a": torch.from_numpy(rng.standard_normal((4, 3))
                                             .astype(np.float32)),
                       "b": torch.arange(5, dtype=torch.int32)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip_and_layout(tmp_path, rng):
    st = _tree(rng)
    ckpt.save_checkpoint(tmp_path, 10, st, extra={"data_pos": 123})
    got, step, extra = ckpt.restore_checkpoint(tmp_path, st)
    assert step == 10 and extra["data_pos"] == 123
    for key, sub in (("params", "a"), ("params", "b"), ("opt", "step")):
        assert torch.equal(got[key][sub], st[key][sub])
        assert got[key][sub].dtype == st[key][sub].dtype
    # the reference's flatten order: opt/step before params/a, params/b
    shapes = [np.load(tmp_path / f"step_00000010/arr_{i:05d}.npy").shape
              for i in range(3)]
    assert shapes == [(), (4, 3), (5,)]


def test_checkpoint_keep_n_and_latest(tmp_path, rng):
    st = _tree(rng)
    for s in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(tmp_path, s, st, keep=2)
    assert ckpt.list_steps(tmp_path) == [4, 5]
    assert ckpt.latest_step(tmp_path) == 5


def test_checkpoint_atomicity(tmp_path, rng):
    """A stale .tmp dir never shadows a published checkpoint."""
    st = _tree(rng)
    ckpt.save_checkpoint(tmp_path, 1, st)
    (tmp_path / "step_00000002.tmp").mkdir()     # simulated crash mid-save
    assert ckpt.latest_step(tmp_path) == 1
    _, step, _ = ckpt.restore_checkpoint(tmp_path, st)
    assert step == 1


def test_checkpoint_structure_mismatch_raises(tmp_path, rng):
    st = _tree(rng)
    ckpt.save_checkpoint(tmp_path, 1, st)
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore_checkpoint(tmp_path, {"params": {"a": st["params"]["a"]}})
    # a training state of another config: the leaf count differs
    ckpt.save_checkpoint(tmp_path / "t", 1, _port_state("gemma3_1b", 0))
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore_checkpoint(tmp_path / "t", _port_state("xlstm_1_3b", 0))
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(tmp_path / "none", st)


# ------------------------------------------------------ fault tolerance ---
def test_run_training_recovers_like_the_reference(tmp_path):
    """Crashes injected at steps 7 and 12 with a checkpoint every 5 steps:
    the same restarts, metrics history and final state as the reference's
    loop, and the final state equals an uninterrupted run's."""
    @jax.jit
    def jstep(state, batch):
        return {"w": state["w"] + batch, "n": state["n"] + 1}, \
            {"w": state["w"]}

    def tstep(state, batch):
        return {"w": state["w"] + batch, "n": state["n"] + 1}, \
            {"w": state["w"]}

    want = jax_run_training(
        jstep, lambda: {"w": jnp.zeros(()), "n": jnp.int32(0)},
        lambda s: jnp.float32(s), 20, ckpt_dir=tmp_path / "j", ckpt_every=5,
        failure_injector=JInjector(fail_at=(7, 12)))
    got = run_training(
        tstep, lambda: {"w": torch.zeros(()),
                        "n": torch.tensor(0, dtype=torch.int32)},
        lambda s: torch.tensor(float(s)), 20, ckpt_dir=tmp_path / "t",
        ckpt_every=5, failure_injector=FailureInjector(fail_at=(7, 12)))
    assert got.restarts == want.restarts == 2
    assert got.step == want.step == 20
    assert got.metrics_history == want.metrics_history
    assert float(got.state["w"]) == float(want.state["w"]) == sum(range(20))
    assert int(got.state["n"]) == 20
    assert ckpt.list_steps(tmp_path / "t") == jckpt.list_steps(tmp_path / "j")


def test_run_training_too_many_failures_raises(tmp_path):
    def step(state, batch):
        raise RuntimeError("dead device")

    with pytest.raises(RuntimeError, match="dead device"):
        run_training(step, lambda: {"w": torch.zeros(())}, lambda s: None, 5,
                     ckpt_dir=tmp_path / "ft2", max_restarts=2)


def test_train_step_restored_from_checkpoint_is_bit_identical(tmp_path):
    """gemma3-1b's smoke config, six steps: a failure before step 5 with a
    checkpoint every 2 steps restores step 4 and replays; the final
    parameters and moments equal an uninterrupted run's bit for bit, and a
    failure with no checkpoint restarts from a fresh state."""
    cfg = smoke_config("gemma3_1b")
    api = build_model(cfg, "cpu")
    acfg = opt.AdamWConfig(lr=1e-2, warmup=2, total_steps=6)
    step = make_train_step(cfg, api, adamw=acfg)
    rng = np.random.default_rng(8)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab, (2, 10)).astype(
        np.int32)) for _ in range(6)]

    def init():
        model = api.init(0, 32)
        return {"params": model, "opt": opt.adamw_init(model, acfg)}

    def run(**kw):
        return run_training(step, init, lambda s: {"tokens": batches[s]}, 6,
                            **kw)

    plain = run()
    drill = run(ckpt_dir=tmp_path / "c", ckpt_every=2,
                failure_injector=FailureInjector(fail_at=(5,)))
    fresh = run(failure_injector=FailureInjector(fail_at=(3,)))
    assert (plain.restarts, drill.restarts, fresh.restarts) == (0, 1, 1)
    assert len(drill.metrics_history) == 7 and len(fresh.metrics_history) == 9
    for res in (drill, fresh):
        assert res.metrics_history[-1] == plain.metrics_history[-1]
        _assert_trees_equal(_as_reference(res.state),
                            _as_reference(plain.state))


# ----------------------------------------------------------------- data ---
@pytest.mark.parametrize("order", [1, 2])
def test_synth_corpus_bytes_and_batches_match_jax(tmp_path, order):
    a = synth_corpus(tmp_path / "t.bin", n_tokens=70_000, vocab=97,
                     seed=3, order=order)
    b = jax_synth_corpus(tmp_path / "j.bin", n_tokens=70_000, vocab=97,
                         seed=3, order=order)
    assert a.read_bytes() == b.read_bytes()
    for n_ranks in (1, 2):
        for rank in range(n_ranks):
            kw = dict(seq_len=16, global_batch=4, n_ranks=n_ranks, rank=rank)
            tl = Loader(TokenStore.open(a), DataConfig(**kw))
            jl = JLoader(JTokenStore.open(b), JDataConfig(**kw))
            for s in (0, 3, 1000):
                got, want = tl.batch_for_step(s), jl.batch_for_step(s)
                assert set(got) == set(want)
                for k in want:
                    assert got[k].dtype == want[k].dtype == np.int32
                    np.testing.assert_array_equal(got[k], want[k])
    tl = Loader(TokenStore.open(a), DataConfig(seq_len=8, global_batch=2))
    jl = JLoader(JTokenStore.open(b), JDataConfig(seq_len=8, global_batch=2))
    ti, ji = tl.iterate(start_step=5), jl.iterate(start_step=5)
    for _ in range(3):
        got, want = next(ti), next(ji)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
    tl.stop()
    jl.stop()
