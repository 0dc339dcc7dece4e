"""ZeRO-3 block by block (``repro_torch.distributed.fsdp``) against the JAX
package, in a gloo group of 8 ranks on the CPU of its own
(``_torch_port.DIST_GROUPS["fsdp"]``): the mesh step with the blocks'
weights split over ``data`` (qwen2.5-14b on (8, 1), hymba-1.5b and
xlstm-1.3b on (4, 2)) against the reference's whole-batch step, a watcher
on the gathers showing one block's weights and gradient at a time, the
pod-compressed step with data-split gradients, the gather and scatter
themselves, and two planted faults that must fail.

The reference's compiled sharded step (the qwen2.5-14b smoke config on an
(8, 1) data/model mesh of 8 host devices, the path of
``tests/test_distributed.py::test_sharded_train_step_runs_and_matches_single_device``)
all-gathers each of a block's 7 weights over data in the forward loop's
body and again in the backward loop's recompute, and reduces the block's
gradient there; only the embedding table is gathered outside the loops.
"""
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import AbstractMesh

import _torch_port
from _torch_port import fast_reference_compiles  # noqa: F401
from repro.distributed import sharding as jshd
from repro_torch import interop
from repro_torch.configs import smoke_config
from repro_torch.distributed import fsdp
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import build_model
from repro_torch.training.train_loop import shard_state, work_copy
from test_torch_distributed import (UPDATE_TOL, _work_shape, check_pod_step,
                                    check_tp_step, run_ranks)

# Two steps' update of each shard against the reference's whole-batch
# step, in relative norm (STEP_TOL also holds them): UPDATE_TOL where the
# blocks are split over data alone (qwen2.5-14b on (8, 1)); hymba and
# xLSTM on (4, 2) compute tensor-parallel too and take
# tests/test_torch_tp_recurrent.py's tolerances for their families.  The
# floor is the batch's: on some other draws the port's plain step alone is
# further from the reference than these tolerances, and the mesh step on
# (8, 1) is as far from the plain step with the weights gathered whole
# before the step as with this gather, so the batches are the other gloo
# groups' draws, on which those tolerances were set.
FSDP_TOL = {"fsdp_qwen": UPDATE_TOL, "fsdp_hymba": 1e-3, "fsdp_xlstm": 5e-4}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of the ``fsdp`` group's checks and the inputs
    they read, drawn as the other gloo groups draw theirs: qwen's batch of
    8 x 16 (its first 4 rows ``test_torch_distributed.py``'s batch, which
    the pod step takes), hymba's and xLSTM's 4 x 16 within xLSTM's smoke
    vocabulary of 128 (``test_torch_tp_recurrent.py``'s)."""
    work = tmp_path_factory.mktemp("dist_fsdp")

    def draw(vocab, b):
        return np.random.default_rng(1).integers(0, vocab, (b, 16)).astype(
            np.int32)

    inp = {"tokens8": draw(256, 8), "tokens4": draw(128, 4),
           "tokens": draw(256, 4)}
    return run_ranks(work, inp, "fsdp"), inp, work


@pytest.mark.parametrize("check", list(_torch_port.FSDP_CASES))
def test_fsdp_step_matches_reference(ranks, check):
    """Two mesh steps, each block's weights gathered over data in the layer
    loop and its gradient reduce-scattered to the rank's shard, against
    the reference's whole-batch step (``check_tp_step``): the loss and the
    gradient norm within STEP_TOL, every shard's update within STEP_TOL
    and FSDP_TOL, every block weight of the work copy the rank's shard
    over data and model and every other weight whole over data."""
    _, inp, _ = ranks
    arch, shape, _ = _torch_port.FSDP_CASES[check]
    check_tp_step(ranks, check, arch, {}, FSDP_TOL[check], shape,
                  tokens=inp[f"tokens{shape[0]}"], check_largest=False)


def test_one_block_gathered_at_a_time(ranks):
    """The watcher on the gathers (``_torch_port.watch_blocks``, weak
    references to the storages): in the forward and in the backward's
    recompute no other block's gathered weights are alive when a block is
    gathered, and no other block's whole gradient when a block is gathered
    or scattered; nothing of either is alive after the steps; every block
    is gathered once in the forward and once in the recompute (remat
    "full") and scattered once, each step."""
    out, _, _ = ranks
    for check, (arch, _, steps) in _torch_port.FSDP_CASES.items():
        n = smoke_config(arch).n_layers * steps
        for o in out:
            w = o[check]["watch"]
            assert (w["gathers_fwd"], w["gathers_recompute"],
                    w["scatters"]) == (n, n, n), (check, w)
            assert (w["overlap_fwd"], w["overlap_recompute"],
                    w["grads_alive"], w["alive_after"]) == (0, 0, 0, 0), \
                (check, w)


def test_block_gradients_arrive_as_shards(ranks):
    """The block gradients the step hands AdamW have the rank's shard's
    shape (split over data and model), the same as the work copy's block
    parameters: no whole-over-data gradient of a block is made past its
    scatter; on (8, 1) a weight whose dimension 8 divides is an eighth."""
    out, _, _ = ranks
    for check, (arch, shape, _) in _torch_port.FSDP_CASES.items():
        model = build_model(smoke_config(arch), "cpu").init(0, 16)
        axes = interop.param_axes(model)
        jmesh = AbstractMesh(shape, ("data", "model"))
        split = 0
        for n, p in model.named_parameters():
            if not n.startswith("blocks."):
                continue
            spec = tuple(jshd._spec_for_shape(axes[n], p.shape, jmesh,
                                              jshd.current_rules()))
            want = _work_shape(n, tuple(p.shape), spec, shape)
            split += "data" in spec
            for o in out:
                assert o[check]["grad_shapes"][n] == want, (check, n)
                assert o[check]["work_shapes"][n] == want, (check, n)
        assert split > 0, check
    wq = out[0]["fsdp_qwen"]["grad_shapes"]["blocks.0.attn.wq.w"]
    cfg = smoke_config("qwen2.5-14b")
    assert wq == (cfg.d_model // 8, cfg.n_heads * cfg.hd)


def test_pod_step_with_data_split_gradients(ranks):
    """The pod-compressed step on (2, 2, 2) with the blocks' gradients
    split over data: every shard's update, the parameters and each pod's
    residual against the emulation of the reference's
    ``pod_compressed_mean`` (``check_pod_step``: the scale the whole
    tensor's, the residual ``gf - q * scale``); ``ef`` kept as the rank's
    shard over data and model."""
    out, inp, _ = ranks
    check_pod_step(out, "fsdp_pod", inp["tokens"])
    cfg = smoke_config("qwen2.5-14b")
    model = build_model(cfg, "cpu").init(0, 16)
    axes = interop.param_axes(model)
    jmesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    for n, p in model.named_parameters():
        spec = tuple(jshd._spec_for_shape(axes[n], p.shape, jmesh,
                                          jshd.current_rules()))
        want = tuple(d // 2 if r else d for d, r in zip(p.shape, spec))
        for o in out:
            assert o["fsdp_pod"]["local_ef"][n].shape == want, n


def test_planted_unreduced_block_gradient_fails(ranks):
    """A planted fault: the second block's gradient cut to the rank's
    shard without the sum over data.  The check of
    :func:`test_fsdp_step_matches_reference` must fail on it, at the
    gradient norm or at one of that block's weights."""
    out, inp, _ = ranks
    with pytest.raises(AssertionError) as e:
        check_tp_step(ranks, "fault_unreduced", "qwen2.5-14b", {},
                      UPDATE_TOL, (8, 1), tokens=inp["tokens8"],
                      check_largest=False)
    assert "grad_norm" in str(e.value) or "blocks.1." in str(e.value), \
        str(e.value)[-400:]


def test_planted_shard_only_scale_fails(ranks):
    """A planted fault: ``pod_compressed_mean``'s scale taken over the
    rank's shard only.  The check of
    :func:`test_pod_step_with_data_split_gradients` must fail on it."""
    out, inp, _ = ranks
    with pytest.raises(AssertionError):
        check_pod_step(out, "fault_pod_scale", inp["tokens"])


def test_gather_and_scatter_follow_the_spec(ranks):
    """``fsdp.gather_block`` / ``scatter_block`` of a hand-made block on
    (2, 2, 2) pod/data/model (``_torch_port._check_fsdp_gather``): the
    gather joins data first, then pod, and leaves the ``model`` split and
    the unsplit parameter alone; the scatter gives each rank its shard of
    the sum over the ranks of the axes that split the parameter only, in
    the parameter's dtype."""
    out, _, _ = ranks
    full = {"a": np.arange(24.).reshape(8, 3),
            "b": (np.arange(40.) % 4).reshape(10, 4),
            "d": np.arange(12.).reshape(6, 2)}
    split = {"a": ("pod", "data"), "b": ("data",), "d": ("pod",)}
    coords = [o["fsdp_gather"]["coord"] for o in out]
    for r, o in enumerate(out):
        g = o["fsdp_gather"]
        assert g["leaves"] == ["a", "b", "d"]
        assert g["axes"] == [("data", (0, 1, None)), ("pod", (0, None, 0))]
        pod, data, model = g["coord"]
        want = [full["a"], full["b"][5 * model:5 * model + 5], full["d"]]
        for got, w in zip(g["gathered"], want):
            np.testing.assert_array_equal(got, w)
        for leaf, got, w in zip(g["leaves"], g["scattered"], want):
            keep = [i for i, a in enumerate(("pod", "data", "model"))
                    if a not in split[leaf]]
            k = sum(q + 1 for q, c in enumerate(coords)
                    if all(c[i] == g["coord"][i] for i in keep))
            if leaf == "a":
                w = w[(2 * pod + data) * 2:(2 * pod + data) * 2 + 2]
            elif leaf == "b":
                w = w[:, 2 * data:2 * data + 2]
            else:
                w = w[3 * pod:3 * pod + 3]
            np.testing.assert_array_equal(got, k * w, err_msg=leaf)
        assert g["dtypes"] == ["torch.float32", "torch.bfloat16",
                               "torch.float32"]


def test_local_copy_plans_on_a_fake_world():
    """On a fake group of 8 ranks, gemma3-1b's smoke model laid out on
    (8, 1) gives every block a gather plan over data whose leaves are the
    block's data-split weights, and its work copy's block parameters are
    the sharded model's own local tensors (one storage, no copy); on (1,
    8) nothing is split over data, no block has a plan and the step is
    the tensor-parallel one of slice 14."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    cfg = smoke_config("gemma3-1b")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        for shape, planned in (((8, 1), True), ((1, 8), False)):
            mesh = make_mesh(shape, ("data", "model"), "cpu")
            model = build_model(cfg, "cpu").init(0, 16)
            sh = shd.param_shardings(interop.param_axes(model), mesh,
                                     shapes=dict(model.named_parameters()))
            sharded = shard_state({"params": model, "opt": {}},
                                  {"params": sh})["params"]
            work = work_copy(cfg, sharded, mesh)
            src = dict(sharded.named_parameters())
            assert fsdp.shard_names(work) == fsdp.block_names(sharded)
            for i, block in enumerate(work.blocks):
                plan = fsdp.plan_of(block)
                assert (plan is not None) == planned, (shape, i)
                if plan is None:
                    continue
                assert [a.name for a in plan.axes] == ["data"]
                leaves = {f"blocks.{i}.{n}" for n, p in
                          block.named_parameters()
                          if any(p is getattr(o, leaf)
                                 for o, leaf in plan.leaves)}
                assert leaves == {n for n in src if n.startswith(
                    f"blocks.{i}.") and "data" in str(shd.spec_of(src[n]))}
            for n, p in work.named_parameters():
                if n in fsdp.shard_names(work):
                    assert p.data_ptr() == src[n].to_local().data_ptr(), n
    finally:
        dist.destroy_process_group()
