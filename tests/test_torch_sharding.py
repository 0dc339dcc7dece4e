"""The port's logical-axis sharding (``distributed/sharding.py``),
``launch/mesh.py`` and the shard combine of flash-decoding against the JAX
package, in this process, with no process group of real ranks: the port's
specs on a ``DeviceMesh`` of a fake process group against the reference's
on a ``jax.sharding.AbstractMesh`` of the same shape.  The checks that need
processes are in ``test_torch_distributed.py``.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs.base import smoke_config as jax_smoke
from repro.distributed import sharding as jshd
from repro.kernels import ref as jref
from repro.training import optimizer as jopt
from repro.training.train_loop import (batch_shardings as jbatch_shardings,
                                       state_shardings as jstate_shardings)
from repro_torch import interop
from repro_torch.configs import smoke_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import (batch_shardings,
                                             state_shardings)

from _torch_port import (  # noqa: F401
    fast_reference_compiles, flash_decode_inputs, ref_node, reference_axes)

jax.config.update("jax_platform_name", "cpu")

CONFIGS = ["qwen2_5_14b", "minitron_4b", "gemma3_12b", "gemma3_1b",
           "olmoe_1b_7b", "moonshot_v1_16b_a3b", "llava_next_mistral_7b",
           "whisper_large_v3", "hymba_1_5b", "xlstm_1_3b"]
MESHES = [((2, 4), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
DECODE_TOL = dict(atol=3e-5, rtol=3e-5)    # tests/test_distributed.py's


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks in this process (rank 0): a
    ``DeviceMesh`` can be built on it; its collectives compute nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", CONFIGS)
def test_param_and_state_shardings_match_reference(name):
    """Every parameter's spec, the state's and the batch's, on (2, 4)
    data/model and (2, 2, 2) pod/data/model."""
    shapes, axes = reference_axes(name)
    model = build_model(smoke_config(name), "cpu").init(0, 16)
    stacked = name != "xlstm_1_3b"
    paths = interop.reference_paths(model)
    t_axes = interop.param_axes(model)
    for name_, path in paths.items():
        want = ref_node(axes, path, stacked)
        assert t_axes[name_] == (want[1:] if stacked and path[0] in
                                 interop.STACKED else want), name_
    acfg = opt.AdamWConfig(pod_compression=True)
    jacfg = jopt.AdamWConfig(pod_compression=True)
    batch = {"tokens": np.zeros((4, 16), np.int32),
             "odd": np.zeros((3, 16), np.int32)}
    with fake_world(8):
        for shape, names in MESHES:
            mesh = make_mesh(shape, names, "cpu")
            jmesh = AbstractMesh(shape, names)
            tsh = state_shardings(smoke_config(name), t_axes, mesh, model,
                                  acfg)
            jsh = jstate_shardings(jax_smoke(name), axes, jmesh, shapes,
                                   jacfg)
            assert tsh["opt"]["step"].spec == tuple(jsh["opt"]["step"].spec)
            for name_, path in paths.items():
                for key, tree in (("params", tsh["params"]),
                                  ("mu", tsh["opt"]["mu"]),
                                  ("ef", tsh["opt"]["ef"])):
                    ref = ref_node(jsh["params"] if key == "params"
                                    else jsh["opt"][key], path, stacked)
                    want = tuple(ref.spec)
                    if stacked and path[0] in interop.STACKED:
                        assert want[0] is None
                        want = want[1:]
                    got = tree[name_].spec
                    assert got == want, (shape, key, name_, got, want)
                    tree[name_].placements       # a valid DTensor layout
            with jshd.activate(None):
                jb = jbatch_shardings(batch, jmesh)
            tb = batch_shardings({k: torch.from_numpy(v)
                                  for k, v in batch.items()}, mesh)
            assert {k: s.spec for k, s in tb.items()} == \
                {k: tuple(s.spec) for k, s in jb.items()}


def test_constrain_and_placements():
    """25 heads over a 4-way model axis: the axis is dropped, as the
    reference's ``_spec_for_shape``; a plain tensor passes ``constrain``
    unchanged; a tuple rule against the mesh's order raises."""
    with fake_world(8):
        for shape, names in MESHES:
            mesh = make_mesh(shape, names, "cpu")
            jmesh = AbstractMesh(shape, names)
            for dims in ((4, 25, 8), (4, 24, 8), (3, 24, 8)):
                got = shd._spec_for_shape(
                    ("batch", "act_heads", None), dims, mesh,
                    shd.current_rules())
                want = jshd._spec_for_shape(
                    ("batch", "act_heads", None), dims, jmesh,
                    jshd.current_rules())
                assert got == tuple(want), (shape, dims)
            x = torch.ones(4, 25, 8)
            with shd.activate(mesh):
                assert shd.constrain(x, ("batch", "act_heads", None)) is x
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
        from torch.distributed.tensor import Shard
        assert shd.to_placements((("pod", "data"), "model"), mesh) == \
            (Shard(0), Shard(0), Shard(1))
        with pytest.raises(ValueError, match="order"):
            shd.to_placements((("data", "pod"), None), mesh)


def test_make_production_mesh_shapes():
    """(16, 16) data/model on 256 ranks, (2, 16, 16) pod/data/model on 512;
    fewer ranks than the mesh raise."""
    with fake_world(256):
        m = make_production_mesh(device_type="cpu")
        assert (tuple(m.shape), m.mesh_dim_names) == ((16, 16),
                                                       ("data", "model"))
        with pytest.raises(ValueError, match="512"):
            make_production_mesh(multi_pod=True, device_type="cpu")
    with fake_world(512):
        m = make_production_mesh(multi_pod=True, device_type="cpu")
        assert (tuple(m.shape), m.mesh_dim_names) == (
            (2, 16, 16), ("pod", "data", "model"))
        assert tuple(make_production_mesh(device_type="cpu").shape) == \
            (16, 16)


def test_shard_combine_matches_unsharded_plain_version():
    """The plain log-sum-exp of the paged attention and ``combine_shards``
    over 1, 2, 4 and 8 emulated shards (each a disjoint set of physical
    pages, the rest -1) equal the unsharded attention; the log-sum-exp
    against the reference's softmax; rows with no live key give 0."""
    from repro_torch.kernels import ref as tref

    inp = flash_decode_inputs()
    q, kp, vp, pt, sl = (torch.from_numpy(inp[k]) for k in
                         ("q", "k_pages", "v_pages", "page_table",
                          "seq_lens"))
    want = np.asarray(jref.paged_attention_ref(
        *(jnp.asarray(inp[k]) for k in ("q", "k_pages", "v_pages",
                                        "page_table", "seq_lens"))))
    out, lse = tref.paged_attention_lse_ref(q, kp, vp, pt, sl)
    np.testing.assert_allclose(out.numpy(), want, **DECODE_TOL)
    assert torch.isneginf(lse[sl == 0]).all() and torch.isfinite(
        lse[sl > 0]).all()
    P = kp.shape[1]
    for n in (1, 2, 4, 8):
        parts = [tref.paged_attention_lse_ref(
            q, kp, vp, torch.where((pt >= s * P // n)
                                   & (pt < (s + 1) * P // n), pt, -1), sl)
            for s in range(n)]
        o = torch.stack([p[0] for p in parts])
        ls = torch.stack([p[1] for p in parts])
        got = T.combine_shards(o, ls, lambda t: t.amax(0),
                               lambda t: t.sum(0))
        np.testing.assert_allclose(got.numpy(), want, **DECODE_TOL)
        assert not torch.isnan(got).any()
