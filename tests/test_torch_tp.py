"""``repro_torch.distributed.tensor_parallel`` and the layers' head split,
in one process: which heads each ``model`` rank attends on for every
transformer config at full size, the spec helpers against the JAX
package's specs, the shape rule that tells a split weight, and the pieces'
plain paths outside a tensor-parallel context.  The collectives run in
``test_torch_distributed.py``'s 8-rank gloo group.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.distributed import sharding as jshd
from repro_torch import interop
from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L
from repro_torch.models.model import build_model

from _torch_port import fast_reference_compiles  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

TRANSFORMERS = ["qwen2.5-14b", "minitron-4b", "gemma3-12b", "gemma3-1b",
                "olmoe-1b-7b", "moonshot-v1-16b-a3b", "llava-next-mistral-7b",
                "whisper-large-v3"]


def _kernel_heads(cfg, n, r):
    """The kv head each of rank ``r``'s q heads reads through the flash
    kernel's GQA mapping (q head i reads kv head i // (Hq / Hkv) of the
    kv heads it is given), given the kv heads ``layers._tp_heads`` picks."""
    c0, c, h0, h1, pick = L._tp_heads(cfg, n, r)
    nq, nk = h1 - h0, len(pick)
    assert nq % nk == 0, (cfg.name, n, r, nq, nk)
    return [pick[i // (nq // nk)] for i in range(nq)]


@pytest.mark.parametrize("arch", TRANSFORMERS)
def test_tp_heads_cover_the_rows_of_wo(arch):
    """At full size over model 2, 4, 8 and 16 (where the q projection's
    columns split): the ranks' rows of ``wo`` tile the attention output in
    rank order; a rank's q heads are the fewest that cover its rows; each
    q head reads its own kv head through the kernel's GQA mapping, with a
    head count the kernel takes (Hq a multiple of Hkv); whether the q
    projection splits is the reference's spec on a (1, n) mesh."""
    cfg = get_config(arch)
    H, hd = cfg.n_heads * cfg.hd, cfg.hd
    for n in (2, 4, 8, 16):
        spec = jshd._spec_for_shape(("w_embed", "heads"), (cfg.d_model, H),
                                    AbstractMesh((1, n), ("data", "model")),
                                    jshd.current_rules())
        assert (tuple(spec)[1] == "model") == (H % n == 0)
        if H % n:
            continue
        end = 0
        for r in range(n):
            c0, c, h0, h1, _ = L._tp_heads(cfg, n, r)
            assert c0 == end and c == H // n
            end = c0 + c
            assert h0 * hd <= c0 < (h0 + 1) * hd
            assert (h1 - 1) * hd < c0 + c <= h1 * hd
            assert _kernel_heads(cfg, n, r) == [h // cfg.group
                                                for h in range(h0, h1)]
        assert end == H


def test_tp_heads_straddle_groups_unaligned():
    """Ten q heads over five kv heads of 8 over model 4: every rank's 2.5
    rows of heads take 3 q heads across two GQA groups, which the kernel
    reads with a kv head a q head (the 8-rank gloo test runs this
    config)."""
    cfg = smoke_config("qwen2.5-14b").replace(n_heads=10, n_kv_heads=5,
                                              head_dim=8)
    for r, want in enumerate([[0, 0, 1], [1, 1, 2], [2, 3, 3], [3, 4, 4]]):
        assert _kernel_heads(cfg, 4, r) == want


def test_model_dims_and_without_model():
    """``model_dims`` lists the dimensions a spec splits over ``model``;
    ``without_model`` keeps the others; ``model`` with another axis on one
    dimension has no local layout and raises."""
    assert tp.model_dims(("data", "model")) == (1,)
    assert tp.model_dims(("model", None, "data")) == (0,)
    assert tp.model_dims((("pod", "data"), None)) == ()
    assert tp.without_model(("data", "model")) == ("data", None)
    assert tp.without_model((("pod", "data"), "model")) == (("pod", "data"),
                                                            None)
    with pytest.raises(NotImplementedError):
        tp.model_dims((("data", "model"),))


def test_split_reads_the_shape():
    """Under a tensor-parallel context of 4 ranks a dimension of the
    config's size is whole, a quarter of it split, anything else raises;
    outside one nothing is split."""
    w = torch.empty(64, 16)
    assert not tp.split(w, 1, 16)
    prev = tp._CTX.tp
    tp._CTX.tp = tp.ModelGroup(None, 4, 1)
    try:
        assert not tp.split(w, 1, 16)
        assert tp.split(w, 1, 64)
        with pytest.raises(ValueError):
            tp.split(w, 1, 48)
    finally:
        tp._CTX.tp = prev


def test_plain_paths_outside_tensor_parallelism():
    """With no tensor-parallel context the pieces are the plain ops:
    ``copy_to_model``, ``reduce_from_model`` and ``gather_from_model``
    return their input, ``vocab_embed`` is the row lookup and
    ``vocab_nll`` the per-position NLL, equal to jax's
    ``logsumexp - take_along_axis`` of the same logits within 1e-6."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    x = torch.from_numpy(logits)
    assert tp.copy_to_model(x) is x and tp.reduce_from_model(x) is x
    assert tp.gather_from_model(x) is x
    table = torch.from_numpy(rng.standard_normal((11, 4)).astype(
        np.float32))
    tok = torch.from_numpy(labels)
    assert torch.equal(tp.vocab_embed(table, tok, 11), table[tok.long()])
    want = jax.nn.logsumexp(jnp.asarray(logits), -1) - jnp.take_along_axis(
        jnp.asarray(logits), jnp.asarray(labels)[..., None], -1)[..., 0]
    np.testing.assert_allclose(tp.vocab_nll(x, tok, 11).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


def test_model_group_and_the_local_copy_on_a_fake_world():
    """On a fake group of 8 ranks: a mesh whose ``model`` axis has one
    rank has no model group (the step is the plain one); (2, 4) has one of
    4 ranks.  ``local_copy`` of gemma3-1b's smoke model laid out on (2, 4)
    is built on ``meta`` first and holds each parameter whole over
    ``data`` and a quarter over ``model``, where the reference's spec
    splits it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.training.train_loop import shard_state

    cfg = smoke_config("gemma3-1b")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        assert tp.model_group(make_mesh((8, 1), ("data", "model"),
                                        "cpu")) is None
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        g = tp.model_group(mesh)
        assert (g.size, g.rank) == (4, 0)
        model = build_model(cfg, "cpu").init(0, 16)
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        axes = interop.param_axes(model)
        sh = shd.param_shardings(axes, mesh, shapes=dict(
            model.named_parameters()))
        sharded = shard_state({"params": model, "opt": {}},
                              {"params": sh})["params"]
        local = tp.local_copy(sharded, mesh, lambda dev: type(model)(
            cfg, max_seq=0, device=dev))
        jmesh = AbstractMesh((2, 4), ("data", "model"))
        for n, p in local.named_parameters():
            spec = tuple(jshd._spec_for_shape(axes[n], shapes[n], jmesh,
                                              jshd.current_rules()))
            want = tuple(d // 4 if r == "model" else d
                         for d, r in zip(shapes[n], spec))
            assert tuple(p.shape) == want and p.requires_grad, n
    finally:
        dist.destroy_process_group()
