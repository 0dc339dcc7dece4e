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
from repro_torch.models import xlstm as X
from repro_torch.models.model import build_model, family_module

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


# the three weights whose columns are parts side by side, at full width:
# (config, parts, whole columns)
PART_WEIGHTS = {"hymba-1.5b mamba.w_in": ("hymba-1.5b", 2, 6400),
                "xlstm-1.3b mLSTM w_up": ("xlstm-1.3b", 2, 8192),
                "xlstm-1.3b sLSTM w_in": ("xlstm-1.3b", 4, 16384)}


def _emulated_parts(monkeypatch, whole, n, parts, spans_of=None):
    """Every rank's :func:`tp.parts_of_model` of its block of ``whole``
    (1, cols) over ``n`` ranks, and of each one's gradient of a random
    ``g`` (the same f64 draw for a rank each time), the all-gathers served
    from the ranks' blocks and gradients in this process."""
    blocks = list(whole.chunk(n, dim=1))
    served = {}

    def all_gather(out, x, group=None):
        for o, t in zip(out, served["list"]):
            o.copy_(t)
    monkeypatch.setattr(tp.dist, "all_gather", all_gather)
    prev = tp._CTX.tp
    try:
        ys, grads = [], []
        for r in range(n):
            tp._CTX.tp = tp.ModelGroup(None, n, r)
            served["list"] = blocks
            ys.append(tp.parts_of_model(blocks[r].clone().requires_grad_(),
                                        whole.shape[1], parts, dim=1,
                                        spans_of=spans_of))
        gen = torch.Generator().manual_seed(n)
        gs = [torch.randn(y.shape, dtype=torch.float64, generator=gen)
              for y in ys]
        most = max(g.shape[1] for g in gs)
        for r in range(n):
            tp._CTX.tp = tp.ModelGroup(None, n, r)
            served["list"] = [torch.cat([g, g.new_zeros(
                (1, most - g.shape[1]))], 1) for g in gs]
            leaf = ys[r].grad_fn.next_functions[0][0].variable \
                if ys[r].grad_fn is not None else None
            ys[r].backward(gs[r])
            grads.append(leaf.grad if leaf is not None else None)
    finally:
        tp._CTX.tp = prev
    return ys, gs, grads


def test_parts_of_model_at_full_width(monkeypatch):
    """For each of PART_WEIGHTS (one test, so that this file stays under
    tests/test_oracle.py's 16 tests), over model 2, 4, 8 and 16, at full
    width (one row), the column
    blocks of the reference's layout (where the ranks are a multiple of
    the parts, each rank's block lies in one part): each rank's
    ``parts_of_model`` is its ``1 / size`` of every part, in part order,
    and each block's gradient is the sum of the ranks' gradients of the
    columns it holds; the
    sLSTM's and mLSTM's covering-head spans (xlstm-1.3b's 4 heads of 1024
    over 8 and 16 ranks: ranks share a head) too, their overlapping
    gradients summed."""
    for arch, parts, cols in PART_WEIGHTS.values():
        _parts_at_full_width(monkeypatch, arch, parts, cols)


def _parts_at_full_width(monkeypatch, arch, parts, cols):
    whole = torch.arange(cols, dtype=torch.float64)[None]
    W = cols // parts
    for n in (2, 4, 8, 16):
        if n % parts == 0:      # each rank's own block lies in one part
            assert all(int(b[0, 0]) // W == int(b[0, -1]) // W
                       for b in whole.chunk(n, 1))
        c = W // n
        ys, gs, grads = _emulated_parts(monkeypatch, whole, n, parts)
        want_g = torch.zeros_like(whole)
        for r in range(n):
            cols_r = torch.cat([torch.arange(p * W + r * c, p * W + (r + 1)
                                             * c) for p in range(parts)])
            assert torch.equal(ys[r][0], whole[0, cols_r]), (n, r)
            want_g[0, cols_r] += gs[r][0]
        for r in range(n):
            assert torch.equal(grads[r], want_g.chunk(n, 1)[r]), (n, r)
        if arch != "xlstm-1.3b" or n < 8:
            continue
        cfg = get_config(arch)
        spans_of = X._head_spans(cfg, n, parts)
        ys, gs, grads = _emulated_parts(monkeypatch, whole, n, parts,
                                        spans_of)
        hd = W // cfg.n_heads
        want_g = torch.zeros_like(whole)
        for r in range(n):
            h = r * c // hd                 # one whole head a rank
            cols_r = torch.cat([torch.arange(p * W + h * hd, p * W + (h + 1)
                                             * hd) for p in range(parts)])
            assert torch.equal(ys[r][0], whole[0, cols_r]), (n, r)
            want_g[0, cols_r] += gs[r][0]
        for r in range(n):
            assert torch.allclose(grads[r], want_g.chunk(n, 1)[r],
                                  rtol=1e-12, atol=1e-12), (n, r)


def test_local_copy_of_hymba_and_xlstm_at_full_size():
    """hymba-1.5b's and xlstm-1.3b's local copies on a fake world of 16,
    over model 2, 4, 8 and 16: every parameter whole over data and its
    ``1 / size`` on each dimension the reference's ``_spec_for_shape``
    splits over model, whole elsewhere (xLSTM's ``r`` and its mLSTM
    decode state whole-headed where the ranks do not divide its 4 heads:
    a rank's state is the one head its quarter-head of channels falls
    in); hymba's decode states a rank's 1 / size of d_inner."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.training.train_loop import shard_state, work_copy

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=16)
    try:
        for arch in ("hymba-1.5b", "xlstm-1.3b"):
            cfg = get_config(arch)
            for n in (2, 4, 8, 16):
                mesh = make_mesh((16 // n, n), ("data", "model"), "cpu")
                model = family_module(cfg)[1](cfg, device="meta")
                shapes = {k: tuple(p.shape) for k, p in
                          model.named_parameters()}
                axes = interop.param_axes(model)
                sh = shd.param_shardings(axes, mesh, shapes=dict(
                    model.named_parameters()))
                sharded = shard_state({"params": model, "opt": {}},
                                      {"params": sh})["params"]
                local = work_copy(cfg, sharded, mesh)
                jmesh = AbstractMesh((16 // n, n), ("data", "model"))
                split = 0
                for k, p in local.named_parameters():
                    spec = tuple(jshd._spec_for_shape(
                        axes[k], shapes[k], jmesh, jshd.current_rules()))
                    want = tuple(d // n if r == "model" else d
                                 for d, r in zip(shapes[k], spec))
                    assert tuple(p.shape) == want, (arch, n, k)
                    split += "model" in spec
                assert split > 0
                with tp.activate(mesh):
                    cache = build_model(cfg, "meta").init_decode_cache(
                        2, 64)
                layer = cache["layers"][0]
                if arch == "hymba-1.5b":
                    di = 2 * cfg.d_model // n
                    assert layer[1]["conv"].shape == (2, 3, di)
                    assert layer[1]["state"].shape == (2, di, 16)
                else:
                    hd = int(cfg.proj_factor * cfg.d_model) // cfg.n_heads
                    nh = max(cfg.n_heads // n, 1)
                    assert layer.value[0].shape == (2, nh, hd, hd), n
                    r = dict(local.named_parameters())["blocks.7.r"]
                    assert r.shape[1] == (4 // n if n <= 4 else 4), n
    finally:
        dist.destroy_process_group()
