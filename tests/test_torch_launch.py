"""The port's dry-run modules against the JAX package: ``configs.base``'s
``list_archs`` and ``input_specs``, ``launch/roofline.py``,
``launch/op_analysis.py`` (against ``hlo_analysis``), ``launch/dryrun.py``
(argument bytes against the reference's shardings, FLOPs on ``meta``
against a run on CPU tensors, every cell kind, the CLI) and
``launch/report.py``.  Loops over architectures and shapes run inside a
test where the check is arithmetic.  No test here imports the reference's
``dryrun`` or ``perf``, which set ``XLA_FLAGS`` at import.
"""
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import base as jbase
from repro.distributed import sharding as jshd
from repro.launch import hlo_analysis
from repro.launch import report as jreport
from repro.launch import roofline as jroofline
from repro.training import optimizer as jopt
from repro.training.train_loop import (batch_shardings as jbatch_shardings,
                                       state_shardings as jstate_shardings)
from repro_torch.configs import (SHAPES, ShapeCell, get_config, input_specs,
                                 list_archs, smoke_config)
from repro_torch.launch import dryrun, op_analysis, report, roofline

from _torch_port import reference_axes

jax.config.update("jax_platform_name", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_CELL = ShapeCell("train_4k", 16, 8, "train")
MESHES = [((2, 4), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def test_list_archs_and_input_specs_match_reference():
    """The reference's architecture order, and every architecture x shape's
    input shapes and dtypes (VLM patches min(n_patches, S // 2), audio
    frames, decode (B,) int32), on ``meta``."""
    assert list_archs() == jbase.list_archs()
    for arch in list_archs():
        for shape, cell in SHAPES.items():
            got = input_specs(get_config(arch), cell)
            want = jbase.input_specs(jbase.get_config(arch),
                                     jbase.SHAPES[shape])
            assert list(got) == list(want), (arch, shape)
            for k, w in want.items():
                assert got[k].device.type == "meta"
                assert (tuple(got[k].shape), _dtype_name(got[k].dtype)) == \
                    (tuple(w.shape), str(w.dtype)), (arch, shape, k)


def test_model_flops_for_cell_matches_reference():
    """``model_flops_for_cell`` equals the reference's exactly for every
    architecture x shape."""
    for arch in list_archs():
        for shape, cell in SHAPES.items():
            assert roofline.model_flops_for_cell(get_config(arch), cell) == \
                jroofline.model_flops_for_cell(jbase.get_config(arch),
                                               jbase.SHAPES[shape]), \
                (arch, shape)


def test_roofline_matches_reference_at_its_peaks():
    """``Roofline.to_dict`` equals the reference's given the reference's
    peaks, for a compute-, a memory- and a collective-bound step; the
    card's peaks are the H100's."""
    peaks = dict(peak_flops=jroofline.PEAK_FLOPS, hbm_bw=jroofline.HBM_BW,
                 link_bw=jroofline.ICI_BW)
    for args in ((4e15, 1e9, 1e8, 3e17, 256), (1e12, 5e12, 1e8, 2e14, 1),
                 (1e12, 1e9, 9e11, 0.0, 512), (0.0, 0.0, 0.0, 0.0, 1)):
        want = jroofline.Roofline(*args).to_dict()
        assert roofline.Roofline(*args, **peaks).to_dict() == want
    rf = roofline.Roofline(1e12, 1e9, 1e8)
    assert (rf.peak_flops, rf.hbm_bw, rf.link_bw) == (989e12, 3.35e12,
                                                      450e9)
    assert roofline.peak_flops_for("float32") == 67e12
    assert roofline.peak_flops_for(torch.bfloat16) == 989e12


def test_op_analysis_counts_like_hlo_analysis():
    """A loop-free matmul chain: the walk's FLOPs equal
    ``hlo_analysis.analyze_compiled`` of the same jnp function; an
    all-reduce on a fake group of 4 counts 2 x its result bytes, one over a
    group of one rank nothing; live bytes rise with each new storage and
    fall as it dies."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(s).astype(np.float32)
               for s in ((64, 32), (32, 48), (48, 16)))
    compiled = jax.jit(lambda a, b, c: jnp.tanh(a @ b) @ c).lower(
        a, b, c).compile()
    want = hlo_analysis.analyze_compiled(compiled)
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    with op_analysis.OpWalk() as walk:
        torch.tanh(ta @ tb) @ tc
    assert walk.cost.flops == want.flops \
        == 2 * 64 * 32 * 48 + 2 * 64 * 48 * 16
    assert walk.n_ops == 3

    def chain():
        kept = []
        for _ in range(4):
            x = torch.empty(1000, device="meta").fill_(1.0)
            kept.append((x * 2).sum())
        return kept

    with op_analysis.OpWalk() as walk:
        kept = chain()
    # at most two 4000-byte storages (x and x * 2) and the four sums alive,
    # each rounded up to a 512-byte block
    assert walk.peak_bytes == 2 * 4096 + 4 * 512
    assert walk.live_bytes == 4 * 512 and len(kept) == 4

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        t = torch.ones(1000)
        with op_analysis.OpWalk() as walk:
            dist.all_reduce(t)
        assert walk.cost.coll_bytes == {"all-reduce": 4000.0}
        assert walk.cost.total_coll_bytes == 2 * 4000.0
        one = dist.new_group([0])
        with op_analysis.OpWalk() as walk:
            dist.all_reduce(t, group=one)
        assert walk.cost.coll_bytes == {}
    finally:
        dist.destroy_process_group()


def _shard_bytes(shardings, shapes, dtypes) -> dict:
    """Leaf path -> bytes of the reference's shard of each leaf."""
    out = {}

    def one(path, sh, shape):
        key = jax.tree_util.keystr(path)
        out[key] = math.prod(sh.shard_shape(tuple(shape.shape))) \
            * np.dtype(dtypes(key, shape)).itemsize
    jax.tree_util.tree_map_with_path(one, shardings, shapes)
    return out


ARG_ARCHS = ["qwen2_5_14b", "olmoe_1b_7b", "llava_next_mistral_7b",
             "whisper_large_v3"]
# leaves whose dtype differs between the packages in these smoke configs
# (each stores its parameters in float32 in both): none
DTYPE_DIFFERS: dict = {}


@pytest.mark.parametrize("shape,names", MESHES)
def test_dryrun_argument_bytes_match_reference_shardings(shape, names):
    """A smoke train cell's ``argument_bytes`` equals the sum of the
    reference's ``NamedSharding(AbstractMesh, spec).shard_shape`` bytes of
    ``state_shardings`` and ``batch_shardings``, leaf dtypes from the
    port's state (those that differ from the reference's named in
    DTYPE_DIFFERS)."""
    jmesh = AbstractMesh(shape, names)
    jacfg = jopt.AdamWConfig()
    with dryrun.fake_process_group(8):
        for arch in ARG_ARCHS:
            r = dryrun.run_cell(arch, "train_4k", False,
                                cfg_override=smoke_config(arch),
                                cell=SMOKE_CELL, mesh_shape=shape)
            jcfg = jbase.smoke_config(arch)
            pshapes, axes = reference_axes(arch)
            jsh = jstate_shardings(jcfg, axes, jmesh, pshapes, jacfg)
            oshapes = jax.eval_shape(lambda p: jopt.adamw_init(p, jacfg),
                                     pshapes)
            state = {"params": pshapes, "opt": oshapes}
            pdt = jnp.dtype(smoke_config(arch).dtype)
            differs = {}

            def dtypes(key, s):
                # the port stores its parameters in the compute dtype
                want = pdt if key.startswith("['params']") else s.dtype
                if np.dtype(want) != np.dtype(s.dtype):
                    differs[key] = (str(s.dtype), str(want))
                return want
            total = sum(_shard_bytes(jsh, state, dtypes).values())
            batch = jbase.input_specs(jcfg, jbase.ShapeCell(
                "train_4k", SMOKE_CELL.seq_len, SMOKE_CELL.global_batch,
                "train"))
            with jshd.activate(None):
                bsh = jbatch_shardings(batch, jmesh)
            total += sum(_shard_bytes(bsh, batch,
                                      lambda k, s: s.dtype).values())
            assert differs == DTYPE_DIFFERS.get(arch, {}), (arch, differs)
            assert r["memory"]["argument_bytes"] == total, (arch, shape)
            assert r["memory"]["alias_bytes"] < total


def test_dryrun_flops_on_meta_equal_a_cpu_run():
    """The same smoke train cells (dense and MoE, the MoE router's sums
    over data 2) counted on ``meta`` and on CPU tensors: equal FLOPs,
    collective bytes and peak bytes; ``FlopCounterMode`` agrees with the
    walk."""
    with dryrun.fake_process_group(8):
        for arch in ("gemma3_1b", "olmoe_1b_7b"):
            kw = dict(cfg_override=smoke_config(arch), cell=SMOKE_CELL,
                      mesh_shape=(2, 4))
            meta = dryrun.run_cell(arch, "train_4k", False, **kw)
            cpu = dryrun.run_cell(arch, "train_4k", False, device="cpu",
                                  **kw)
            assert meta["hlo"]["flops"] > 0
            for r in (meta, cpu):
                assert r["cost_analysis"]["flops"] == r["hlo"]["flops"]
            assert cpu["hlo"] == meta["hlo"], arch
            assert cpu["memory"] == meta["memory"], arch


def test_dryrun_cells_of_every_kind():
    """gemma3-1b's and hymba's smoke configs in a prefill and a decode cell
    on (2, 4): the reference's keys, the roofline's chips the mesh's, the
    decode cache aliased, a pure full-attention model skipped at
    long_500k; ``flash_decode_shards`` splits the pools, and its decode
    all-reduces over model."""
    with dryrun.fake_process_group(8):
        for arch in ("gemma3_1b", "hymba_1_5b"):
            for shape in ("prefill_32k", "decode_32k"):
                cell = ShapeCell(shape, 64, 8, SHAPES[shape].kind)
                r = dryrun.run_cell(arch, shape, False,
                                    cfg_override=smoke_config(arch),
                                    cell=cell, mesh_shape=(2, 4))
                assert {"memory", "cost_analysis", "hlo", "roofline",
                        "timings"} <= set(r)
                assert r["roofline"]["chips"] == 8
                assert r["memory"]["fits"]
                m = r["memory"]
                assert m["per_device_total"] == m["argument_bytes"] \
                    + m["output_bytes"] + m["temp_bytes"] - m["alias_bytes"]
                assert m["plain_total"] >= m["per_device_total"]
                if shape == "decode_32k":
                    assert m["alias_bytes"] > 0
        cfg = smoke_config("qwen2_5_14b")
        cell = ShapeCell("decode_32k", 64, 8, "decode")
        whole = dryrun.run_cell("qwen2_5_14b", "decode_32k", False,
                                cfg_override=cfg, cell=cell,
                                mesh_shape=(2, 4))
        split = dryrun.run_cell(
            "qwen2_5_14b", "decode_32k", False,
            cfg_override=cfg.replace(flash_decode_shards=True), cell=cell,
            mesh_shape=(2, 4))
        assert split["memory"]["argument_bytes"] < \
            whole["memory"]["argument_bytes"]
        assert split["hlo"]["coll_bytes"]["all-reduce"] > 0
        assert "all-reduce" not in whole["hlo"]["coll_bytes"]
        assert "skipped" in dryrun.run_cell("qwen2_5_14b", "long_500k",
                                            False)


def test_dryrun_cli_prints_memory_fits_and_roofline(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on a full-size decode cell
    of the 16 x 16 mesh: one cell written, its memory, ``fits`` and
    roofline printed, exit 0."""
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma3-1b", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(out)], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "fits=True" in p.stdout and "bound=" in p.stdout
    r = json.loads(out.read_text())["gemma3-1b|decode_32k|single"]
    assert r["roofline"]["chips"] == 256
    assert r["memory"]["per_device_total"] > r["memory"]["argument_bytes"]


def test_report_prints_the_reference_tables():
    """``dryrun_table`` and ``roofline_table`` print the reference's
    Markdown for the same results: a cell that ran, one that failed, one
    skipped and the missing rest."""
    rf = roofline.Roofline(1e12, 2e9, 3e8, model_flops=5e13, chips=256)
    results = {
        "gemma3_1b|train_4k|single": {
            "memory": {"per_device_total": 3 * 2**30},
            "hlo": {"flops": 1.5e12, "coll_bytes_effective": 4.2e8},
            "timings": {"compile_s": 7.2}, "roofline": rf.to_dict()},
        "qwen2_5_14b|prefill_32k|multi": {
            "error": "RuntimeError: " + "x" * 60},
        "qwen2_5_14b|long_500k|single": {"skipped": "full attention"},
    }
    for mesh in ("single", "multi"):
        assert report.dryrun_table(results, mesh) == \
            jreport.dryrun_table(results, mesh)
    assert report.roofline_table(results) == jreport.roofline_table(results)
