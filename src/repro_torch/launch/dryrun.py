"""Multi-pod dry run on the ``meta`` device: every (arch x shape x mesh)
cell of the port, one rank's step, with nothing allocated.

Port of ``repro.launch.dryrun``, which lowers and compiles each cell for
512 placeholder host devices against ``ShapeDtypeStruct``s.  The port runs
the cell's step eagerly instead, as one rank of the production mesh:

  * a fake process group (``torch.testing._internal.distributed.fake_pg``:
    its collectives return at once and move nothing) of 512 ranks with
    this process as rank 0, and ``make_production_mesh(device_type="cpu")``
    on it (16 x 16 ranks, or 2 x 16 x 16 with ``--mesh multi``);
  * every tensor on the ``meta`` device (shapes and dtypes, no storage);
    the kernels' plain versions (``kernels/ops.py``) stand in for the
    kernels there and compute shapes only.

Each cell runs what the port runs on that rank:

  * ``train``: the state on ``meta`` laid out by ``shard_state(state,
    state_shardings(...))`` and one real ``make_train_step(cfg,
    mesh=...)`` step on ``input_specs``' batch (pod compression off unless
    ``--compressed``, as the reference);
  * ``prefill``: the parameters sharded by ``param_shardings``, in the
    mesh step's work copy (``train_loop.work_copy``, a tensor-parallel
    local copy: each ``model``-split weight this rank's ``model`` shard;
    the blocks' weights this rank's shards, each block gathered over
    ``data`` in the layer loop and freed after it, ``fsdp.run_block``; the
    rest gathered), then ``forward(..., last_only=True)`` on this rank's
    slice of the batch under ``tensor_parallel.activate``;
  * ``decode``: the parameters held as a local copy whole over ``data``
    (``work_copy(..., blocks_sharded=False)``, this rank's ``model``
    shards: a serving replica keeps them so across steps, where the
    reference's compiled decode step gathers a block at a time); this
    rank's slice of the batch (a data-parallel replica serves
    its own sequences) and its cache as the port lays it out under the
    mesh (pools split over ``model`` under ``flash_decode_shards``, else
    whole; hymba's conv and SSM states and xLSTM's cell states on the
    rank's channels and heads), then one tensor-parallel ``decode_step``
    (q, k, v gathered to whole heads, ``wo``, the MLP, the Mamba and
    xLSTM inner dimensions and the head split).

One dispatch walk of the step (:class:`repro_torch.launch.op_analysis.OpWalk`)
under ``FlopCounterMode`` gives the reference's keys:

  * ``memory``: ``argument_bytes`` (this rank's shards of the state or
    parameters, its cache and its slice of the inputs), ``output_bytes``,
    ``alias_bytes`` (outputs that are arguments updated in place),
    ``temp_bytes`` and ``per_device_total`` = argument + output + temp -
    alias, which is the largest the rank holds with the kernels in place;
    ``fits`` compares it with the card's 80 GB.  The plain versions'
    own temporaries, which the kernels never hold (the plain flash
    attention's (B, H, S, S) scores, the plain paged attention's copy of
    the pages it reads), are left out of it and stated beside it:
    ``plain_attention_bytes`` (the most they held at once) and
    ``plain_total`` (the largest the rank held with them);
  * ``cost_analysis``: ``FlopCounterMode``'s FLOPs and the walk's bytes;
  * ``hlo``: the walk's FLOPs and collective bytes (by kind, and
    ring-factor-adjusted as ``coll_bytes_effective``) and its bytes with
    each plain attention call counted as the kernel's one round trip
    (``plain_attention`` holds what the plain versions' own ops counted).
    The FLOPs are the plain versions' full products, masked tiles
    included, as the reference's ``use_pallas="ref"`` lowering counts
    them;
  * ``roofline``: ``roofline.Roofline`` with the f32 or the bf16 peak by
    the cell's compute dtype (``peaks`` names them);
  * ``timings``: ``lower_s`` the seconds to build the cell on ``meta``,
    ``compile_s`` the seconds of the traced meta step (the reference's
    lowering and XLA compile; here the step itself is the trace).

Where the port's layout differs from the reference's sharded step, the dry
run measures the port; a cell the port cannot run records ``error``, and
``long_500k`` keeps the reference's ``skipped`` rule.  Results append to
the ``--out`` JSON file, so the sweep is resumable.  The CLI owns its fake
process group for the whole process; a library caller runs cells inside
:func:`fake_process_group`, which ends it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out build/dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs.base import (SHAPES, get_config, input_specs,
                                      list_archs)
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.interop import param_axes
from repro_torch.launch import op_analysis, roofline
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.model import build_model, family_module
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import (batch_shardings, load_work,
                                             make_train_step, shard_state,
                                             state_shardings, work_copy)

WORLD = 512          # ranks of the fake group: both production meshes fit
META = torch.device("meta")
# the kernels' plain versions that stand in for them on meta
STAND_INS = ("flash_attention_ref", "flash_attention_lse_ref",
             "flash_attention_bwd_ref", "paged_attention_ref",
             "paged_attention_lse_ref")

__all__ = ["build_cell", "fake_process_group", "main", "run_cell"]


@contextlib.contextmanager
def fake_process_group(world_size: int = WORLD):
    """A fake process group of ``world_size`` ranks in this process (rank
    0), ended on exit.  It cannot share the process with another group (the
    mesh phases' NCCL group): run it in a process of its own there."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _stand_ins(walk):
    """Book the plain attention versions' temporaries apart in ``walk``
    (:meth:`OpWalk.stand_in`): the kernels never hold them."""
    from repro_torch.kernels import ref

    saved = {n: getattr(ref, n) for n in STAND_INS}
    for n, fn in saved.items():
        setattr(ref, n, walk.stand_in(fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ref, n, fn)


def _empty_model(cfg, max_seq: int, device):
    """The model of ``cfg`` on ``device`` without the weights' random draw
    (a ``meta`` generator draws nothing): on ``meta`` shapes only, on a
    real device zeros."""
    _, cls = family_module(cfg)
    model = cls(cfg, max_seq=max_seq, device=device)
    if device.type != "meta":
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
    return model


def _inputs(cfg, cell, device) -> dict:
    """``input_specs`` on ``device`` (zeros on a real device)."""
    batch = input_specs(cfg, cell, device)
    if device.type != "meta":
        for t in batch.values():
            t.zero_()
    return batch


def _local(t, sharding=None) -> torch.Tensor:
    """The slice of ``t`` this rank holds: a DTensor's local shard, a plain
    tensor's slice under ``sharding`` (whole without one)."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        return t.to_local()
    if sharding is None:
        return t
    return shd.local_slice(t, sharding.mesh, sharding.spec)


def _tensors(tree) -> list:
    """The tensors of ``tree`` (dicts, sequences, ``Tagged`` entries and a
    module's parameters), each as the local tensor this rank holds."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.utils import Tagged

    out = []
    for x in tree_leaves(tree, is_leaf=lambda v: isinstance(
            v, (Tagged, torch.nn.Module))):
        if isinstance(x, Tagged):
            out += _tensors(x.value)
        elif isinstance(x, torch.nn.Module):
            out += [_local(p) for p in x.parameters()]
        elif isinstance(x, torch.Tensor):
            out.append(_local(x))
    return out


def _batch_slice(batch, mesh) -> dict:
    """This rank's slice of every batch tensor (dim 0 over the batch axes
    that divide it, ``batch_shardings``)."""
    sh = batch_shardings(batch, mesh)
    return {k: _local(v, sh[k]) for k, v in batch.items()}


def build_cell(cfg, cell, mesh, rules=None, pod_compression=False,
               microbatches: int = 1, device=META):
    """``(step, args, argument_tensors, alias)`` for one cell on ``device``
    (``meta``; a real device runs the same step on zeros):
    ``step(*args)`` runs the rank's step; ``argument_tensors`` are the
    tensors this rank holds before it (its shards, cache and inputs);
    ``alias(out)`` the output tensors that are arguments updated in
    place."""
    with shd.activate(mesh, rules):
        if cell.kind == "train":
            model = _empty_model(cfg, cell.seq_len, device)
            acfg = opt.AdamWConfig(pod_compression=(
                pod_compression and "pod" in mesh.mesh_dim_names))
            state = {"params": model, "opt": opt.adamw_init(model, acfg)}
            state = shard_state(state, state_shardings(
                cfg, param_axes(model), mesh, model, acfg))
            batch = _inputs(cfg, cell, device)
            local = _batch_slice(batch, mesh)
            step = make_train_step(cfg, build_model(cfg, device), adamw=acfg,
                                   mesh=mesh, microbatches=microbatches)
            held = _tensors(state) + list(local.values())
            return (step, (state, batch), held, lambda out: _tensors(out[0]))

        model = _empty_model(cfg, cell.seq_len, device)
        p_sh = shd.param_shardings(param_axes(model), mesh,
                                   shapes=dict(model.named_parameters()))
        if cell.kind == "prefill":
            model = shard_state({"params": model, "opt": {}},
                                {"params": p_sh})["params"]
            local = _batch_slice(_inputs(cfg, cell, device), mesh)
            mod_, _ = family_module(cfg)

            @torch.no_grad()
            def prefill_step(model, batch):
                work = work_copy(cfg, model, mesh).requires_grad_(False)
                load_work(cfg, work, model, mesh)
                with tp.activate(mesh):
                    logits, _ = mod_.forward(cfg, work, batch,
                                             last_only=True)
                return logits

            held = _tensors(model) + list(local.values())
            return prefill_step, (model, local), held, lambda out: []

        # decode: the local copy, this rank's sequences
        sharded = shard_state({"params": model, "opt": {}},
                              {"params": p_sh})["params"]
        model = work_copy(cfg, sharded, mesh, blocks_sharded=False
                          ).requires_grad_(False)
        load_work(cfg, model, sharded, mesh)
        del sharded
        api = build_model(cfg, device)
        local = _batch_slice(_inputs(cfg, cell, device), mesh)
        with tp.activate(mesh):
            cache = api.init_decode_cache(local["tokens"].shape[0],
                                          cell.seq_len)

        def serve_step(model, cache, tokens):
            with tp.activate(mesh):
                return api.decode_step(model, cache, tokens)

        held = _tensors(model) + _tensors(cache) + [local["tokens"]]
        return (serve_step, (model, cache, local["tokens"]), held,
                lambda out: _tensors(out[1]))


def _unique_bytes(tensors) -> int:
    """Bytes of ``tensors``, a tensor seen twice (the same storage, offset
    and shape) counted once; a slice counts its own elements."""
    seen, n = set(), 0
    for t in tensors:
        key = (id(t.untyped_storage()), t.storage_offset(), tuple(t.shape))
        if key not in seen:
            seen.add(key)
            n += t.numel() * t.element_size()
    return n


def run_cell(arch: str, shape: str, multi_pod: bool, rules=None,
             cfg_override=None, pod_compression=False,
             microbatches: int = 1, *, cell=None, mesh_shape=None,
             device=META):
    """One cell's record (see the module).  ``cell`` (a ``ShapeCell``)
    replaces ``SHAPES[shape]`` and ``mesh_shape`` the production mesh (its
    axes ``data``, ``model``, with a leading ``pod`` for three) for a
    cell of another size; ``device`` other than ``meta`` runs the same
    step on zeros there (small cells: a check of the meta walk).  Needs a
    process group of enough ranks: run it under
    :func:`fake_process_group`."""
    from torch.utils.flop_counter import FlopCounterMode

    cell = cell or SHAPES[shape]
    cfg = cfg_override or get_config(arch)
    cfg = cfg.replace(use_pallas="ref")
    mesh_name = ("multi" if multi_pod else "single") if mesh_shape is None \
        else "x".join(map(str, mesh_shape))
    out = {"arch": arch, "shape": shape, "mesh": mesh_name}
    if not cfg.supports_cell(cell):
        out["skipped"] = ("long_500k needs sub-quadratic attention; "
                          f"{arch} is pure full-attention (see DESIGN.md)")
        return out
    if not dist.is_initialized():
        raise RuntimeError("the dry run needs a process group: run it under "
                           "fake_process_group()")
    if mesh_shape is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    else:
        axes = ("data", "model") if len(mesh_shape) == 2 \
            else ("pod", "data", "model")
        mesh = make_mesh(mesh_shape, axes, "cpu")
    t0 = time.perf_counter()
    fn, args, held, alias = build_cell(
        cfg, cell, mesh, rules, pod_compression=pod_compression,
        microbatches=microbatches, device=torch.device(device))
    t_lower = time.perf_counter() - t0
    t0 = time.perf_counter()
    with shd.activate(mesh, rules), FlopCounterMode(display=False) as fc, \
            op_analysis.OpWalk() as walk, _stand_ins(walk):
        res = fn(*args)
    t_compile = time.perf_counter() - t0

    arg_b = _unique_bytes(held)
    held_ids = {id(t.untyped_storage()) for t in held}
    outs = _tensors(res)
    aliased = [t for t in alias(res) if id(t.untyped_storage()) in held_ids]
    out_b = _unique_bytes(outs)
    alias_b = _unique_bytes(aliased)
    total = arg_b + walk.kernel_peak_bytes
    new_out = max(out_b - alias_b, 0)
    out["memory"] = {
        "argument_bytes": arg_b,
        "output_bytes": out_b,
        "temp_bytes": total - arg_b - new_out,
        "alias_bytes": alias_b,
        "per_device_total": total,
        "fits": total <= roofline.HBM_BYTES,
        "plain_attention_bytes": walk.stand_in_bytes,
        "plain_total": arg_b + walk.peak_bytes,
    }
    out["cost_analysis"] = {"flops": float(fc.get_total_flops()),
                            "bytes_accessed": walk.cost.mem_bytes}
    hc = walk.cost
    out["hlo"] = {"flops": hc.flops, "mem_bytes": walk.kernel_mem_bytes,
                  "coll_bytes": hc.coll_bytes,
                  "coll_bytes_effective": hc.total_coll_bytes,
                  "plain_attention": {
                      "flops": walk.stand_in_cost.flops,
                      "mem_bytes": walk.stand_in_cost.mem_bytes}}
    rf = roofline.Roofline(
        flops_per_device=hc.flops,
        mem_bytes_per_device=walk.kernel_mem_bytes,
        coll_bytes_per_device=hc.total_coll_bytes,
        model_flops=roofline.model_flops_for_cell(cfg, cell),
        chips=int(mesh.size()),
        peak_flops=roofline.peak_flops_for(cfg.dtype))
    out["roofline"] = rf.to_dict()
    out["peaks"] = {"flops": rf.peak_flops, "hbm_bw": rf.hbm_bw,
                    "link_bw": rf.link_bw, "hbm_bytes": roofline.HBM_BYTES,
                    "dtype": cfg.dtype}
    out["timings"] = {"lower_s": t_lower, "compile_s": t_compile}
    out["ops"] = walk.n_ops
    return out


def _run_cell_subprocess(arch, shape, mp, timeout=1500):
    """Isolate one cell in a child process: a crash or a hang then costs
    one cell, not the sweep."""
    import subprocess
    import sys
    import tempfile
    with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as f:
        tmp = f.name
    Path(tmp).unlink(missing_ok=True)      # child must not read it as JSON
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape,
           "--mesh", "multi" if mp else "single", "--out", tmp, "--force"]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
        data = json.loads(Path(tmp).read_text()) if Path(tmp).exists() \
            else {}
        key = f"{arch}|{shape}|{'multi' if mp else 'single'}"
        if key in data:
            return data[key]
        return {"arch": arch, "shape": shape,
                "mesh": "multi" if mp else "single",
                "error": f"subprocess died rc={p.returncode}",
                "traceback": (p.stderr or "")[-2000:]}
    except subprocess.TimeoutExpired:
        return {"arch": arch, "shape": shape,
                "mesh": "multi" if mp else "single",
                "error": "subprocess timeout"}
    finally:
        Path(tmp).unlink(missing_ok=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--subproc", action="store_true",
                    help="isolate each cell in a child process")
    ap.add_argument("--compressed", action="store_true",
                    help="enable int8-EF pod compression in train cells")
    args = ap.parse_args()

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = {}
    out_path = Path(args.out) if args.out else None
    if out_path and out_path.exists():
        try:
            results = json.loads(out_path.read_text())
        except json.JSONDecodeError:
            results = {}

    if not args.subproc:    # this process's group, for its whole life
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=WORLD)
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = f"{arch}|{shape}|{'multi' if mp else 'single'}"
                if key in results and not args.force \
                        and "error" not in results[key]:
                    print(f"[skip cached] {key}")
                    continue
                print(f"[dryrun] {key} ...", flush=True)
                if args.subproc:
                    r = _run_cell_subprocess(arch, shape, mp)
                else:
                    try:
                        r = run_cell(arch, shape, mp,
                                     pod_compression=args.compressed)
                    except Exception as e:
                        r = {"arch": arch, "shape": shape,
                             "mesh": "multi" if mp else "single",
                             "error": f"{type(e).__name__}: {e}",
                             "traceback": traceback.format_exc()[-2000:]}
                results[key] = r
                if out_path:
                    out_path.parent.mkdir(parents=True, exist_ok=True)
                    out_path.write_text(json.dumps(results, indent=1))
                if "error" in r:
                    print(f"  ERROR: {r['error']}")
                elif "skipped" in r:
                    print(f"  SKIPPED: {r['skipped']}")
                else:
                    m = r["memory"]
                    rf = r["roofline"]
                    print(f"  ok mem/dev={m['per_device_total'] / 2**30:.2f}"
                          f"GiB fits={m['fits']} (plain attention "
                          f"{m['plain_attention_bytes'] / 2**30:.2f}GiB "
                          f"more) bound={rf['bound']} "
                          f"compute={rf['compute_s']:.4f}s "
                          f"mem={rf['memory_s']:.4f}s "
                          f"coll={rf['collective_s']:.4f}s "
                          f"roofline={rf['roofline_fraction']:.4f} "
                          f"(traced {r['timings']['compile_s']:.1f}s)")
    n_err = sum(1 for r in results.values() if "error" in r)
    print(f"done: {len(results)} cells, {n_err} errors")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
