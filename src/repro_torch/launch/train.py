"""Train an architecture on one device or a mesh: ``--arch <id>``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --smoke --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --seq 1024 --batch 4 --steps 8
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
        --arch gemma3-1b --mesh 2x4

Port of ``repro.launch.train``, with its flags and its ``dtype="float32"``
override: random weights from seed 0, a ``Loader`` over a synthetic
corpus of 1,000,000 tokens in ``--workdir`` (made once), AdamW (warm-up
10 steps, cosine to ``--steps``) through ``make_train_step`` and the
fault-tolerant ``run_training``, checkpoints in ``<workdir>/ckpt`` every
25 steps (a run resumes from its ``LATEST``).  Prints the parameter count,
the loss every 10 steps with tokens/s, and the final loss.  It runs on
CUDA unless ``--device`` names another device.

``--mesh DxM`` trains on a (data=D, model=M) mesh over every rank of the
process group (``D * M`` must be the world size): the state sharded by
``state_shardings`` and the mesh step of ``make_train_step``.  With no
process group yet it starts one from torchrun's environment (``env://``):
NCCL on CUDA, each rank on the card of its ``LOCAL_RANK``, gloo on the CPU.
Rank 0 alone makes the corpus, prints and writes checkpoints.  A
``DxM`` mesh has no ``pod`` axis, so ``--pod-compression`` only adds the
``ef`` residual to the state, as in the reference.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.data import DataConfig, Loader, TokenStore, synth_corpus
from repro_torch.distributed import sharding as shd
from repro_torch.interop import param_axes
from repro_torch.kernels.build import REPO_ROOT
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import build_model, count_params
from repro_torch.training import optimizer as opt
from repro_torch.training.fault_tolerance import (TrainRunResult,
                                                  run_training)
from repro_torch.training.train_loop import (make_train_step, shard_state,
                                             state_shardings)
from repro_torch.utils import resolve_device

CORPUS_TOKENS = 1_000_000


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--workdir", default=str(REPO_ROOT / "build" / "train"))
    ap.add_argument("--mesh", default=None,
                    help="e.g. '2x4' -> (data=2, model=4)")
    ap.add_argument("--pod-compression", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap


def run(args: argparse.Namespace, **loop_kw) -> TrainRunResult:
    """Train as ``args`` say; returns ``run_training``'s result.
    ``loop_kw`` override ``run_training``'s keyword arguments: a caller
    may pass ``ckpt_dir=None`` to train without checkpoints (a full-size
    gemma3-1b checkpoint is 12 GB of disk), a ``failure_injector``, or an
    ``on_metrics`` in place of the loss line."""
    device = resolve_device(args.device)
    mesh = None
    if args.mesh:
        device, mesh = _mesh(args.mesh, device)
    lead = mesh is None or dist.get_rank() == 0
    cfg = (smoke_config(args.arch) if args.smoke
           else get_config(args.arch)).replace(dtype="float32")
    api = build_model(cfg, device)

    wd = Path(args.workdir)
    corpus = wd / "corpus.bin"
    if lead and not corpus.exists():
        synth_corpus(corpus, n_tokens=CORPUS_TOKENS, vocab=cfg.vocab)
    if mesh is not None:
        dist.barrier()
    loader = Loader(TokenStore.open(corpus),
                    DataConfig(seq_len=args.seq, global_batch=args.batch))
    acfg = opt.AdamWConfig(lr=args.lr, warmup=10, total_steps=args.steps,
                           pod_compression=args.pod_compression)

    def batch_for_step(s):
        return {"tokens": torch.from_numpy(
            loader.batch_for_step(s)["tokens"]).to(api.device)}

    shardings = None

    def fresh_state():
        nonlocal shardings
        model = api.init(0, args.seq)
        model.requires_grad_(True)
        state = {"params": model, "opt": opt.adamw_init(model, acfg)}
        if mesh is None:
            return state
        shardings = shardings or state_shardings(
            cfg, param_axes(model), mesh, model, acfg)
        return shard_state(state, shardings)

    first = [fresh_state()]

    def init_state():
        return first.pop() if first else fresh_state()

    if lead:
        print(f"[train] {cfg.name}: "
              f"{count_params(first[0]['params']) / 1e6:.1f}M params on "
              f"{api.device}" + (f", mesh {args.mesh} (data x model) of "
                                 f"{dist.get_world_size()} ranks"
                                 if mesh is not None else ""))
    step = make_train_step(cfg, api, adamw=acfg,
                           microbatches=args.microbatches, mesh=mesh)
    t0 = time.time()

    def on_metrics(s, m):
        if lead and s % 10 == 0:
            print(f"step {s:5d} loss {m['loss']:.4f} "
                  f"({s * args.batch * args.seq / (time.time() - t0):,.0f} "
                  "tok/s)")

    loop_kw = {"ckpt_dir": wd / "ckpt", "ckpt_every": 25,
               "on_metrics": on_metrics, "shardings": shardings, **loop_kw}
    with (shd.activate(mesh) if mesh is not None
          else contextlib.nullcontext()):
        res = run_training(step, init_state, batch_for_step, args.steps,
                           **loop_kw)
    dt = time.time() - t0
    n = len(res.metrics_history)
    if n and lead:
        print(f"[train] finished at step {res.step}, final loss "
              f"{res.metrics_history[-1]['loss']:.4f}, "
              f"{n * args.batch * args.seq / dt:,.0f} tok/s over {n} steps")
    return res


def _mesh(spec: str, device: torch.device):
    """The (data, model) mesh ``spec`` ("DxM") over every rank, and this
    rank's device; starts the process group from torchrun's environment
    when there is none."""
    d, m = (int(x) for x in spec.split("x"))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        cuda = device.type == "cuda"
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method="env://",
                                device_id=device if cuda else None)
    if d * m != dist.get_world_size():
        raise ValueError(f"--mesh {spec}: {d * m} ranks, the process group "
                         f"has {dist.get_world_size()}")
    return device, make_mesh((d, m), ("data", "model"), device.type)


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
