"""Train an architecture on one device: ``--arch <id>``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --smoke --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --seq 1024 --batch 4 --steps 8

Port of ``repro.launch.train``, with its flags and its ``dtype="float32"``
override: random weights from seed 0, a ``Loader`` over a synthetic
corpus of 1,000,000 tokens in ``--workdir`` (made once), AdamW (warm-up
10 steps, cosine to ``--steps``) through ``make_train_step`` and the
fault-tolerant ``run_training``, checkpoints in ``<workdir>/ckpt`` every
25 steps (a run resumes from its ``LATEST``).  Prints the parameter count,
the loss every 10 steps with tokens/s, and the final loss.  It runs on
CUDA unless ``--device`` names another device.  ``--mesh`` (and with it
``--pod-compression``'s reduction) waits for the ``distributed/`` slice
(ROADMAP.md §1) and raises.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.data import DataConfig, Loader, TokenStore, synth_corpus
from repro_torch.kernels.build import REPO_ROOT
from repro_torch.models.model import build_model, count_params
from repro_torch.training import optimizer as opt
from repro_torch.training.fault_tolerance import (TrainRunResult,
                                                  run_training)
from repro_torch.training.train_loop import make_train_step

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
                    help="e.g. '2x4' -> (data=2, model=4); not ported yet")
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
    if args.mesh:
        raise NotImplementedError(
            "--mesh waits for the distributed/ slice (ROADMAP.md §1)")
    cfg = (smoke_config(args.arch) if args.smoke
           else get_config(args.arch)).replace(dtype="float32")
    api = build_model(cfg, args.device)

    wd = Path(args.workdir)
    corpus = wd / "corpus.bin"
    if not corpus.exists():
        synth_corpus(corpus, n_tokens=CORPUS_TOKENS, vocab=cfg.vocab)
    loader = Loader(TokenStore.open(corpus),
                    DataConfig(seq_len=args.seq, global_batch=args.batch))
    acfg = opt.AdamWConfig(lr=args.lr, warmup=10, total_steps=args.steps,
                           pod_compression=args.pod_compression)

    def batch_for_step(s):
        return {"tokens": torch.from_numpy(
            loader.batch_for_step(s)["tokens"]).to(api.device)}

    def fresh_state():
        model = api.init(0, args.seq)
        model.requires_grad_(True)
        return {"params": model, "opt": opt.adamw_init(model, acfg)}

    first = [fresh_state()]

    def init_state():
        return first.pop() if first else fresh_state()

    print(f"[train] {cfg.name}: {count_params(first[0]['params']) / 1e6:.1f}"
          f"M params on {api.device}")
    step = make_train_step(cfg, api, adamw=acfg,
                           microbatches=args.microbatches)
    t0 = time.time()

    def on_metrics(s, m):
        if s % 10 == 0:
            print(f"step {s:5d} loss {m['loss']:.4f} "
                  f"({s * args.batch * args.seq / (time.time() - t0):,.0f} "
                  "tok/s)")

    loop_kw = {"ckpt_dir": wd / "ckpt", "ckpt_every": 25,
               "on_metrics": on_metrics, **loop_kw}
    res = run_training(step, init_state, batch_for_step, args.steps,
                       **loop_kw)
    dt = time.time() - t0
    n = len(res.metrics_history)
    if n:
        print(f"[train] finished at step {res.step}, final loss "
              f"{res.metrics_history[-1]['loss']:.4f}, "
              f"{n * args.batch * args.seq / dt:,.0f} tok/s over {n} steps")
    return res


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
