"""Serve an architecture with the BaM-paged KV engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --smoke --device cpu

Port of ``repro.launch.serve``.  Weights are random, drawn from seed 0;
the model runs in its config's compute dtype (bf16 at full size) on CUDA
unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.models.model import build_model, count_params
from repro_torch.serving import PagedKVManager, Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--hot-window", type=int, default=48)
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    api = build_model(cfg, args.device)
    model = api.init(0)
    print(f"[serve] {cfg.name}: {count_params(model) / 1e6:.1f}M params, "
          f"{cfg.dtype} on {api.device}")

    kv = PagedKVManager(keep_last=args.hot_window)
    eng = ServeEngine(cfg, model, batch_slots=args.slots,
                      max_seq=args.max_seq, kv_manager=kv,
                      device=api.device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(2, cfg.vocab, 12).tolist(),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)
    if api.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    if api.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in reqs)
    m = kv.metrics.summary()
    print(f"[serve] {toks} tokens in {dt:.3f} s over {eng.n_steps} engine "
          f"steps on {api.device}; paged-KV spilled {m['write_ops']:.0f} / "
          f"fetched {m['misses']:.0f} pages")
    return reqs


if __name__ == "__main__":
    main()
