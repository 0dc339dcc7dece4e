#!/usr/bin/env python3
"""How far two plain train steps that differ only in the order of their
sums drift apart, for the cells of ``chip_smoke.MESH_TP_CELLS`` on one
NVIDIA GPU: the floor under which a tensor-parallel run cannot be told
from the plain one.

    python3 tools/torch_tp_floor.py [ARCH ...] [--eps E ...] [--seed 0]

For each cell (all by default), ``MESH_TRAIN_STEPS`` plain steps with the
cell's config, optimizer and batches, run twice from the same weights: on
the whole batch, and on the batch in 2 microbatches (the gradient the
mean of the halves': the same sum in another order).  Prints the losses
and gradient norms of both runs and the four largest relative errors (in
norm) of a parameter's update, chained over the steps and, from the same
state, for each step alone (the second run's step taken from the first
run's state before it, and that step's gradient norm).  ``--eps`` runs it
for each AdamW epsilon given (the cell's own by default).  Prints the
card's name and power limit first; results go to
``chiprun_out/tp_floor.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def rel_errs(a: dict, b: dict, init: dict) -> list:
    """The four largest ``|(b - init) - (a - init)| / |a - init|``."""
    out = {}
    for n, p in a.items():
        want = p.detach().double() - init[n]
        got = b[n].detach().double() - init[n]
        out[n] = float((got - want).norm()
                       / want.norm().clamp(min=1e-30).detach())
    return sorted(out.items(), key=lambda kv: -kv[1])[:4]


def floor(arch: str, seed: int, eps=None) -> dict:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step

    dev = torch.device("cuda")
    cell = cs.MESH_TP_CELLS[arch]
    B, S = cell["B"], cell["S"]
    cfg = get_config(arch).replace(n_layers=cell["layers"], dtype="float32")
    api = build_model(cfg, dev)
    acfg = cs.mesh_tp_adamw(arch)
    if eps is not None:
        acfg = dataclasses.replace(acfg, eps=eps)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    batches = [{"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                        device=dev, dtype=torch.int32)}
               for _ in range(cs.MESH_TRAIN_STEPS)]

    def fresh():
        model = api.init(seed, S).requires_grad_(True)
        return {"params": model, "opt": opt.adamw_init(model, acfg)}

    def snapshot(st):
        return {"params": {n: p.detach().clone() for n, p in
                           st["params"].named_parameters()},
                "mu": {n: x.clone() for n, x in st["opt"]["mu"].items()},
                "nu": {n: x.clone() for n, x in st["opt"]["nu"].items()}}

    whole = make_train_step(cfg, api, adamw=acfg)
    halves = make_train_step(cfg, api, adamw=acfg, microbatches=2)
    a, b = fresh(), fresh()
    init = {n: p.detach().double() for n, p in
            a["params"].named_parameters()}
    ma, mb, per_step, step_norms = [], [], [], []
    for t, batch in enumerate(batches):
        before = snapshot(a)
        a, m = whole(a, batch)
        ma.append({k: float(v) for k, v in m.items()})
        b, m = halves(b, batch)
        mb.append({k: float(v) for k, v in m.items()})
        # the second run's step alone, from the first run's state
        c = fresh()
        with torch.no_grad():
            for n, p in c["params"].named_parameters():
                p.copy_(before["params"][n])
            for k in ("mu", "nu"):
                for n, x in c["opt"][k].items():
                    x.copy_(before[k][n])
            c["opt"]["step"].fill_(t)
        c, m = halves(c, batch)
        step_norms.append(float(m["grad_norm"]))
        start = {n: p.double() for n, p in before["params"].items()}
        per_step.append(rel_errs(
            dict(a["params"].named_parameters()),
            dict(c["params"].named_parameters()), start))
        del c, before, start
        torch.cuda.empty_cache()
    return dict(losses=[m["loss"] for m in ma],
                grad_norms=[m["grad_norm"] for m in ma],
                microbatch_losses=[m["loss"] for m in mb],
                microbatch_grad_norms=[m["grad_norm"] for m in mb],
                chained=rel_errs(dict(a["params"].named_parameters()),
                                 dict(b["params"].named_parameters()),
                                 init),
                per_step=per_step, per_step_grad_norms=step_norms,
                eps=acfg.eps)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("archs", nargs="*")
    ap.add_argument("--eps", type=float, nargs="*", default=[None])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("torch_tp_floor: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    out = {}
    for arch, eps in itertools.product(args.archs or list(cs.MESH_TP_CELLS),
                                       args.eps):
        r = floor(arch, args.seed, eps)
        out[f"{arch} eps {r['eps']}"] = r
        print(f"{arch}, eps {r['eps']}: losses {r['losses']} / "
              f"{r['microbatch_losses']}; "
              f"grad norms {r['grad_norms']} / "
              f"{r['microbatch_grad_norms']}; updates chained "
              f"{r['chained']}; each step from the same state "
              f"{r['per_step']} (grad norms {r['per_step_grad_norms']})",
              flush=True)
        torch.cuda.empty_cache()
    d = ROOT / "chiprun_out"
    d.mkdir(exist_ok=True)
    (d / "tp_floor.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
