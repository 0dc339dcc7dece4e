#!/usr/bin/env python3
"""Time paged decode with and without shard-local flash-decoding on one
NVIDIA GPU, step by step, and the collectives it makes.

    python3 tools/torch_mesh_decode_times.py [--layers 4] [--steps 256]
        [--calls 2000] [--seed 0]

qwen2.5-14b at full width, ``--layers`` layers, bf16, B 2 (the shape of
``chip_smoke.py``'s ``flash_decode_shards`` phase): ``--steps`` steps of
``decode_step``, plain and then with ``flash_decode_shards``
under a (1, 1) data/model mesh of a world-1 NCCL group (a FileStore, no
network): ``prefill`` of the ``--steps`` tokens (one synchronise at the
end), each step's time on the host clock after a synchronise, and
``prefill`` once more; then
``--calls`` all-reduces of a (B, Hq) f32 tensor on the mesh's ``model``
group back to back (one synchronise at the end) and one at a time.
Before them it times what a first use costs: DTensor's import, a first
DTensor, and one decode step under the mesh.
Prints the card's name and power limit, both prefills' times, the medians
of the first and last 32 steps of each run and the all-reduces' time a
call; writes everything
to ``chiprun_out/mesh_decode_times.json``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_mesh_decode_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model

    cs.log(cs.nvidia_smi())
    build.build()
    build.lib()
    dev = torch.device("cuda")
    B, S = 2, args.steps
    cfg = get_config("qwen2.5-14b").replace(n_layers=args.layers,
                                            dtype="bfloat16")
    model = build_model(cfg, dev).init(args.seed + 3, max_seq=S)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 13)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev,
                         dtype=torch.int32)
    cs.start_world1()
    out = {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        out["nccl_setup_s"] = cs.warm_groups(mesh)
        # first-use costs, each timed alone: DTensor's import, one DTensor
        # made and read, and one decode step under the mesh
        t0 = time.perf_counter()
        import torch.distributed.tensor  # noqa: F401
        out["dtensor_import_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        shd.shard(torch.zeros((2, 4), device=dev),
                  shd.NamedSharding(mesh, (None, "model"))).to_local()
        torch.cuda.synchronize()
        out["first_dtensor_s"] = time.perf_counter() - t0
        fcfg = cfg.replace(flash_decode_shards=True)
        with shd.activate(mesh):
            t0 = time.perf_counter()
            cache = T.init_decode_cache(fcfg, B, S, dev)
            T.decode_step(fcfg, model, cache, toks[:, 0])
            torch.cuda.synchronize()
            out["first_mesh_step_s"] = time.perf_counter() - t0
            del cache
        cs.log(f"first use: import of DTensor {out['dtensor_import_s']:.3f} "
               f"s, a first DTensor {out['first_dtensor_s']:.3f} s, a first "
               f"decode step under the mesh {out['first_mesh_step_s']:.3f} s")
        for tag, c, m in (("plain", cfg, None), ("mesh", fcfg, mesh)):
            times = []
            with shd.activate(m):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                T.prefill(c, model, {"tokens": toks}, S)
                torch.cuda.synchronize()
                cold_s = time.perf_counter() - t0
                cache = T.init_decode_cache(c, B, S, dev)
                for t in range(S):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _, cache = T.decode_step(c, model, cache, toks[:, t])
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                del cache
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                T.prefill(c, model, {"tokens": toks}, S)
                torch.cuda.synchronize()
                prefill_s = time.perf_counter() - t0
            out[tag] = dict(
                step_ms=[x * 1e3 for x in times],
                first_ms=statistics.median(times[:32]) * 1e3,
                last_ms=statistics.median(times[-32:]) * 1e3,
                total_s=sum(times), prefill_s=prefill_s,
                first_prefill_s=cold_s)
            cs.log(f"{tag}: the first prefill of {S} tokens {cold_s:.3f} s; "
                   f"{S} decode steps in {sum(times):.3f} s, median "
                   f"{out[tag]['first_ms']:.3f} ms a step over the first 32 "
                   f"and {out[tag]['last_ms']:.3f} over the last 32; the "
                   f"same {S} steps through prefill (one synchronise at the "
                   f"end) {prefill_s:.3f} s")
        group = mesh.get_group("model")
        x = torch.zeros((B, cfg.n_heads), device=dev)
        for label, sync in (("back_to_back", False), ("one_at_a_time", True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.calls):
                dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
                if sync:
                    torch.cuda.synchronize()
            torch.cuda.synchronize()
            us = (time.perf_counter() - t0) / args.calls * 1e6
            out[f"all_reduce_us_{label}"] = us
            cs.log(f"all_reduce of a ({B}, {cfg.n_heads}) f32 tensor on the "
                   f"model group, {label.replace('_', ' ')}: {us:.3f} us a "
                   "call")
    finally:
        cs.stop_world1()
    out["nvidia_smi"] = cs.nvidia_smi()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "mesh_decode_times.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
