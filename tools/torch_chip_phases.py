#!/usr/bin/env python3
"""Run chosen model phases of ``chip_smoke.py`` alone on one NVIDIA GPU.

    python3 tools/torch_chip_phases.py [queues] [faults] [taxi] [runtime] [attn]
        [attn_bwd] [serve:ARCH ...] [dvf:ARCH ...] [train_vs_cpu]
        [train:gemma3-1b] [train_ckpt] [mesh_train:gemma3-1b]
        [flash_decode_shards] [mesh_tp] [mesh_fsdp] [dryrun] [--seed 0]
        [--profile] [--src DIR]

``queues`` runs the two queue kernels' checks and times
(``chip_smoke.queue_kernel_phase``: ``sq_enqueue`` and ``wfq_drain`` bit
for bit against their plain versions), ``faults`` the fault-injected
rounds (fused and legacy, then with readahead; card against CPU, bit for
bit), ``taxi`` the taxi queries and scans (``--profile`` traces 64
wavefronts of the demand and readahead scans and prints the kernel
launches a wavefront) and ``runtime`` the multi-tenant runtime phase
(``--profile`` traces 8 partitioned rounds), each BaM kernel's
launches counted on each and required, ``attn`` the attention kernel
phase (every flash and paged case
against its plain version), ``attn_bwd`` the flash backward's (and the
forward's log-sum-exp) against their plain versions, timed beside SDPA's
backward, ``train_vs_cpu``, ``train:gemma3-1b`` (``--profile`` traces one
more step) and ``train_ckpt`` the training phases,
``mesh_train:gemma3-1b`` and ``flash_decode_shards`` the mesh phases (on
a world-1 NCCL group, started for them and ended after; ``--profile``
traces 16 decode steps with and without the mesh), ``mesh_tp`` the
tensor-parallel train steps of ``chip_smoke.MESH_TP_CELLS`` (gemma3-1b,
hymba-1.5b, xlstm-1.3b) and ``mesh_fsdp:gemma3-1b`` (ZeRO-3 block by block
on a (2, 1) mesh, held against the gemma3-1b cell's plain steps) in two
processes sharing the card over gloo, each cell held against its plain
steps, ``mesh_fsdp`` the FSDP cell alone (its own plain steps) with the
dry run's child, whose prediction of the cell's peak it holds within
``chip_smoke.DRYRUN_BAND`` (after ``mesh_train:gemma3-1b``, which it runs
when it has not run yet), ``dryrun`` the dry
run's child process held against ``mesh_train:gemma3-1b``'s peak (which it
runs beside the child when it has not run yet), ``serve:ARCH`` a
serving phase of
``chip_smoke.SERVE`` (``--profile`` traces its window of steps) and
``dvf:ARCH`` a decode-vs-forward phase of ``chip_smoke.DVF`` in float32
(``--profile`` traces one more forward),
in the order given, each with the same code and checks as in the full
script (for example ``serve:hymba-1.5b dvf:xlstm-1.3b``).  It skips the
BFS/CC and taxi phases, the BaM kernel phase and the qwen2.5-14b serving
phase, so a change to one path can be checked on the card in minutes.
``--src DIR`` runs the phases of another checkout (its ``chip_smoke.py``
and ``src/``, for example a parent unpacked with ``git archive``), so two
trees can be run in turns in one call.  Prints
the card's name and power limit first; results go to
``chiprun_out/chip_phases.json``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
BAM_KERNELS = ("probe_allocate", "cache_probe", "gather_blocks",
               "sq_enqueue", "wfq_drain")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="+")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--src", default=None,
                    help="run the phases of the checkout at SRC (its "
                         "chip_smoke.py and src/), e.g. a parent unpacked "
                         "with git archive, to compare two trees in turns")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_chip_phases: no CUDA device", file=sys.stderr)
        return 1
    root = pathlib.Path(args.src).resolve() if args.src else ROOT
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import (build, flash_attention,
                                     paged_attention)

    # the BaM kernels the checkout has (an older one lacks the queue ones)
    bam = {name: importlib.import_module(
        f"repro_torch.kernels.{name}").launches for name in BAM_KERNELS
        if (root / "src" / "repro_torch" / "kernels" / f"{name}.py").exists()}

    t0 = time.perf_counter()
    cs.log(cs.nvidia_smi())
    build.build()
    build.lib()
    cs.log(f"kernels built in {time.perf_counter() - t0:.3f} s")
    dev = torch.device("cuda")
    attn = {"paged_attention": paged_attention.launches,
            "flash_attention": flash_attention.launches,
            "flash_attention.tc": flash_attention.variant_launches["tc"],
            "flash_attention.simt": flash_attention.variant_launches["simt"]}
    out = {}
    for phase in args.phases:
        t = time.perf_counter()
        if phase == "queues":
            out[phase] = cs.queue_kernel_phase(dev, args.seed)
        elif phase == "faults":
            out[phase] = cs.fault_phase(dev, args.seed, bam)
            out["faults_readahead"] = cs.fault_phase(dev, args.seed, bam,
                                                     readahead=True)
        elif phase == "taxi":
            out[phase] = cs.taxi_phase(dev, args.seed, bam,
                                       profile=args.profile)
        elif phase == "runtime":
            out[phase] = cs.runtime_phase(dev, args.seed, bam,
                                          profile=args.profile)
        elif phase == "attn":
            out[phase] = cs.attention_kernel_phase(dev, args.seed)
        elif phase == "attn_bwd":
            out[phase] = cs.attention_bwd_phase(dev, args.seed)
        elif phase == "train_vs_cpu":
            out[phase] = cs.train_vs_cpu_phase(dev, args.seed)
        elif phase == "train:gemma3-1b":
            out[phase] = cs.train_phase(dev, args.seed, args.profile)
        elif phase == "train_ckpt":
            out[phase] = cs.train_ckpt_phase(dev, args.seed)
        elif phase in ("mesh_train:gemma3-1b", "flash_decode_shards"):
            cs.start_world1()
            try:
                out[phase] = (cs.mesh_train_phase(dev, args.seed)
                              if phase.startswith("mesh_train")
                              else cs.flash_decode_phase(
                                  dev, args.seed, attn, args.profile))
            finally:
                cs.stop_world1()
        elif phase == "mesh_tp":
            child = cs.start_mesh_tp(args.seed)
            try:
                out.update(cs.mesh_tp_phase(child))
            finally:
                cs.stop_children(child[0])
        elif phase == "mesh_fsdp":
            tp_child = cs.start_mesh_tp(args.seed, ("mesh_fsdp",))
            child = cs.start_dryrun()
            try:
                if "mesh_train:gemma3-1b" not in out:
                    cs.start_world1()
                    try:
                        out["mesh_train:gemma3-1b"] = cs.mesh_train_phase(
                            dev, args.seed)
                    finally:
                        cs.stop_world1()
                dry = cs.dryrun_phase(out["mesh_train:gemma3-1b"], child)
                out.update(cs.mesh_tp_phase(tp_child, dry))
            finally:
                cs.stop_children([child[0]] + tp_child[0])
        elif phase == "dryrun":
            child = cs.start_dryrun()
            try:
                if "mesh_train:gemma3-1b" not in out:
                    cs.start_world1()
                    try:
                        out["mesh_train:gemma3-1b"] = cs.mesh_train_phase(
                            dev, args.seed)
                    finally:
                        cs.stop_world1()
                out[phase] = cs.dryrun_phase(out["mesh_train:gemma3-1b"],
                                             child)
            finally:
                if child[0].poll() is None:
                    child[0].kill()
                    child[0].communicate()
        elif phase.startswith("serve:"):
            out[phase] = cs.serving_phase(dev, args.seed, attn, phase[6:],
                                          profile=args.profile)
        elif phase.startswith("dvf:"):
            out[phase] = cs.decode_vs_forward_phase(dev, args.seed, attn,
                                                    phase[4:],
                                                    profile=args.profile)
        else:
            raise SystemExit(f"unknown phase {phase!r}")
        cs.log(f"{phase}: {time.perf_counter() - t:.3f} s")
        torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    name = "chip_phases.json" if root == ROOT \
        else f"chip_phases_{root.name}.json"
    (out_dir / name).write_text(json.dumps(
        dict(nvidia_smi=cs.nvidia_smi(), phases=out), indent=1,
        default=str))
    cs.log(f"torch_chip_phases: done in {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
