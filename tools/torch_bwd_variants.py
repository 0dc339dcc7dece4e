#!/usr/bin/env python3
"""Time sources of the flash backward's f32 kernels side by side on one GPU.

    python3 tools/torch_bwd_variants.py [--leave-out] [SRC.cu ...]

Each SRC.cu is a ``flash_attention_bwd.cu`` (default: this checkout's; for a
parent commit, one unpacked with ``git archive``).  Every source is compiled
by its own ``nvcc`` into its own library (the flags of
``repro_torch.kernels.build``, its directory's headers), all started
together, and its C entry ``flash_attention_bwd_launch`` (the ``"simt"``
variant) is called in f32 on the same inputs at gemma3-1b's window and
global shapes (B 4, 4 over 1 heads of 256, S 1024, causal, window 512 and
none).  A source without ``flash_attention_bwd_workspace_floats`` takes the
workspace of one f32 per query row (Delta).  With ``--leave-out`` each
source is also built with the dK/dV kernel's S/dP loop (``-A``) or its
dV/dK loop (``-B``) cut to no iteration: timing only, their gradients are
wrong; the time a loop costs is the full kernel's less the variant's (a
source without both loops, such as an older design, gets no such copy).

Per shape the sources run in turns, first to last and back (a, b, b, a),
and each reading is the median of 7 replays of a CUDA graph of 20 calls
(``chip_smoke.graph_spread_ms``), with each kernel's device time per call
from torch.profiler.  The gradients of every full source are held against
the plain version (largest error over the largest gradient).  Prints the
card's name and power limit, one line a reading, and writes every reading
to ``chiprun_out/bwd_variants.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the dK/dV kernel's two loops, as they open in this checkout's source
LOOPS = {"A": "for (int d0 = 0; d0 < DP; d0 += 32) {",
         "B": "for (int r = 0; r < SM_B; ++r) {\n      const float4 p0 ="}
SHAPES = {"window": (4, 4, 1, 1024, 256, True, 512),
          "global": (4, 4, 1, 1024, 256, True, None)}
TAGS = ("delta", "dkdv", "dq_", "group_sum")


def variants(srcs, leave_out, tmp):
    """(name, path, include dir) of every source to build: the sources,
    and with ``leave_out`` copies of those that have both loops with one
    loop cut (Sq is never negative)."""
    out = []
    for i, src in enumerate(srcs):
        try:
            name = f"{i}:{src.relative_to(ROOT)}"
        except ValueError:
            name = f"{i}:{src}"
        out.append((name, src, src.parent))
        text = src.read_text()
        if not leave_out or not all(loop in text for loop in LOOPS.values()):
            continue
        for tag, loop in LOOPS.items():
            cut = loop.replace("< DP;", "< (Sq < 0 ? DP : 0);").replace(
                "< SM_B;", "< (Sq < 0 ? SM_B : 0);")
            path = tmp / f"v{i}_{tag}.cu"
            path.write_text(text.replace(loop, cut, 1))
            out.append((f"{name} without loop {tag}", path, src.parent))
    return out


def build_all(items, tmp):
    from repro_torch.kernels import build

    nvcc = build._nvcc()
    procs = []
    for i, (name, path, inc) in enumerate(items):
        lib = tmp / f"lib{i}.so"
        procs.append((name, lib, subprocess.Popen(
            [nvcc, *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-shared", "-I",
             str(inc), str(path), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        handle = ctypes.CDLL(str(lib))
        fn = handle.flash_attention_bwd_launch
        fn.argtypes = build.SIGNATURES["flash_attention_bwd_launch"]
        fn.restype = ctypes.c_int
        size = getattr(handle, "flash_attention_bwd_workspace_floats", None)
        if size is not None:
            size.argtypes = build.SIGNATURES[
                "flash_attention_bwd_workspace_floats"]
            size.restype = ctypes.c_int64
        # registers of the f32 dK/dV and dQ kernels at D 256 (this design's
        # DP 256, the earlier 2 x 2-block design's NDT 16)
        regs = {m[0]: int(m[1]) for m in re.findall(
            r"entry function '\w*?(dkdv\w*?|dq\w*?)If(?:Li256|Li16)E\w*'"
            r"[^\n]*\n(?:[^\n]*\n)*?[^\n]*Used (\d+) registers", log)}
        libs[name] = (fn, size, regs)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*")
    ap.add_argument("--leave-out", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    srcs = [pathlib.Path(s).resolve() for s in args.sources] or [
        ROOT / "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"]
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{torch.cuda.get_device_name(0)}; {cs.nvidia_smi()}", flush=True)
    readings = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        libs = build_all(variants(srcs, args.leave_out, tmp), tmp)
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        for shape, (B, Hq, Hkv, S, D, causal, W) in SHAPES.items():
            q, g = (torch.randn((B, Hq, S, D), generator=gen, device="cuda")
                    for _ in range(2))
            k, v = (torch.randn((B, Hkv, S, D), generator=gen,
                                device="cuda") for _ in range(2))
            kw = dict(causal=causal, window=W)
            out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True,
                                               **kw)
            want = ref.flash_attention_bwd_ref(q, k, v, out, lse, g, **kw)
            dims = fa._shape_args(q, k, causal, W)
            names = list(libs)
            for name in names + names[::-1]:
                fn, size, regs = libs[name]
                n = size(*dims[:9], 0) if size else B * Hq * S
                work = torch.empty(n, dtype=torch.float32, device="cuda")
                grads = [torch.empty_like(t) for t in (q, k, v)]

                def run():
                    status = fn(*(t.data_ptr() for t in (q, k, v, out, lse,
                                                           g)), *dims, 0,
                                work.data_ptr(),
                                *(t.data_ptr() for t in grads),
                                fa._build.stream_ptr(q))
                    fa._build.check(status, name)

                run()
                torch.cuda.synchronize()
                err = max(cs.bwd_rel_err(a, b) for a, b in zip(grads, want))
                ms, lo, hi = cs.graph_spread_ms(run)
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        run()
                    torch.cuda.synchronize()
                split = {t: e.device_time_total / e.count / 1e3
                         for e in prof.key_averages() for t in TAGS
                         if t in e.key and e.count}
                r = dict(shape=shape, source=name, ms=ms, ms_spread=[lo, hi],
                         kernel_ms=split, max_rel_err=err, registers=regs)
                readings.append(r)
                print(json.dumps(r), flush=True)
                del work, grads
            del q, k, v, g, out, lse, want
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "bwd_variants.json").write_text(json.dumps(readings, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
