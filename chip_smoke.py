#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--log2-nodes 23] [--seed 0] [--profile]

Phases, each of which must pass or the script exits non-zero:

1. device check: CUDA present; the card's name and power limit;
2. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (a 16,384-set x 4-way directory, 262,144 keys, gathers of
   2^28 lanes), bit-identical, and timed with CUDA events beside its bound;
4. the slice at full size: BFS (async tokens) and CC over a GAP-urand-style
   graph of 2^23 vertices and degree 32 (E = 2^28 int32 edges in pinned
   host storage), 4 KiB cache lines, a 256 MiB cache (a quarter of the edge
   list), 16 SQs x 1024 over 4 simulated Optane P5800X devices; depths and
   labels checked against scipy; every kernel's launch count must rise.
   With ``--profile``, one more BFS and two CC rounds then run under
   torch.profiler, for the host/device time split (tables in
   ``chiprun_out/profile_*.txt``).

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches, times and bound.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
LINE_BYTES = 4096
CACHE_BYTES = 256 << 20
WAYS = 4


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters=10, warmup=2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float) -> float:
    return nbytes / PEAK_BYTES_PER_S * 1e3


def _bits(t):
    """Floats as their bit patterns, so NaN payloads compare equal."""
    import torch

    ints = {4: torch.int32, 2: torch.int16}
    return t.view(ints[t.element_size()]) if t.is_floating_point() else t


def max_abs_err(a, b) -> float:
    if a.shape != b.shape:
        return float("nan")
    if not a.numel():
        return 0.0
    return float((a.double() - b.double()).abs().nan_to_num(
        float("inf")).max()) if a.is_floating_point() else float(
        (a.long() - b.long()).abs().max())


def require_equal(name, a_tuple, b_tuple) -> float:
    """Assert bit-identical outputs; the largest absolute error is then 0.0,
    so it is only computed for the message when they differ."""
    import torch

    for i, (a, b) in enumerate(zip(a_tuple, b_tuple)):
        if a.dtype != b.dtype or a.shape != b.shape \
                or not torch.equal(_bits(a), _bits(b)):
            raise AssertionError(f"{name}: output {i} differs from the plain "
                                 f"version (max abs err {max_abs_err(a, b)})")
    return 0.0


# --------------------------------------------------------------- phase 3 --
def make_directory(S, W, gen, dev):
    """A directory whose tags sit in their own hash sets, a quarter of the
    ways invalid, random pins, dirty and speculative bits and clock hands."""
    import torch
    from repro_torch.utils import mix_hash, segment_rank

    cand = torch.randperm(8 * S * W, generator=gen, device=dev).to(torch.int32)
    sets = mix_hash(cand) % S
    rank = segment_rank(sets, torch.ones_like(cand, dtype=torch.bool))
    keep = rank < W
    tags = torch.full((S, W), -1, dtype=torch.int32, device=dev)
    tags[sets[keep].long(), rank[keep].long()] = cand[keep]
    tags[torch.rand((S, W), generator=gen, device=dev) < 0.25] = -1

    def flags(p):
        return torch.rand((S, W), generator=gen, device=dev) < p

    return dict(
        tags=tags, owner=torch.zeros((S, W), dtype=torch.int32, device=dev),
        refcount=(flags(0.05)).to(torch.int32), dirty=flags(0.3),
        speculative=flags(0.1),
        clock_hand=torch.randint(0, W, (S,), generator=gen, device=dev,
                                 dtype=torch.int32))


def unique_keys(m, hi, tags, gen, dev):
    """m distinct keys: up to a quarter resident (hits), the rest random."""
    import torch

    keys = torch.randperm(hi, generator=gen, device=dev)[:m].to(torch.int32)
    resident = tags[tags >= 0]
    k = min(m // 4, resident.numel())
    pick = torch.randperm(resident.numel(), generator=gen, device=dev)
    keys[:k] = resident[pick[:k]]
    return keys


def kernel_phase(dev, seed, S=16384, m=262144, log2_lanes=28):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.cache_probe import cache_probe_cuda
    from repro_torch.kernels.gather_blocks import gather_blocks_cuda
    from repro_torch.kernels.probe_allocate import probe_allocate_cuda
    from repro_torch.utils import mix_hash

    gen = torch.Generator(device=dev).manual_seed(seed)
    W = WAYS
    d = make_directory(S, W, gen, dev)
    keys = unique_keys(m, 32 * S * W, d["tags"], gen, dev)
    valid = keys >= 0
    sets_touched = torch.unique(mix_hash(keys) % S).numel()
    results = {}

    # -- cache_probe: tenant 0 (the main path) and a foreign-owner variant
    owner_mixed = torch.randint(0, 2, (S, W), generator=gen, device=dev,
                                dtype=torch.int32)
    for owner, tenant in ((owner_mixed, 1), (d["owner"], 0)):
        cp_err = require_equal(
            "cache_probe", cache_probe_cuda(d["tags"], keys, owner, tenant),
            ref.cache_probe_ref(d["tags"], keys, owner, tenant))
    hit, _ = cache_probe_cuda(d["tags"], keys, d["owner"], 0)
    results["cache_probe"] = dict(
        ms=cuda_time_ms(lambda: cache_probe_cuda(d["tags"], keys,
                                                 d["owner"], 0)),
        plain_ms=cuda_time_ms(lambda: ref.cache_probe_ref(
            d["tags"], keys, d["owner"], 0)),
        bound_ms=bound_ms(m * 4 + m * 5 + sets_touched * W * 4 * 2),
        max_abs_err=cp_err, shape=f"S={S} W={W} m={m}",
        hit_fraction=float(hit.float().mean()))

    # -- probe_allocate: the six policy variants, bit-identical
    dargs = (d["tags"], owner_mixed, d["refcount"], d["dirty"],
             d["speculative"], d["clock_hand"])
    dup = keys.clone()
    dup[m // 2:] = keys[torch.randint(0, m // 2, (m - m // 2,),
                                      generator=gen, device=dev)]
    dup[::97] = -1                        # negative keys, duplicate sets
    prot = torch.randint(-1, S * W, (m // 4,), generator=gen, device=dev,
                         dtype=torch.int32)
    amask = torch.rand((m,), generator=gen, device=dev) < 0.8
    variants = [dict(), dict(tenant=1), dict(way_lo=1, way_hi=3),
                dict(spec_insert=True), dict(protect_hits=False),
                dict(tenant=2, way_lo=0, way_hi=2, spec_insert=True)]
    for kw in variants:
        for ks in (keys, dup):
            args = (*dargs, ks, ks >= 0, amask, prot)
            require_equal(f"probe_allocate {kw}",
                          probe_allocate_cuda(*args, **kw),
                          ref.probe_allocate_ref(*args, **kw))
    main = (d["tags"], d["owner"], d["refcount"], d["dirty"],
            d["speculative"], d["clock_hand"], keys, valid)
    pa_err = require_equal("probe_allocate main", probe_allocate_cuda(*main),
                           ref.probe_allocate_ref(*main))
    ok = probe_allocate_cuda(*main)[3]
    results["probe_allocate"] = dict(
        ms=cuda_time_ms(lambda: probe_allocate_cuda(*main)),
        plain_ms=cuda_time_ms(lambda: ref.probe_allocate_ref(*main)),
        bound_ms=bound_ms(m * 4 + m * 1 + sets_touched * (W * 14 + 4)
                          + m * 15),
        max_abs_err=pa_err, shape=f"S={S} W={W} m={m}",
        granted_fraction=float(ok.float().mean()))

    # -- gather_blocks: the element gather the wait path runs, at a CC
    #    round's shape (2^28 lanes, 1024 lanes per line, a quarter of the
    #    lines resident), and the line gather over the same bytes
    L = LINE_BYTES // 4
    n_cache_lines = CACHE_BYTES // LINE_BYTES
    n = 1 << log2_lanes
    data = torch.randint(-2 ** 31, 2 ** 31 - 1, (n_cache_lines, L),
                         generator=gen, device=dev, dtype=torch.int32)
    n_lines = n // L
    line_slot = torch.where(
        torch.rand((n_lines,), generator=gen, device=dev) < 0.25,
        torch.randint(0, n_cache_lines, (n_lines,), generator=gen,
                      device=dev, dtype=torch.int32), -1).to(torch.int32)
    slots = line_slot.repeat_interleave(L)
    off = (torch.arange(n, device=dev, dtype=torch.int32) % L)
    gb_err = require_equal("gather_blocks element",
                           (gather_blocks_cuda(data, slots, off=off),),
                           (ref.gather_blocks_ref(data, slots, off=off),))
    require_equal("gather_blocks line", (gather_blocks_cuda(data, line_slot),),
                  (ref.gather_blocks_ref(data, line_slot),))
    for dt in (torch.float32, torch.bfloat16):      # the 2-byte path too
        x = data[:4096].view(dt)
        s_small = torch.randint(-1, 4096, (8192,), generator=gen, device=dev,
                                dtype=torch.int32)
        o_small = torch.randint(0, x.shape[1], (8192,), generator=gen,
                                device=dev, dtype=torch.int32)
        require_equal(f"gather_blocks {dt}",
                      (gather_blocks_cuda(x, s_small),
                       gather_blocks_cuda(x, s_small, off=o_small)),
                      (ref.gather_blocks_ref(x, s_small),
                       ref.gather_blocks_ref(x, s_small, off=o_small)))
    n_valid = int((slots >= 0).sum())
    rows_valid = int((line_slot >= 0).sum())
    results["gather_blocks"] = dict(
        ms=cuda_time_ms(lambda: gather_blocks_cuda(data, slots, off=off)),
        plain_ms=cuda_time_ms(lambda: ref.gather_blocks_ref(data, slots,
                                                            off=off), iters=3),
        # every lane reads its slot and writes its output; only a lane with
        # slot >= 0 needs its offset and its element (the rest write 0)
        bound_ms=bound_ms(n * 8 + n_valid * 8),
        max_abs_err=gb_err, shape=f"element gather n=2^{log2_lanes} line_elems={L}",
        line_ms=cuda_time_ms(lambda: gather_blocks_cuda(data, line_slot)),
        line_plain_ms=cuda_time_ms(
            lambda: ref.gather_blocks_ref(data, line_slot), iters=3),
        line_bound_ms=bound_ms(n_lines * 4 + rows_valid * L * 4
                               + n_lines * L * 4),
        line_shape=f"line gather n={n_lines} rows of {L} int32")
    del data, slots, off, line_slot
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------- phase 4 --
def scipy_check(indptr, dst, depth, labels):
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    n = len(indptr) - 1
    a = sp.csr_matrix((np.ones(len(dst), np.float64), dst, indptr),
                      shape=(n, n))
    t0 = time.perf_counter()
    dist = csgraph.shortest_path(a, directed=True, unweighted=True,
                                 indices=0)
    want = np.where(np.isinf(dist), -1, dist).astype(np.int32)
    if not np.array_equal(depth, want):
        raise AssertionError(f"BFS depth differs from scipy at "
                             f"{int((depth != want).sum())} vertices")
    _, comp = csgraph.connected_components(a, directed=True,
                                           connection="weak")
    _, first = np.unique(comp, return_index=True)
    want_labels = first[comp]          # minimum vertex id per component
    if not np.array_equal(labels, want_labels):
        raise AssertionError(f"CC labels differ from scipy at "
                             f"{int((labels != want_labels).sum())} vertices")
    return time.perf_counter() - t0, int(first.shape[0])


def profile_runs(g):
    """Trace one async BFS and two CC rounds with torch.profiler (after the
    main path's counts were read); tables go to chiprun_out/."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.graph.analytics import bfs, cc

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for name, fn in (("bfs", lambda: bfs(g, 0, async_tokens=True)),
                     ("cc", lambda: cc(g, max_iters=2))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ka = prof.key_averages()

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))

        # kernels and copies only: a CPU op's own device time repeats its
        # kernels' time
        on_dev = [e for e in ka
                  if e.device_type != torch.autograd.DeviceType.CPU]
        busy = sum(dev_us(e) for e in on_dev) / 1e6
        (out_dir / f"profile_{name}.txt").write_text(
            ka.table(sort_by="self_cpu_time_total", row_limit=25) + "\n"
            + ka.table(sort_by="self_cuda_time_total", row_limit=25))
        log(f"profile {name}: wall {wall:.6f} s under the profiler, device "
            f"busy {busy:.6f} s ({busy / wall:.6f} of wall)")
        for e in sorted(ka, key=lambda e: -e.self_cpu_time_total)[:6]:
            log(f"  host  {e.key}: {e.self_cpu_time_total / 1e6:.6f} s "
                f"self CPU, {e.count} calls")
        for e in sorted(on_dev, key=lambda e: -dev_us(e))[:8]:
            log(f"  device {e.key}: {dev_us(e) / 1e6:.6f} s, "
                f"{e.count} calls")


def slice_phase(dev, log2_nodes, seed, counters, profile=False):
    import numpy as np
    import torch
    from repro_torch.graph.analytics import BamGraph, bfs, cc, random_graph

    n = 1 << log2_nodes
    t0 = time.perf_counter()
    indptr, dst = random_graph(n, 32, seed=seed)
    t_graph = time.perf_counter() - t0
    log(f"graph build (host, numpy): {t_graph:.3f} s for {n} vertices, "
        f"{len(dst)} edges")
    t0 = time.perf_counter()
    g = BamGraph.build(indptr, dst, cacheline_bytes=LINE_BYTES,
                       cache_bytes=CACHE_BYTES, ways=WAYS, n_devices=4,
                       device=dev)
    torch.cuda.synchronize()
    t_bam = time.perf_counter() - t0
    log(f"BamGraph.build (pinned store + device metadata): {t_bam:.3f} s")

    for c in counters.values():
        c.n = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    depth, st_b = bfs(g, 0, async_tokens=True)
    torch.cuda.synchronize()
    t_bfs = time.perf_counter() - t0
    after_bfs = {k: c.n for k, c in counters.items()}
    t0 = time.perf_counter()
    labels, st_c = cc(g)
    torch.cuda.synchronize()
    t_cc = time.perf_counter() - t0
    launches = {k: c.n for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    runs = {}
    for name, st, wall, iters in (
            # BFS expands levels 0..max depth; each CC round is one read
            ("bfs", st_b, t_bfs, int(depth.max()) + 1),
            ("cc", st_c, t_cc, int(st_c.metrics.tokens_submitted))):
        m = st.metrics.summary()
        runs[name] = dict(
            wall_s=wall, iterations=iters, edges_traversed=m["requests"],
            edges_per_s=m["requests"] / wall, hit_rate=m["hit_rate"],
            amplification=m["amplification"], misses=m["misses"],
            bytes_from_storage=m["bytes_from_storage"],
            sim_time_s=m["sim_time_s"], dropped=m["dropped"])
        log(f"{name}: wall {wall:.6f} s, iterations {iters}, edges traversed "
            f"{m['requests']:.0f}, edges/s {m['requests'] / wall:.6e}, hit "
            f"rate {m['hit_rate']:.6f}, I/O amplification "
            f"{m['amplification']:.6f}")
    per_bfs = dict(after_bfs)
    per_cc = {k: launches[k] - after_bfs[k] for k in launches}
    log(f"launches per BFS {per_bfs}, per CC {per_cc}")
    log(f"peak device memory: {peak} bytes ({peak / 2 ** 30:.3f} GiB)")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")

    if profile:
        profile_runs(g)
    t_check, n_comp = scipy_check(indptr, dst, depth, labels)
    reached = int((depth >= 0).sum())
    log(f"scipy check passed in {t_check:.3f} s: {reached} vertices reached, "
        f"max depth {int(depth.max())}, {n_comp} components")
    if not np.isfinite(runs["bfs"]["sim_time_s"]):
        raise AssertionError("non-finite simulated time")
    return dict(graph_build_s=t_graph, bam_build_s=t_bam, runs=runs,
                launches=launches, launches_per_bfs=per_bfs,
                launches_per_cc=per_cc, peak_device_bytes=peak,
                scipy_check_s=t_check, n_vertices=n, n_edges=int(len(dst)),
                components=n_comp, vertices_reached=reached)


REPLACES = {
    "probe_allocate": "src/repro/kernels/probe_allocate.py:167",
    "cache_probe": "src/repro/kernels/cache_probe.py:75",
    "gather_blocks": "src/repro/kernels/gather_blocks.py:39",
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2-nodes", type=int, default=23)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="after the checked run, trace one more BFS and two "
                         "CC rounds with torch.profiler")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import cache_probe, gather_blocks, probe_allocate

    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    lib_path = build.build()
    build.lib()
    t_build = time.perf_counter() - t0
    log(f"kernels built in {t_build:.3f} s: {lib_path}")
    for line in build.build_log.splitlines():
        if "registers" in line or line.startswith("=="):
            log("  " + line.strip())

    kres = kernel_phase(dev, args.seed)
    for k, v in kres.items():
        log(f"kernel {k}: {v['ms']:.6f} ms (plain {v['plain_ms']:.6f} ms, "
            f"bound {v['bound_ms']:.6f} ms) at {v['shape']}")
    log(f"kernel gather_blocks (line): {kres['gather_blocks']['line_ms']:.6f}"
        f" ms (plain {kres['gather_blocks']['line_plain_ms']:.6f} ms, bound "
        f"{kres['gather_blocks']['line_bound_ms']:.6f} ms)")

    counters = {"probe_allocate": probe_allocate.launches,
                "cache_probe": cache_probe.launches,
                "gather_blocks": gather_blocks.launches}
    sres = slice_phase(dev, args.log2_nodes, args.seed, counters,
                       profile=args.profile)

    kernels = []
    for name in ("probe_allocate", "cache_probe", "gather_blocks"):
        r = kres[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": sres["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": None})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        nvidia_smi=smi, device=torch.cuda.get_device_name(0),
        torch=torch.__version__, cuda=torch.version.cuda,
        build_s=t_build, build_log=build.build_log, kernels=kres,
        slice=sres), indent=1))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
