#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--log2-nodes 23] [--seed 0] [--profile]

Phases, each of which must pass or the script exits non-zero:

1. device check: CUDA present; the card's name and power limit;
2. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc, and
   count the HGMMA (wgmma) instructions of each tensor-core flash kernel
   in ``cuobjdump -sass`` (none is a failure);
3. each BaM kernel against its plain PyTorch version on the card, at the
   main path's shapes (a 16,384-set x 4-way directory, 262,144 keys,
   gathers of 2^28 lanes), bit-identical, and timed with CUDA events beside
   its bound;
4. each attention kernel against its plain version within
   ``tests/test_kernels.py``'s TOL (3e-5 in f32, 3e-2 in bf16), and every
   bf16 output also against the plain version computed in f32 from the
   same inputs, within what bf16 rounding can explain (``BF16_ROUNDING``;
   for flash, two planted faults, one 128-key tile dropped and the window
   one key too wide, must exceed that limit):
   ``paged_attention`` (split-KV) at the serving shape (B 8, 40 query over
   8 KV heads, head dim 128, 5 pages of 256, lengths 600-1280, one hole per
   sequence) in bf16 and f32, bit-identical across two runs and when the
   physical pages are permuted with the page table; ``flash_attention`` at
   B 1, S 4096 (a cut of the prefill_32k cell's S 32,768 and B 32), causal,
   timed in bf16 on the tensor-core kernel beside SDPA and, in f32, on the
   SIMT kernel; causal and window-1024 in bf16 (head dims 64, 128, 256,
   tensor cores) and f32 (SIMT), at the forward check's shape (B 2, S 256)
   in both, and a small non-causal ragged case in both;
5. the BaM slice at full size: BFS (async tokens) and CC over a
   GAP-urand-style graph of 2^23 vertices and degree 32 (E = 2^28 int32
   edges in pinned host storage), 4 KiB cache lines, a 256 MiB cache (a
   quarter of the edge list), 16 SQs x 1024 over 4 simulated Optane P5800X
   devices; depths and labels checked against scipy; every BaM kernel's
   launch count must rise;
6. serving: qwen2.5-14b at full width and depth in bf16 (random weights from
   ``--seed``) through ``ServeEngine`` with ``PagedKVManager(keep_last=
   512)``: 8 slots, max_seq 1280, 8 requests of 600-1000 prompt tokens and
   32 new tokens each; every request done, pages spilled and fetched, and
   ``paged_attention`` launched 48 times per engine step;
7. the spill/fetch round trip at full size: B 2 after 600 decode steps,
   ``keep_last=256``, so page 0 of every layer is cold; the next step's
   logits after spill + fetch bit-identical to those without the spill;
8. decode against forward: full width, depth cut to 4 layers, B 2, S 256:
   the last-token logits of 256 ``decode_step``s (paged kernel) and of
   ``forward`` (flash kernel), in float32 (TF32 off for matmuls and cuDNN;
   SIMT flash) within atol = rtol = 2e-3, and in bfloat16 (tensor-core
   flash, which must have run) within atol 0.15 (``DVF_LIMITS``).

With ``--profile``, one more BFS and two CC rounds, and a window of engine
steps in phase 6, run under torch.profiler (tables in
``chiprun_out/profile_*.txt``), and phase 6 also reports the host seconds
spent in each KV-manager call.

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
PEAK_BF16_FLOPS = 989e12        # dense tensor-core rate, NVIDIA data sheet
TOL = {"float32": dict(atol=3e-5, rtol=3e-5),         # tests/test_kernels.py
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
# A bf16 attention kernel against the plain version computed in f32 from the
# same bf16 inputs.  The kernels compute in f32 and round to bf16 at most
# twice: P before P @ V (tensor-core flash; at most 2^-8 of each p, so at
# most 2^-8 of sum p|v| / l, the p-weighted mean of |v|) and the output (at
# most 2^-8 of |o|, which is no larger than that mean).  So the error of an
# element is at most 2^-7 of the p-weighted mean of |v| in its column (the
# plain version run on |v| gives it); atol covers the f32 arithmetic's own
# differences (summation order, exp2).
BF16_ROUNDING = dict(rel=2.0 ** -7, atol=1e-5)
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


def cuda_graph_time_ms(fn, calls=20, reps=10) -> float:
    """Device time of one call: ``calls`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events, so the host's cost of
    issuing each call is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def host_us_per_call(fn, calls=200) -> float:
    """Host time to issue one call, in microseconds: ``calls`` back-to-back
    calls on the host clock, the device idle at the start (its queue takes
    the launches while they are issued)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


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


def hgmma_counts(lib_path) -> dict:
    """HGMMA (wgmma) instructions in each tensor-core flash kernel of the
    built library, from ``cuobjdump -sass``."""
    from repro_torch.kernels import build

    cuobjdump = pathlib.Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            fn = fn if "flash_fwd_tc_kernel" in fn else None
            if fn:
                counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    return counts


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
def require_close(name, a, b, dtype) -> float:
    """Assert ``a`` within TOL of the plain version ``b``; returns the
    largest absolute error."""
    import torch

    tol = TOL[dtype]
    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"{name}: {a.dtype}{tuple(a.shape)} != "
                             f"{b.dtype}{tuple(b.shape)}")
    af, bf = a.double(), b.double()
    if not bool(torch.isfinite(af).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = float((af - bf).abs().max())
    if not bool(((af - bf).abs() <= tol["atol"] + tol["rtol"]
                 * bf.abs()).all()):
        raise AssertionError(f"{name}: max abs err {err} outside {tol}")
    return err


def bf16_rounding_ratio(out, want32, scale) -> float:
    """The largest ``|out - want32| / (rel * scale + atol)`` of
    ``BF16_ROUNDING``: at most 1 for a kernel whose only error is bf16
    rounding, where ``scale`` is the plain version run on |v|."""
    import torch

    if not bool(torch.isfinite(out).all()):
        raise AssertionError("non-finite output")
    err = (out.double() - want32.double()).abs()
    return float((err / (BF16_ROUNDING["rel"] * scale.double()
                         + BF16_ROUNDING["atol"])).max())


def attention_rows_ref(q, k, v, r0, mask):
    """Plain attention in f32 for the query rows from ``r0`` on under an
    explicit (rows, Skv) mask; every row must see a key."""
    import math

    import torch

    group = q.shape[1] // k.shape[1]
    kr = k.repeat_interleave(group, dim=1).float()
    vr = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, r0:].float(), kr) \
        / math.sqrt(q.shape[-1])
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr)


def flash_planted_ratios(out, q, k, v, causal, window, scale) -> dict:
    """``bf16_rounding_ratio`` of ``out`` against two planted faults of the
    plain version, on the last 128 query rows: one 128-key tile that every
    one of those rows sees dropped, and (with a window) the window one key
    too wide.  A limit that a wrong kernel must fail reads above 1 here."""
    import torch

    Sq, Skv = q.shape[2], k.shape[2]
    r0 = max(0, Sq - 128)
    qp = torch.arange(r0, Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    causal_mask = torch.ones((Sq - r0, Skv), dtype=torch.bool,
                             device=q.device)
    if causal:
        causal_mask &= kp <= qp
    mask = causal_mask if window is None else causal_mask & (kp > qp - window)
    t0 = max(0, Sq - 512) // 128 * 128
    faults = {"tile_dropped": mask & ~((kp >= t0) & (kp < t0 + 128))}
    if window is not None:
        faults["window_plus_one"] = causal_mask & (kp > qp - window - 1)
    return {name: bf16_rounding_ratio(
        out[:, :, r0:], attention_rows_ref(q, k, v, r0, fault),
        scale[:, :, r0:]) for name, fault in faults.items()}


def paged_inputs(B, Hq, Hkv, D, page, NP, lens, dtype, gen, dev):
    """Pools of random values, a random physical page per logical page and
    one hole among each sequence's live pages."""
    import torch

    shape = (B, NP, page, Hkv, D)
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(dtype)
    kp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    vp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    pt = torch.stack([torch.randperm(NP, generator=gen, device=dev)
                      for _ in range(B)]).to(torch.int32)
    sl = torch.randint(lens[0], lens[1] + 1, (B,), generator=gen,
                       device=dev, dtype=torch.int32)
    for b in range(B):
        n_live = -(-int(sl[b]) // page)
        pt[b, int(torch.randint(0, n_live, (1,), generator=gen,
                                device=dev))] = -1
    return q, kp, vp, pt, sl


def paged_live_bytes(q, kp, pt, sl) -> int:
    """Bytes the paged kernel must move: the live K and V positions (not in
    a hole, below seq_lens), q, the output, the table and the lengths."""
    B, NP, page, Hkv, D = kp.shape
    live = 0
    for b in range(B):
        for i in range(NP):
            if int(pt[b, i]) >= 0:
                live += max(0, min(page, int(sl[b]) - i * page))
    return (2 * live * Hkv * D * kp.element_size()
            + 2 * q.numel() * q.element_size() + pt.numel() * 4 + B * 4)


def attention_kernel_phase(dev, seed):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     variant, variant_launches)
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    results = {}

    # -- paged_attention at the serving shape, bf16 (timed) and f32
    errs = []
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q, kp, vp, pt, sl = paged_inputs(8, 40, 8, 128, 256, 5, (600, 1280),
                                         dt, gen, dev)
        out = paged_attention_cuda(q, kp, vp, pt, sl)
        errs.append(require_close(
            f"paged_attention {dtype}", out,
            ref.paged_attention_ref(q, kp, vp, pt, sl), dtype))
        if dtype == "bfloat16":
            qf, kf, vf = q.float(), kp.float(), vp.float()
            paged_ratio = bf16_rounding_ratio(
                out, ref.paged_attention_ref(qf, kf, vf, pt, sl),
                ref.paged_attention_ref(qf, kf, vf.abs(), pt, sl))
            del qf, kf, vf
            log(f"paged_attention bf16 against f32 plain: {paged_ratio} of "
                f"the bf16 rounding limit")
            if paged_ratio > 1:
                raise AssertionError(f"paged_attention bf16: {paged_ratio} "
                                     f"times the bf16 rounding limit")
        # the split is by logical position and the combine order fixed:
        # the same input gives the same bits, and so do the same pages at
        # other physical slots (pools and table permuted together)
        if not torch.equal(paged_attention_cuda(q, kp, vp, pt, sl), out):
            raise AssertionError(f"paged_attention {dtype}: two runs of one "
                                 f"input differ")
        B, P = kp.shape[:2]
        perm = torch.stack([torch.randperm(P, generator=gen, device=dev)
                            for _ in range(B)])
        bidx = torch.arange(B, device=dev)[:, None]
        kp2, vp2 = torch.empty_like(kp), torch.empty_like(vp)
        kp2[bidx, perm] = kp
        vp2[bidx, perm] = vp
        pt2 = torch.where(pt >= 0, torch.gather(perm, 1, pt.clamp(min=0).long())
                          .to(torch.int32), pt)
        if not torch.equal(paged_attention_cuda(q, kp2, vp2, pt2, sl), out):
            raise AssertionError(f"paged_attention {dtype}: output changed "
                                 f"when the physical pages were permuted")
        del kp2, vp2
    log("paged_attention: bit-identical across two runs and under a "
        "permutation of the physical pages (f32 and bf16)")
    # ms: back-to-back eager calls between CUDA events, as every kernel here
    # is timed; issuing a call from Python takes longer than the two kernels
    # run, so the kernels' own device time (a CUDA graph of 20 calls) is
    # device_ms beside it
    results["paged_attention"] = dict(
        ms=cuda_time_ms(lambda: paged_attention_cuda(q, kp, vp, pt, sl),
                        iters=50),
        device_ms=cuda_graph_time_ms(
            lambda: paged_attention_cuda(q, kp, vp, pt, sl)),
        host_us=host_us_per_call(
            lambda: paged_attention_cuda(q, kp, vp, pt, sl)),
        plain_ms=cuda_time_ms(lambda: ref.paged_attention_ref(
            q, kp, vp, pt, sl)),
        bound_ms=bound_ms(paged_live_bytes(q, kp, pt, sl)), bound_by="bytes",
        library_ms=None, max_abs_err=max(errs),
        bf16_rounding_ratio=paged_ratio,
        shape=("B=8 Hq=40 Hkv=8 D=128 page=256 NP=P=5 bf16, seq_lens "
               f"{sl.tolist()}, one hole per sequence"))

    # -- flash_attention: causal bf16 at S=4096 (timed, beside SDPA), a
    #    window of 1024, a small non-causal ragged case, and the forward
    #    check's shape (B 2, S 256); bf16 at head dims 64 (tests) and 256
    #    (gemma3-12b: 16 query over 8 KV heads), causal and window 1024.
    #    Every bf16 case here runs the tensor-core kernel, every f32 case
    #    the SIMT one (the variant is checked).  The float32 cases hold the
    #    SIMT kernel's causal mask, window compare and tile skipping to
    #    3e-5.  TOL's bf16 limit (3e-2) is near the size of an output here,
    #    so every bf16 output is also held to the plain version in f32 on
    #    the same inputs within BF16_ROUNDING, and two planted faults (a
    #    dropped key tile, a window one key too wide) must exceed that
    #    limit.  TF32 is off for the plain version's float32 matmuls.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = []
    cases = [(1, 40, 8, 4096, 4096, 128, True, None, "bfloat16"),
             (1, 40, 8, 4096, 4096, 128, True, 1024, "bfloat16"),
             (1, 16, 8, 4096, 4096, 64, True, None, "bfloat16"),
             (1, 16, 8, 4096, 4096, 64, True, 1024, "bfloat16"),
             (1, 16, 8, 4096, 4096, 256, True, None, "bfloat16"),
             (1, 16, 8, 4096, 4096, 256, True, 1024, "bfloat16"),
             (1, 40, 8, 4096, 4096, 128, True, None, "float32"),
             (1, 40, 8, 4096, 4096, 128, True, 1024, "float32"),
             (2, 40, 8, 256, 256, 128, True, None, "float32"),
             (2, 40, 8, 256, 256, 128, True, None, "bfloat16"),
             (2, 6, 2, 200, 333, 64, False, None, "float32"),
             (2, 6, 2, 200, 333, 64, False, None, "bfloat16")]
    case_errs, ratios = {}, {}
    simt_ms = None
    for case in reversed(cases):
        B, Hq, Hkv, Sq, Skv, D, causal, window, dtype = case
        dt = getattr(torch, dtype)
        q = torch.randn((B, Hq, Sq, D), generator=gen, device=dev).to(dt)
        k = torch.randn((B, Hkv, Skv, D), generator=gen, device=dev).to(dt)
        v = torch.randn((B, Hkv, Skv, D), generator=gen, device=dev).to(dt)
        kind = variant(q, k)
        if kind != ("tc" if dtype == "bfloat16" else "simt"):
            raise AssertionError(f"flash_attention {case}: runs {kind}")
        n0 = variant_launches[kind].n
        out = flash_attention_cuda(q, k, v, causal=causal, window=window)
        err = require_close(
            f"flash_attention {case}", out,
            ref.flash_attention_ref(q, k, v, causal=causal, window=window),
            dtype)
        if variant_launches[kind].n != n0 + 1:
            raise AssertionError(f"flash_attention {case}: {kind} not counted")
        errs.append(err)
        case_errs[str(case)] = err
        log(f"flash_attention {case} ({kind}): max abs err {err}")
        if dtype == "bfloat16":
            qf, kf, vf = q.float(), k.float(), v.float()
            scale = ref.flash_attention_ref(qf, kf, vf.abs(), causal=causal,
                                            window=window)
            r = dict(sound=bf16_rounding_ratio(out, ref.flash_attention_ref(
                qf, kf, vf, causal=causal, window=window), scale))
            r.update(flash_planted_ratios(out, q, k, v, causal, window,
                                          scale))
            del qf, kf, vf, scale
            ratios[str(case)] = r
            log(f"flash_attention {case}: against f32 plain, ratios to the "
                f"bf16 rounding limit {r}")
        del out
        if case == cases[6]:          # f32 causal at S=4096: the SIMT kernel
            simt_ms = cuda_time_ms(
                lambda: flash_attention_cuda(q, k, v, causal=True), iters=3)
            log(f"flash_attention simt, f32 causal S=4096: {simt_ms:.6f} ms")
    # the sound readings must sit within the limit and every planted fault
    # outside it
    for case, r in ratios.items():
        if r["sound"] > 1 or min(x for name, x in r.items()
                                 if name != "sound") <= 1:
            raise AssertionError(f"flash_attention {case}: ratios to the "
                                 f"bf16 rounding limit {r}")
    # the last case run is the first listed: causal bf16 at S=4096
    S = q.shape[2]
    pairs = S * (S + 1) // 2                      # live (query, key) pairs
    flops = 4 * D * Hq * B * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    results["flash_attention"] = dict(
        ms=cuda_time_ms(lambda: flash_attention_cuda(q, k, v, causal=True)),
        variant=variant(q, k), simt_f32_ms=simt_ms,
        plain_ms=cuda_time_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=True), iters=3),
        library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
        bound_ms=max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3,
        bound_by="operations" if flops / PEAK_BF16_FLOPS
        > nbytes / PEAK_BYTES_PER_S else "bytes",
        max_abs_err=max(errs), flops=flops, case_errs=case_errs,
        bf16_rounding_ratios=ratios,
        shape=("B=1 Hq=40 Hkv=8 S=4096 D=128 bf16 causal (cut from "
               "prefill_32k: S 32768 -> 4096, B 32 -> 1)"))
    del q, k, v, kp, vp
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------- phase 5 --
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


def profile_table(name, prof, wall):
    """Write a profiler's tables to chiprun_out/ and log the device busy
    share and the largest host and device items."""
    import torch

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # kernels and copies only: a CPU op's own device time repeats its
    # kernels' time
    on_dev = [e for e in ka if e.device_type != torch.autograd.DeviceType.CPU]
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
        log(f"  device {e.key}: {dev_us(e) / 1e6:.6f} s, {e.count} calls")
    return dict(wall_s=wall, device_busy_s=busy)


def profile_runs(g):
    """Trace one async BFS and two CC rounds with torch.profiler (after the
    main path's counts were read); tables go to chiprun_out/."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.graph.analytics import bfs, cc

    for name, fn in (("bfs", lambda: bfs(g, 0, async_tokens=True)),
                     ("cc", lambda: cc(g, max_iters=2))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        profile_table(name, prof, wall)


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


# --------------------------------------------------------------- phase 6 --
def serving_phase(dev, seed, counters, profile=False):
    """qwen2.5-14b at full width and depth, bf16, through the engine."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model, count_params
    from repro_torch.serving import PagedKVManager, Request, ServeEngine

    cfg = get_config("qwen2.5-14b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    api = build_model(cfg, dev)
    model = api.init(seed)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = count_params(model)
    log(f"serving: {cfg.name} {n_params} parameters ({cfg.dtype}), random "
        f"init on the card in {t_init:.3f} s")

    B, max_seq, new_tokens = 8, 1280, 32
    kv = PagedKVManager(keep_last=512)
    kv_s = None
    if profile:
        # host seconds in each KV-manager call, device work included; the
        # synchronising wrappers change the loop, so only --profile has them
        kv_s = {"maybe_spill": 0.0, "ensure_resident": 0.0}

        def timed(name):
            fn = getattr(kv, name)

            def call(cache):
                t = time.perf_counter()
                out = fn(cache)
                torch.cuda.synchronize()
                kv_s[name] += time.perf_counter() - t
                return out
            setattr(kv, name, call)

        timed("maybe_spill")
        timed("ensure_resident")
    eng = ServeEngine(cfg, model, batch_slots=B, max_seq=max_seq,
                      kv_manager=kv, device=dev)
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(
        2, cfg.vocab, int(rng.integers(600, 1001))).tolist(),
        max_new_tokens=new_tokens) for i in range(B)]
    for r in reqs:
        eng.submit(r)
    prof_window = (900, 933)          # engine steps traced with --profile
    prof_res = None
    for c in counters.values():
        c.n = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.queue or any(sl.req is not None for sl in eng.slots):
        if profile and eng.n_steps == prof_window[0]:
            from torch.profiler import ProfilerActivity, profile as tprof
            torch.cuda.synchronize()
            with tprof(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
                tp = time.perf_counter()
                while eng.n_steps < prof_window[1] and (
                        eng.queue or any(sl.req for sl in eng.slots)):
                    eng.step()
                torch.cuda.synchronize()
                twall = time.perf_counter() - tp
            prof_res = profile_table("serve", prof, twall)
            continue
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.n for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    if not all(r.done and len(r.out) == new_tokens for r in reqs):
        raise AssertionError("serving: not every request completed")
    m = kv.metrics.summary()
    if not (m["write_ops"] > 0 and m["misses"] > 0):
        raise AssertionError(f"serving: no pages spilled ({m['write_ops']}) "
                             f"or fetched ({m['misses']})")
    want = cfg.n_layers * eng.n_steps
    if launches["paged_attention"] != want:
        raise AssertionError(f"serving: paged_attention launched "
                             f"{launches['paged_attention']} times, want "
                             f"{want} (48 x {eng.n_steps} steps)")
    gen_tokens = sum(len(r.out) for r in reqs)
    all_tokens = sum(len(r.prompt) + len(r.out) for r in reqs)
    res = dict(
        arch=cfg.name, params=n_params, init_s=t_init, slots=B,
        max_seq=max_seq, prompt_lens=[len(r.prompt) for r in reqs],
        new_tokens=new_tokens, wall_s=wall, engine_steps=eng.n_steps,
        ms_per_step=wall / eng.n_steps * 1e3,
        generated_tokens=gen_tokens, generated_tokens_per_s=gen_tokens / wall,
        tokens_through_decode=all_tokens,
        decode_tokens_per_s=all_tokens / wall,
        pages_spilled=m["write_ops"], pages_fetched=m["misses"],
        bytes_to_storage=m["bytes_to_storage"],
        bytes_from_storage=m["bytes_from_storage"],
        sim_time_s=m["sim_time_s"], page_bytes=kv.page_bytes,
        kv_manager_host_s=kv_s,
        peak_device_bytes=peak, launches=launches, profiled=profile,
        profile=prof_res)
    log(f"serving: wall {wall:.6f} s{' (with a profiled window)' if profile else ''}, "
        f"{eng.n_steps} engine steps, {res['ms_per_step']:.6f} ms per step, "
        f"{gen_tokens} generated tokens ({res['generated_tokens_per_s']:.6f}"
        f" tokens/s; {res['decode_tokens_per_s']:.6f} tokens/s through "
        f"decode, prompts included)")
    log(f"serving: pages spilled {m['write_ops']:.0f} ({m['bytes_to_storage']:.0f}"
        f" bytes), fetched {m['misses']:.0f} ({m['bytes_from_storage']:.0f} "
        f"bytes); simulated device time {m['sim_time_s']:.6f} s"
        + ("" if kv_s is None else f"; host time in maybe_spill "
           f"{kv_s['maybe_spill']:.6f} s, in ensure_resident "
           f"{kv_s['ensure_resident']:.6f} s"))
    log(f"serving: peak device memory {peak} bytes ({peak / 2 ** 30:.3f} "
        f"GiB); launches {launches}")
    del eng
    return api, model, res


def roundtrip_phase(api, model, seed):
    """B 2 after 600 decode steps, keep_last 256: page 0 of every layer is
    cold.  Logits after spill + fetch must be bit-identical."""
    import torch
    from repro_torch.serving import PagedKVManager

    gen = torch.Generator(device=api.device).manual_seed(seed + 2)
    torch.cuda.reset_peak_memory_stats()
    cache = api.init_decode_cache(2, 1280)
    toks = torch.randint(2, api.cfg.vocab, (601, 2), generator=gen,
                         device=api.device, dtype=torch.int32)
    t0 = time.perf_counter()
    for t in range(600):
        _, cache = api.decode_step(model, cache, toks[t])
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    lg_plain, _ = api.decode_step(model, cache, toks[600])
    kv = PagedKVManager(keep_last=256)
    cache2, n_spilled = kv.maybe_spill(cache)
    cache3, n_fetched = kv.ensure_resident(cache2)
    lg, _ = api.decode_step(model, cache3, toks[600])
    want = 2 * api.cfg.n_layers
    if n_spilled != want or n_fetched != want:
        raise AssertionError(f"roundtrip: spilled {n_spilled}, fetched "
                             f"{n_fetched}, want {want} (page 0 per layer)")
    if not bool(torch.isfinite(lg).all()) or not torch.equal(lg, lg_plain):
        raise AssertionError("roundtrip: logits after spill + fetch differ "
                             "from the logits without the spill")
    peak = torch.cuda.max_memory_allocated()
    log(f"roundtrip: 600 decode steps at B 2 in {t_decode:.6f} s; "
        f"{n_spilled} pages spilled and fetched; logits bit-identical; peak "
        f"device memory {peak} bytes")
    return dict(decode_steps=600, decode_s=t_decode, pages=n_spilled,
                bit_identical=True, peak_device_bytes=peak)


# Limits of phase 8 (last-token logits of 256 decode steps against forward,
# full width, 4 layers) as (atol, rtol).  float32 (TF32 off): the two paths
# sum in different orders, nothing else.  bfloat16: forward's tensor-core
# flash kernel rounds P to bf16 before P.V, and the two paths round K, V and
# every activation to bf16 at different points, so the logits (of size
# about 5) differ far more: the first chip run of this check gave a max abs
# err of 0.04296875 (NVIDIA H100 80GB HBM3), and the limit is 3.5 times it.
DVF_LIMITS = {"float32": (2e-3, 2e-3), "bfloat16": (0.15, 0.0)}


def decode_vs_forward_phase(dev, seed, counters, dtype="float32"):
    """Full width, 4 layers: S decode steps (paged kernel) against forward
    (flash kernel: SIMT in float32, tensor cores in bfloat16)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen2.5-14b").replace(n_layers=4, dtype=dtype)
    torch.cuda.reset_peak_memory_stats()
    api = build_model(cfg, dev)
    model = api.init(seed + 3)
    B, S = 2, 256
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev,
                         dtype=torch.int32)
    for c in counters.values():
        c.n = 0
    t0 = time.perf_counter()
    fwd, _ = api.forward(model, {"tokens": toks})
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    fwd_launches = {k: c.n for k, c in counters.items()}
    want_kind = "flash_attention.tc" if dtype == "bfloat16" \
        else "flash_attention.simt"
    if fwd_launches[want_kind] != cfg.n_layers:
        raise AssertionError(f"decode vs forward ({dtype}): forward launched "
                             f"{fwd_launches}, want {cfg.n_layers} of "
                             f"{want_kind}")
    cache = api.init_decode_cache(B, S)
    t0 = time.perf_counter()
    for t in range(S):
        lg, cache = api.decode_step(model, cache, toks[:, t])
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    a, b = lg.double(), fwd[:, -1].double()
    err = float((a - b).abs().max())
    atol, rtol = DVF_LIMITS[dtype]
    lim = dict(atol=atol, rtol=rtol)
    if not bool(torch.isfinite(a).all()) or not bool(
            ((a - b).abs() <= atol + rtol * b.abs()).all()):
        raise AssertionError(f"decode vs forward ({dtype}): max abs err "
                             f"{err} outside {lim}")
    peak = torch.cuda.max_memory_allocated()
    log(f"decode vs forward (4 layers, {dtype}, B {B}, S {S}): max abs err "
        f"{err} (limit {lim}, logits max abs {float(b.abs().max())}); "
        f"forward {t_fwd:.6f} s, {S} decode steps {t_dec:.6f} s; forward "
        f"launches {fwd_launches}; peak device memory {peak} bytes")
    del model, cache, fwd
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, limit=lim, forward_s=t_fwd, decode_s=t_dec,
                forward_launches=fwd_launches, peak_device_bytes=peak,
                layers=cfg.n_layers, B=B, S=S, dtype=dtype,
                logits_max_abs=float(b.abs().max()))


REPLACES = {
    "probe_allocate": "src/repro/kernels/probe_allocate.py:167",
    "cache_probe": "src/repro/kernels/cache_probe.py:75",
    "gather_blocks": "src/repro/kernels/gather_blocks.py:39",
    "paged_attention": "src/repro/kernels/paged_attention.py:77",
    "flash_attention": "src/repro/kernels/flash_attention.py:127",
}


def kernel_entry(name, r, launches):
    entry = {"name": name, "route": "cuda",
             "source": f"src/repro_torch/kernels/csrc/{name}.cu",
             "replaces": REPLACES[name], "launches": launches,
             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r.get("bound_by", "bytes"),
             "library_ms": r.get("library_ms")}
    if "variant" in r:                 # flash: the kernel that was timed
        entry["variant"] = r["variant"]
    return entry


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2-nodes", type=int, default=23)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace one more BFS and two CC rounds, and a "
                         "window of serving steps, with torch.profiler")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import (cache_probe, flash_attention,
                                     gather_blocks, paged_attention,
                                     probe_allocate)

    t_start = time.perf_counter()
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
    hgmma = hgmma_counts(lib_path)
    log(f"HGMMA instructions per tensor-core flash kernel: {hgmma}")
    if len(hgmma) != 3 or not all(hgmma.values()):
        raise AssertionError(f"tensor-core flash kernels without wgmma: "
                             f"{hgmma}")

    kres = kernel_phase(dev, args.seed)
    kres.update(attention_kernel_phase(dev, args.seed))
    for k, v in kres.items():
        lib = v.get("library_ms")
        log(f"kernel {k}: {v['ms']:.6f} ms (plain {v['plain_ms']:.6f} ms, "
            f"bound {v['bound_ms']:.6f} ms by {v.get('bound_by', 'bytes')}"
            + (f", library {lib:.6f} ms" if lib is not None else "")
            + (f", device {v['device_ms']:.6f} ms, host "
               f"{v['host_us']:.3f} us a call" if "device_ms" in v else "")
            + (f", {v['variant']} kernel" if "variant" in v else "")
            + f", max abs err {v['max_abs_err']}) at {v['shape']}")
    log(f"kernel gather_blocks (line): {kres['gather_blocks']['line_ms']:.6f}"
        f" ms (plain {kres['gather_blocks']['line_plain_ms']:.6f} ms, bound "
        f"{kres['gather_blocks']['line_bound_ms']:.6f} ms)")

    bam = {"probe_allocate": probe_allocate.launches,
           "cache_probe": cache_probe.launches,
           "gather_blocks": gather_blocks.launches}
    attn = {"paged_attention": paged_attention.launches,
            "flash_attention": flash_attention.launches,
            "flash_attention.tc": flash_attention.variant_launches["tc"],
            "flash_attention.simt": flash_attention.variant_launches["simt"]}
    sres = slice_phase(dev, args.log2_nodes, args.seed, bam,
                       profile=args.profile)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    api, model, serve = serving_phase(dev, args.seed, attn,
                                      profile=args.profile)
    rt = roundtrip_phase(api, model, args.seed)
    del api, model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    dvf = decode_vs_forward_phase(dev, args.seed, attn)
    dvf_bf16 = decode_vs_forward_phase(dev, args.seed, attn, "bfloat16")

    launches = dict(sres["launches"])
    launches["paged_attention"] = serve["launches"]["paged_attention"]
    # the tensor-core variant's run: bf16, as the timed case
    launches["flash_attention"] = dvf_bf16["forward_launches"][
        "flash_attention"]
    kernels = [kernel_entry(name, kres[name], launches[name])
               for name in REPLACES]
    total_s = time.perf_counter() - t_start
    log(f"chip_smoke: all phases passed in {total_s:.3f} s")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        nvidia_smi=smi, device=torch.cuda.get_device_name(0),
        torch=torch.__version__, cuda=torch.version.cuda,
        build_s=t_build, build_log=build.build_log, hgmma=hgmma,
        kernels=kres,
        slice=sres, serving=serve, roundtrip=rt, decode_vs_forward=dvf,
        decode_vs_forward_bf16=dvf_bf16,
        total_s=total_s), indent=1))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
