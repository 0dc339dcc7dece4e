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
   its bound.  Both probes also bit-identical at W 2, 4, 8, 16 and 32 under
   probe_allocate's seven policy variants, on a skewed wavefront (65,536
   keys in 8 sets, buckets far over W), on all-hit and empty wavefronts,
   across two runs of one input, and as the readahead and prefetch paths
   call them (512-line windows over a 65,536-set directory); each probe's
   ``device_ms`` (a CUDA graph of 20 calls), ``host_us`` (host time to
   issue a call), ``floor_ms`` (device time of a one-key call, the fixed
   cost) and skewed device time are recorded beside its eager ``ms``;
   then the two queue kernels, ``sq_enqueue`` and ``wfq_drain``, bit for
   bit against their plain versions on every output and on the six ring
   fields after the call (``QUEUE_CHECKS``: 1, 2 and 3 segments, an empty
   and an all-invalid one, rings filled to within a few slots of their
   depth so back-pressure drops lanes, failed devices, stripe 2, 1, 4 and
   8 devices, tenant 2 of 3; the drain with and without its fault model;
   two runs of each input), one enqueue captured in a CUDA graph and
   replayed, and both timed like the probes at the fault phase's rings
   and BFS's (``QUEUE_SHAPES``), beside the plain version (eager; it
   syncs) and the byte bound; both must launch on every BaM phase below;
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
   in both, and a small non-causal ragged case in both; the model
   families' shapes in both dtypes: flash non-causal at whisper's encoder
   (B 2, 20 heads of 64, 1500 frames) and cross-attention (64 queries
   against 1500 frames), causal at llava's 2880 patches + 64 tokens (32
   over 8 heads of 128), causal with window 1024 at hymba's forward (B 2,
   25 over 5 heads of 64, S 1152); paged at olmoe's G 1 (16 heads of 128),
   whisper's G 1 (20 heads of 64), gemma3-12b's global layers (16 over 8
   heads of 256) and hymba's (25 over 5 heads of 64, 3 pages);
   ``attn_bwd``: the flash backward's two variants (dq, dk, dv) and both
   forward kernels' log-sum-exp against their plain versions
   (``ATTN_BWD_CASES``: gemma3-1b's B 4, 4 over 1 heads of 256, S 1024,
   causal with window 512 and without; hymba's 25 over 5 heads of 64,
   window 1024, S 1152; whisper's non-causal encoder, 20 heads of 64, 1500
   frames; qwen's 40 over 8 heads of 128, S 4096; a small ragged
   non-causal case; a case with rows that see no key): f32 on the
   ``"simt"`` variant within 1e-4 of the plain version's largest
   magnitude; bf16 against the plain version in f32 from the same bf16
   inputs, on ``"tc"`` (D 64, 128, 256) within ``BWD_TC_ROUNDING`` and no
   further than twice SDPA's bf16 backward, on ``"simt"`` (other D)
   within ``BWD_BF16_ROUNDING`` (Delta left out and the window one key
   too wide planted as faults that must exceed each), the variant checked
   per case, two runs bit-identical; timed beside its bound (the five
   products the function needs, which both variants do), and at
   gemma3-1b's window shape each variant, its plain version and SDPA's
   backward in its dtype (f32: the memory-efficient backend) as device
   times of a CUDA graph of 20 calls, the median of 7 replays with their
   spread;
5. the BaM slice at full size: BFS (async tokens) and CC over a
   GAP-urand-style graph of 2^23 vertices and degree 32 (E = 2^28 int32
   edges in pinned host storage), 4 KiB cache lines, a 256 MiB cache (a
   quarter of the edge list), 16 SQs x 1024 over 4 simulated Optane P5800X
   devices; depths and labels checked against scipy; every BaM kernel's
   launch count must rise; then BFS and CC again with ``prefetch=True``
   (frontier hints, an all-edge warm-up), equal to the first runs;
6. the taxi analytics: ``make_taxi_table`` at 2^27 rows (six float32
   dependent columns of 512 MiB in pinned host storage, the filter column
   on the device), 512-byte lines, a 128 MiB cache a column, selectivity
   5e-4, four simulated Optane P5800X.  Q1-Q6 through ``run_query``: every
   gathered value equal to the host column bit for bit, each value within
   1e-4 relative of ``run_query_baseline``; then three ``scan_column``
   passes over the first 2^24 rows of ``trip_dist`` (an array of their
   own, cut for the run's time) at 65,536 rows a wavefront (demand only,
   readahead of 512 lines, readahead with 4 tokens in flight): one
   checksum, numpy's within 1e-5 relative, readahead raising the hit rate
   with a prefetch accuracy of at least 0.99 and no rise in amplification;
   then the first 24 wavefronts of the 4-token readahead scan once more,
   on the card and on the CPU (the plain versions) from the cold state:
   tickets, readahead keys, values and state bit-identical after each op;
7. fault-injected rounds: a 2^24-element float32 array over 4 devices under
   ``FaultModel(0.05, 2.0, retry_budget=1, failed_devices=(1,))``, 16
   seeded read/write/flush ops of 65,536 lanes on the card and on the CPU
   (the plain versions): values, error and drop masks, cache, rings and
   metrics bit-identical, a numpy oracle of the surviving lanes exact,
   errored read lanes 0, no pin or in-flight bit left, fault counters
   non-zero; the same 16 ops once more with ``fused_rounds=False`` (the
   legacy step-by-step path) on the card, bit-identical to the fused run
   after every op; then 18 ops with readahead of 512 lines on, sequential
   reads and prefetch hints among them, held the same way (prefetches
   issued and hit);
8. the multi-tenant runtime at a deployment's size: ``BamRuntime`` over 4
   simulated Optane P5800X, 16 SQs x 1024, ``drain="deferred"``, 512-byte
   lines, a float32 cache of 65,536 sets x 8 ways (256 MiB), way quotas
   kv 4 / bfs 2 / scan 2 and the scan weighted 0.5; tenants (256 MiB of
   pinned host data each) a ``BamKVStore`` of 2^20 keys x 32 floats at
   capacity 2^21 looked up 16,384 keys a round (90 % from the first 2^17),
   a BFS over ``random_graph(2^22, 16)`` one frontier step a round, and a
   2^26-row column scanned 65,536 rows a round; 48 rounds (8 warm-up), one
   drain a round, under KV solo, partitioned and shared: every KV value
   equal to its host row, every finished BFS equal to scipy's, scan sums
   within 1e-5 of numpy, the metric invariant after every round, rings
   drained after every drain, partitioned KV hit rate at least 0.8 of
   solo; one captured ``probe_allocate`` launch of the BFS tenant (tenant
   1, ways [4, 6)) and one owner-matched ``cache_probe`` each bit-identical
   to its plain version; then the benchmark's own sizes for 16 rounds
   under a fault model, partitioned and shared, on the card and on the
   CPU: every op's outputs and ``RuntimeState`` and every drain's
   ``Completions`` (the weighted-fair stream) bit-identical;
9. serving: qwen2.5-14b at full width in bf16, its depth cut to 12 of its
   48 layers for the script's time (``SERVE_DEPTH``; random weights from
   ``--seed``) through ``ServeEngine`` with ``PagedKVManager(keep_last=
   512)``: 8 slots, max_seq 1280, 8 requests of 600-1000 prompt tokens and
   32 new tokens each; every request done, pages spilled and fetched, and
   ``paged_attention`` launched 12 times per engine step;
10. the spill/fetch round trip at full size: B 2 after 600 decode steps,
   ``keep_last=256``, so page 0 of every layer is cold; the next step's
   logits after spill + fetch bit-identical to those without the spill;
11. decode against forward: full width, depth cut to 4 layers, B 2, S 256:
   the last-token logits of 256 ``decode_step``s (paged kernel) and of
   ``forward`` (flash kernel), in float32 (TF32 off for matmuls and cuDNN;
   SIMT flash) within atol = rtol = 2e-3, and in bfloat16 (tensor-core
   flash, which must have run) within atol 0.15 (``DVF_LIMITS``);
12. serving the model families at full width and depth in bf16, each
   model freed before the next (``SERVE``): gemma3-12b (cut to 12 of its
   48 layers for the script's time, ``SERVE_DEPTH``: 10 sliding-window
   rings and 2 paged layers at ``max_seq`` 1280; 8 requests of 1030-1150
   prompt tokens, past the 1024-token window, 16 new tokens,
   ``keep_last`` 512) and olmoe-1b-7b (16 MoE layers of 64 experts, top
   8; 8 requests of 200-400 tokens, 32 new, ``keep_last`` 128, max_seq
   512), hymba-1.5b (32 layers of attention and Mamba heads in parallel,
   3 paged and 29 rings of 1024, the cache primed with 128 meta tokens at
   construction; the same requests and sizes as olmoe's, the pools 640
   positions) and xlstm-1.3b (42 mLSTM and 6 sLSTM layers, no KV cache;
   the same requests): every request done; pages spilled and fetched, as
   many fetched as spilled, where there are paged layers, none where there
   are none; ``paged_attention`` launched once per paged layer per engine
   step and priming step; ms a step beside the weight bytes a step reads
   and the decode cache's bytes;
13. decode against forward for the families in float32 (``DVF``):
   gemma3-12b at 6 layers (5 rings), B 2, S 1100, past the window;
   olmoe-1b-7b at 4 layers, B 2, S 8 (forward must drop no expert
   choice); whisper-large-v3 at 4 decoder and 4 encoder layers over 1500
   frames, B 2, S 64 (``prefill`` fills the cross-attention KV);
   llava-next-mistral-7b at 4 layers, B 2, S 256, then one forward over
   2880 patch embeddings and 64 tokens (finite, one flash launch a layer);
   hymba-1.5b at 4 layers (one a ring), B 2, S 1000 after the 128 meta
   tokens, past the window (decode primes first); xlstm-1.3b at 8 layers
   (one sLSTM), B 2, S 512 (two mLSTM chunks);
14. training, f32 with TF32 off: ``train_vs_cpu`` (gemma3-1b at full width
   cut to 6 layers, 5 windowed and 1 global, B 1, S 576, past the 512
   window: the loss and every parameter's gradient on the card against the
   same model on the CPU, within ``TRAIN_VS_CPU_LOSS`` and
   ``TRAIN_VS_CPU_GRAD`` relative norm); ``train:gemma3-1b`` (full width and
   depth, about 1.0 B parameters, remat "full", through
   ``repro_torch.launch.train.run``: a Loader over a 1M-token synthetic
   corpus, B 4, S 1024, 8 AdamW steps through ``run_training`` with a
   failure injected before step 4 and no checkpoint directory, so 12 steps
   run; finite losses, grad norms above 0, every parameter changed, one
   restart, 2 x 26 flash forward and 26 backward launches a step run, the
   backward all on its f32 ``"simt"`` variant; ms a
   step, tokens/s, peak bytes and model FLOP/s printed); ``train_ckpt``
   (gemma3-1b's smoke config with head dim 16: a failure at step 5 restores
   step 4 from ``LATEST``, final parameters and moments bit-identical to an
   uninterrupted run);
15. the mesh, on a process group of one rank over NCCL (a FileStore, no
   network): ``mesh_train:gemma3-1b`` (the ``train_vs_cpu`` width and
   depth at B 4, S 1024, f32: 3 steps of ``make_train_step(mesh=...)`` on
   a (1, 1) data/model mesh with the state sharded by ``state_shardings``,
   losses, metrics and parameters bit-identical to 3 plain steps from the
   same seed and batches; one pod-compressed step on (1, 1, 1) whose
   residual is exactly ``gf - q * scale`` of the plain gradient; ms a step
   of both; the peak bytes the mesh steps held, from
   ``torch.cuda.max_memory_allocated``) and ``flash_decode_shards`` (the
   paged kernel's log-sum-exp
   output at the serving shape, f32 and bf16, against its plain version,
   with an empty row; 1, 2, 4 and 8 shards emulated on page subsets and
   combined by ``transformer.combine_shards``, within TOL of the unsharded
   kernel in f32 and bf16 rounding of the f32 plain version in bf16; then
   qwen2.5-14b at full width, 4 layers, bf16, B 2, S 256 through
   ``prefill`` with ``flash_decode_shards`` under the mesh, the pools
   split on the page axis, logits bit-identical to the plain decode and
   every paged launch the lse variant);
16. tensor parallelism on one card (``mesh_tp:gemma3-1b``,
   ``mesh_tp:hymba-1.5b``, ``mesh_tp:xlstm-1.3b``; ``MESH_TP_CELLS``): NCCL
   takes one rank a device, so two processes, started before the mesh
   phases, wait off the card until the mesh phases' timed work is done,
   then run beside the dry run's wait and share the card in a gloo group
   on CUDA tensors as a (1, 2) data/model mesh, one cell after another,
   each at full width, depth cut, f32: ``mesh_train``'s gemma3-1b cell
   (each rank 2 of the 4 q heads, the kv projection's columns gathered to
   the one kv head, half of the MLP and of the tied vocabulary);
   hymba-1.5b at 6 layers (global {0, 3, 5}), B 2, S 1024 after the 128
   meta tokens (the window of 1024 masks), half of d_inner a rank (xm's
   and z's columns of ``mamba.w_in`` cut from both ranks' blocks) and 13
   of the 25 q heads; xlstm-1.3b at 8 layers (the sLSTM at 7), B 2, S 256,
   half of each inner dimension, 2 of the 4 heads.  3 tensor-parallel
   steps each; rank 0's losses, gradient norms and gathered parameters
   within ``STEP_TOL`` (2e-3) of 3 plain steps on the card, each
   parameter's update within ``UPDATE_TOL`` (1e-4) of the plain steps' in
   relative norm; both ranks launch the flash forward and its f32
   ``simt`` backward on the cell's q heads only (xLSTM neither); each
   rank's local weight shapes, ms a step and peak bytes printed.  Then
   ZeRO-3 block by block (``mesh_fsdp:gemma3-1b``): the gemma3-1b cell on
   a (2, 1) data/model mesh, the batch split 2 a rank, every weight's
   d_model dimension split over data, each block gathered over data in
   the layer loop and its gradient reduce-scattered back, held the same
   way against the gemma3-1b cell's plain steps, the flash kernels on all
   4 q heads, and each rank's peak within ``DRYRUN_BAND`` of the dry
   run's prediction for that cell;
17. the dry run (``dryrun``): one child process, with no card, started
   before the mesh phases and run beside them on one core, runs
   ``repro_torch.launch.dryrun.run_cell`` on a fake process group of 256
   ranks on the ``meta`` device for three cells: ``mesh_train:gemma3-1b``'s
   own (6 layers, B 4, S 1024, f32, a (1, 1) mesh), whose predicted
   ``per_device_total`` must be within ``DRYRUN_BAND`` (0.8-1.25) of the
   peak the mesh steps held on the card, ``mesh_fsdp:gemma3-1b``'s (the
   same on (2, 1), held against that cell's ranks), and
   ``gemma3-1b|train_4k|single`` at full size on the 16 x 16 mesh (its
   memory, ``fits`` and roofline printed).

With ``--profile``, one more BFS and two CC rounds, the first 64
wavefronts of the demand and readahead scans, 8 rounds of the partitioned
runtime (its checks included), a window of engine steps in each serving
phase, and one more forward in hymba's and xLSTM's decode-vs-forward
phases (where the SSM scan and the mLSTM and sLSTM run), and one more
step of ``train:gemma3-1b`` (the flash kernels' share of its device
time) run under torch.profiler (tables in ``chiprun_out/profile_*.txt``), and the serving
phases also report the host seconds spent in each KV-manager call and
the ms a step before, in and after the traced window.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches, times and bound (the BaM kernels
also with their launches in each phase of 5-8, the attention kernels in
each serving phase, each forward of 11 and 13, each training phase of
14 and each phase of 15 and 16 (16's summed over its two ranks); the paged kernel's launches with and without the
log-sum-exp; every phase sets the
counts to 0 just before it runs and reads them just after).  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import datetime
import gc
import json
import math
import pathlib
import statistics
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


def capture_graph(fn, calls, stream=None):
    """``calls`` calls of ``fn`` captured in one CUDA graph on ``stream``
    (a new one by default), after one call outside the capture."""
    import torch

    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def cuda_graph_time_ms(fn, calls=20, reps=10) -> float:
    """Device time of one call: ``calls`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events, so the host's cost of
    issuing each call is left out."""
    import torch

    graph = capture_graph(fn, calls)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def host_us_per_call(fn, calls=200, readings=5) -> float:
    """Host time to issue one call, in microseconds: the median of
    ``readings`` readings of ``calls`` back-to-back calls on the host clock,
    the device idle at the start of each (its queue takes the launches
    while they are issued)."""
    import torch

    fn()
    out = []
    for _ in range(readings):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(out)


def bound_ms(nbytes: float) -> float:
    return nbytes / PEAK_BYTES_PER_S * 1e3


def counted_run(counters, fn):
    """Run ``fn`` with every launch count set to 0 just before it and read
    just after; returns ``(result, launches, wall seconds)``, the wall on
    the host clock around work ending in a synchronise."""
    import torch

    for c in counters.values():
        c.n = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {k: c.n for k, c in counters.items()}, wall


def require_launched(name, launches) -> None:
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"{name}: never launched {missing}")


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


def skewed_keys(m, S, n_sets, gen, dev):
    """m distinct keys, shuffled, whose hashes all fall into ``n_sets`` of
    the S sets: each set's bucket of misses is far over its ways."""
    import torch
    from repro_torch.utils import mix_hash

    target = torch.zeros((S,), dtype=torch.bool, device=dev)
    target[torch.randperm(S, generator=gen, device=dev)[:n_sets]] = True
    found, n, base, chunk = [], 0, 0, 1 << 24
    while n < m:
        cand = torch.arange(base, base + chunk, device=dev, dtype=torch.int32)
        cand = cand[target[(mix_hash(cand) % S).long()]]
        found.append(cand)
        n += cand.numel()
        base += chunk
    keys = torch.cat(found)[:m]
    return keys[torch.randperm(m, generator=gen, device=dev)]


def probe_inputs(dev, seed, S=16384, m=262144, W=WAYS, skew_m=65536,
                 skew_sets=8):
    """The main path's probe inputs: a directory, m unique keys (a quarter
    resident) and a skewed wavefront of ``skew_m`` keys over ``skew_sets``
    sets."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    d = make_directory(S, W, gen, dev)
    keys = unique_keys(m, 32 * S * W, d["tags"], gen, dev)
    skew = skewed_keys(skew_m, S, skew_sets, gen, dev)
    return d, keys, skew, gen


def probe_times(d, keys, skew) -> dict:
    """Times of the two probe kernels: ``ms`` back-to-back eager calls,
    ``device_ms`` a CUDA graph of 20 calls (the host's cost of issuing
    each call left out), ``host_us`` the host's time to issue one call, and
    ``floor_ms`` the device time of a call with one key, the kernel's fixed
    cost; for probe_allocate also the skewed wavefront's device time."""
    from repro_torch.kernels.cache_probe import cache_probe_cuda
    from repro_torch.kernels.probe_allocate import probe_allocate_cuda

    dargs = (d["tags"], d["owner"], d["refcount"], d["dirty"],
             d["speculative"], d["clock_hand"])
    valid, skew_valid = keys >= 0, skew >= 0

    def pa(ks, v):
        return lambda: probe_allocate_cuda(*dargs, ks, v)

    def cp(ks):
        return lambda: cache_probe_cuda(d["tags"], ks, d["owner"], 0)

    out = {}
    for name, full, one in (
            ("probe_allocate", pa(keys, valid), pa(keys[:1], valid[:1])),
            ("cache_probe", cp(keys), cp(keys[:1]))):
        out[name] = dict(ms=cuda_time_ms(full, iters=50),
                         device_ms=cuda_graph_time_ms(full),
                         host_us=host_us_per_call(full),
                         floor_ms=cuda_graph_time_ms(one))
    out["probe_allocate"]["skewed_device_ms"] = cuda_graph_time_ms(
        pa(skew, skew_valid))
    out["cache_probe"]["skewed_device_ms"] = cuda_graph_time_ms(cp(skew))
    return out


PA_VARIANTS = [dict(), dict(tenant=1), dict(way_lo=1, way_hi=3),
               dict(spec_insert=True), dict(protect_hits=False),
               dict(tenant=2, way_lo=0, way_hi=2, spec_insert=True),
               dict(spec_insert=True, protect_hits=False)]   # readahead
# The speculative calls of the readahead and prefetch paths at the taxi
# scan's shape: a 65,536-set x 4-way directory, one 512-line window.
READAHEAD_SHAPE = dict(S=65536, W=4, m=512)


def probe_checks(dev, gen, S, m):
    """Both probes bit-identical to their plain versions at W 2, 4, 8, 16
    and 32 (m keys at the main path's W, a quarter of them at the others):
    probe_allocate under the seven policy variants, on unique keys and on a
    wavefront with duplicate and negative keys, with protect slots and an
    alloc mask; cache_probe with and without owners.  Then the all-hit and
    the empty wavefronts, and the speculative calls at the readahead
    path's shape (:func:`readahead_probe_checks`)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.cache_probe import cache_probe_cuda
    from repro_torch.kernels.probe_allocate import probe_allocate_cuda

    for W in (2, 4, 8, 16, 32):
        mw = m if W == WAYS else m // 4
        d = make_directory(S, W, gen, dev)
        keys = unique_keys(mw, 32 * S * W, d["tags"], gen, dev)
        dup = keys.clone()
        dup[mw // 2:] = keys[torch.randint(0, mw // 2, (mw - mw // 2,),
                                           generator=gen, device=dev)]
        dup[::97] = -1                    # negative keys, duplicate sets
        prot = torch.randint(-1, S * W, (mw // 4,), generator=gen,
                             device=dev, dtype=torch.int32)
        amask = torch.rand((mw,), generator=gen, device=dev) < 0.8
        owner_mixed = torch.randint(0, 2, (S, W), generator=gen, device=dev,
                                    dtype=torch.int32)
        dargs = (d["tags"], owner_mixed, d["refcount"], d["dirty"],
                 d["speculative"], d["clock_hand"])
        for kw in PA_VARIANTS:
            for ks in (keys, dup):
                args = (*dargs, ks, ks >= 0, amask, prot)
                require_equal(f"probe_allocate W={W} {kw}",
                              probe_allocate_cuda(*args, **kw),
                              ref.probe_allocate_ref(*args, **kw))
        for owner, tenant in ((owner_mixed, 1), (d["owner"], 0), (None, 0)):
            for ks in (keys, dup):
                require_equal(f"cache_probe W={W} owner={owner is not None}",
                              cache_probe_cuda(d["tags"], ks, owner, tenant),
                              ref.cache_probe_ref(d["tags"], ks, owner,
                                                  tenant))
    # all-hit: every key resident and the caller's, so nothing is granted
    d = make_directory(S, WAYS, gen, dev)
    dargs = (d["tags"], d["owner"], d["refcount"], d["dirty"],
             d["speculative"], d["clock_hand"])
    resident = d["tags"][d["tags"] >= 0]
    resident = resident[torch.randperm(resident.numel(), generator=gen,
                                       device=dev)]
    empty = resident[:0]
    for name, ks in (("all-hit", resident), ("empty", empty)):
        out = probe_allocate_cuda(*dargs, ks, ks >= 0)
        require_equal(f"probe_allocate {name}", out,
                      ref.probe_allocate_ref(*dargs, ks, ks >= 0))
        if not bool(out[0].all()) or bool(out[3].any()):
            raise AssertionError(f"probe_allocate {name}: a key missed")
        require_equal(f"cache_probe {name}",
                      cache_probe_cuda(d["tags"], ks, d["owner"], 0),
                      ref.cache_probe_ref(d["tags"], ks, d["owner"], 0))
    readahead_probe_checks(dev, gen, **READAHEAD_SHAPE)


def readahead_probe_checks(dev, gen, S, W, m):
    """probe_allocate as ``submit`` calls it for readahead (a window of m
    consecutive lines, -1 past the array's end, speculative insert, the
    wavefront's 2m hit and granted slots protected, the probe's own hits
    not, an alloc mask that skips the just-evicted lines) and for an
    explicit prefetch (speculative insert only), then cache_probe's re-probe
    of the window, all bit-identical to the plain versions.  Two windows:
    one over lines partly resident, one wholly past the resident range."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.cache_probe import cache_probe_cuda
    from repro_torch.kernels.probe_allocate import probe_allocate_cuda

    d = make_directory(S, W, gen, dev)
    dargs = (d["tags"], d["owner"], d["refcount"], d["dirty"],
             d["speculative"], d["clock_hand"])
    for base in (int(d["tags"].max()) // 2, 8 * S * W):
        ks = torch.arange(base, base + m, dtype=torch.int32, device=dev)
        ks[-m // 8:] = -1                          # clamped at the end
        prot = torch.randint(-1, S * W, (2 * m,), generator=gen, device=dev,
                             dtype=torch.int32)
        amask = torch.rand((m,), generator=gen, device=dev) < 0.9
        for name, kw, extra in (
                ("readahead", dict(spec_insert=True, protect_hits=False),
                 (amask, prot)),
                ("prefetch", dict(spec_insert=True), ())):
            args = (*dargs, ks, ks >= 0, *extra)
            require_equal(f"probe_allocate {name} S={S} m={m} base={base}",
                          probe_allocate_cuda(*args, **kw),
                          ref.probe_allocate_ref(*args, **kw))
        require_equal(f"cache_probe readahead S={S} m={m} base={base}",
                      cache_probe_cuda(d["tags"], ks, d["owner"], 0),
                      ref.cache_probe_ref(d["tags"], ks, d["owner"], 0))


# The queue kernels' shapes: the fault phase's rings (16 x 4096 over 4
# devices, device 1 failed) with a round of 65,536 lanes in 3 segments,
# and BFS's rings (16 x 1024 over 4 devices), whose round enqueues its
# reads and write-backs as 2 segments of the wavefront's lanes.
QUEUE_SHAPES = {
    "faults": dict(nq=16, depth=4096, nd=4, failed=(1,), segs=(32768, 16384,
                                                                16384)),
    "bfs": dict(nq=16, depth=1024, nd=4, failed=(), segs=(16384, 16384)),
}
# Each check: rings, devices, stripe, tenants and the submitting tenant,
# the segments' lengths (the indices in ``invalid`` all-invalid), and how
# full the rings are ("half": up to half their depth in flight; "full":
# within 2-6 slots of it, so back-pressure drops lanes).
QUEUE_CHECKS = [
    dict(QUEUE_SHAPES["faults"], fill="half"),
    dict(QUEUE_SHAPES["faults"], fill="full"),
    dict(QUEUE_SHAPES["bfs"], fill="half", segs=(16384,)),
    dict(nq=16, depth=1024, nd=8, failed=(), stripe=2, nt=3, tenant=2,
         segs=(4096, 0, 4096), invalid=(2,), fill="full"),
    dict(nq=16, depth=1024, nd=8, failed=(1, 5), stripe=1, nt=3, tenant=1,
         segs=(3000, 5000, 1), fill="half"),
    dict(nq=4, depth=256, nd=1, failed=(), segs=(3000, 2000), fill="full"),
]
QUEUE_FAULT = dict(transient_error_rate=0.05, tail_latency_mult=2.0,
                   retry_budget=1, seed=0)


def queue_inputs(c, gen, dev):
    """Rings holding pending commands (a tenth without a ticket) up to the
    check's fill, and the submission's lanes: keys with negatives, a
    twentieth invalid, the last segment readahead."""
    import torch

    nq, depth, nd = c["nq"], c["depth"], c["nd"]
    nt = c.get("nt", 1)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    head = ri(0, 1 << 20, (nq,))
    if c["fill"] == "full":
        used = depth - ri(2, 7, (nq,))
    else:
        used = ri(0, depth // 2 + 1, (nq,))
    slot = torch.arange(depth, device=dev, dtype=torch.int32)
    pend = torch.remainder(slot[None, :] - head[:, None], depth) \
        < used[:, None]

    def field(x, fill):
        return torch.where(pend, x, fill).to(x.dtype).contiguous()

    ticket = ri(0, 1 << 20, (nq, depth))
    ticket[torch.rand((nq, depth), generator=gen, device=dev) < 0.1] = -1
    rings = dict(
        sq_key=field(ri(0, 1 << 24, (nq, depth)), -1),
        sq_dst=field(ri(0, 1 << 16, (nq, depth)), -1),
        sq_is_write=field(torch.rand((nq, depth), generator=gen,
                                     device=dev) < 0.3, False),
        sq_prio=field(ri(0, 2, (nq, depth)), 0),
        sq_tenant=field(ri(0, nt, (nq, depth)), 0),
        sq_ticket=field(ticket, -1))
    state = dict(sq_tail=head + used, sq_head=head,
                 rr_ptr=ri(0, nq // nd, (nd,)),
                 dev_enqueued=ri(0, 1 << 20, (nd,)))
    segs = c["segs"]
    n = sum(segs)
    keys = ri(-2, 1 << 24, (n,))
    valid = (torch.rand((n,), generator=gen, device=dev) < 0.95) & (keys >= 0)
    prio = torch.zeros((n,), dtype=torch.int32, device=dev)
    edges = [0]
    for i, m in enumerate(segs):
        edges.append(edges[-1] + m)
        if i in c.get("invalid", ()):
            valid[edges[i]:edges[i + 1]] = False
    if len(segs) > 1:
        prio[edges[-2]:] = 1
    lanes = dict(keys=keys, dst=ri(-1, 1 << 16, (n,)),
                 is_write=torch.rand((n,), generator=gen, device=dev) < 0.3,
                 prio=prio, valid=valid)
    kw = dict(seg_bounds=tuple(zip(edges[:-1], edges[1:])), n_devices=nd,
              stripe_blocks=c.get("stripe", 1), tenant=c.get("tenant", 0),
              failed_devices=c["failed"])
    return rings, state, lanes, kw


RING_FIELDS = ("sq_key", "sq_dst", "sq_is_write", "sq_prio", "sq_tenant",
               "sq_ticket")
PER_SEG = ("n_accepted", "n_dropped", "n_doorbells", "n_tickets",
           "dev_dropped", "dev_accepted")


def enqueue_call(fn, rings, state, lanes, kw):
    """One enqueue on fresh copies of the rings: the outputs (per-segment
    counts flattened) and the six ring fields after it."""
    r = {k: v.clone() for k, v in rings.items()}
    out = fn(*(r[k] for k in RING_FIELDS), *state.values(), *lanes.values(),
             **kw)
    return list(out[:6]) + [out[6][k] for k in PER_SEG] \
        + [r[k] for k in RING_FIELDS]


def drain_call(fn, rings, c, fault):
    """One drain, with each entry's status under a fault model: the counts
    and the fault fields, status included, in a fixed order."""
    out = fn(rings["sq_key"], rings["sq_is_write"], rings["sq_tenant"],
             rings["sq_ticket"], n_devices=c["nd"], n_tenants=c.get("nt", 1),
             fault=fault, entry_status=True)
    return list(out[:5]) + [out[5][k] for k in sorted(out[5])]


def queue_checks(dev, gen) -> dict:
    """Both queue kernels bit-identical to their plain versions under
    ``QUEUE_CHECKS`` (1, 2 and 3 segments, an empty and an all-invalid
    one, rings near full, failed devices, stripe 2, 1, 4 and 8 devices,
    tenant 2 of 3), the drain with and without its fault model, each
    kernel twice on one input, and one enqueue captured in a CUDA graph
    and replayed.  Returns each check's accepted and dropped lanes."""
    import torch
    from repro_torch.core.ssd import FaultModel
    from repro_torch.kernels import ref
    from repro_torch.kernels.sq_enqueue import sq_enqueue_cuda
    from repro_torch.kernels.wfq_drain import wfq_drain_cuda

    seen = []
    for c in QUEUE_CHECKS:
        name = (f"nq={c['nq']} depth={c['depth']} nd={c['nd']} "
                f"failed={c['failed']} stripe={c.get('stripe', 1)} "
                f"tenant={c.get('tenant', 0)}/{c.get('nt', 1)} "
                f"segs={c['segs']} fill={c['fill']}")
        rings, state, lanes, kw = queue_inputs(c, gen, dev)
        got = enqueue_call(sq_enqueue_cuda, rings, state, lanes, kw)
        require_equal(f"sq_enqueue {name}", got,
                      enqueue_call(ref.sq_enqueue_ref, rings, state, lanes,
                                   kw))
        require_equal(f"sq_enqueue {name}, second run", got,
                      enqueue_call(sq_enqueue_cuda, rings, state, lanes, kw))
        after = dict(zip(RING_FIELDS, got[-6:]))
        for fault in (None, FaultModel(failed_devices=c["failed"],
                                       **QUEUE_FAULT)):
            for r in (rings, after):
                d = drain_call(wfq_drain_cuda, r, c, fault)
                require_equal(f"wfq_drain {name} fault={fault is not None}",
                              d, drain_call(ref.wfq_drain_ref, r, c, fault))
                require_equal(f"wfq_drain {name}, second run", d,
                              drain_call(wfq_drain_cuda, r, c, fault))
        acc, drop = int(got[6].sum()), int(got[7].sum())
        if c["fill"] == "full" and not drop:
            raise AssertionError(f"sq_enqueue {name}: no lane dropped on "
                                 "rings near full")
        seen.append(dict(check=name, accepted=acc, dropped=drop))

    # one enqueue captured in a CUDA graph: no host sync on the path, and
    # the replay bit-identical to the plain version
    c = QUEUE_CHECKS[0]
    rings, state, lanes, kw = queue_inputs(c, gen, dev)
    work = {k: v.clone() for k, v in rings.items()}

    outs = []
    graph = capture_graph(lambda: outs.append(sq_enqueue_cuda(
        *(work[k] for k in RING_FIELDS), *state.values(), *lanes.values(),
        **kw)), 1)
    out = outs[-1]                    # the captured call's outputs
    for k in RING_FIELDS:
        work[k].copy_(rings[k])
    graph.replay()
    torch.cuda.synchronize()
    require_equal("sq_enqueue replayed from a CUDA graph",
                  list(out[:6]) + [out[6][k] for k in PER_SEG]
                  + [work[k] for k in RING_FIELDS],
                  enqueue_call(ref.sq_enqueue_ref, rings, state, lanes, kw))
    return dict(checks=seen)


def queue_bounds(c, lanes, accepted, pending, fault) -> tuple:
    """The bytes each queue kernel must move, for this run's data: the
    enqueue reads every lane's key and valid bit (5 B) and writes its
    queue, vslot, ticket id and accepted flag (13 B); an accepted lane
    also reads its dst, is_write and prio (9 B) and writes its six ring
    fields (21 B); plus the tails, heads, pointers and device counts in
    and out and the per-segment counts.  The drain reads every entry's
    key (4 B), a pending entry's is_write and tenant (5 B) and with
    faults its ticket (4 B), and writes its counts."""
    n, nq, nd = lanes["keys"].numel(), c["nq"], c["nd"]
    s = len(c["segs"])
    enq = n * (5 + 13) + accepted * (9 + 21) + nq * 4 * 3 + nd * 4 * 3 \
        + s * 4 * (4 + 2 * nd)
    drain = nq * c["depth"] * 4 + pending * (5 + 4 * (fault is not None)) \
        + 4 * (2 + 8 * nd + 2 * c.get("nt", 1))
    return enq, drain


def queue_times(dev, gen) -> dict:
    """Each queue kernel timed at the fault phase's shape (and BFS's): eager
    ms, device ms from a CUDA graph of 20 calls, host us a call, a
    one-lane (one-entry) floor, the plain version eager (it syncs), and
    its byte bound.  No PyTorch call routes commands to rings, so there is
    no library time."""
    import torch
    from repro_torch.core.ssd import FaultModel
    from repro_torch.kernels import ref
    from repro_torch.kernels.sq_enqueue import sq_enqueue_cuda
    from repro_torch.kernels.wfq_drain import wfq_drain_cuda

    out = {"sq_enqueue": {}, "wfq_drain": {}}
    for shape, c in QUEUE_SHAPES.items():
        c = dict(c, fill="half")
        rings, state, lanes, kw = queue_inputs(c, gen, dev)
        fault = FaultModel(failed_devices=c["failed"], **QUEUE_FAULT)
        r = [rings[k] for k in RING_FIELDS]
        args = (*r, *state.values(), *lanes.values())
        dargs = (rings["sq_key"], rings["sq_is_write"], rings["sq_tenant"],
                 rings["sq_ticket"])
        dkw = dict(n_devices=c["nd"], n_tenants=1, fault=fault)

        def enq(fn=sq_enqueue_cuda, a=args):
            return fn(*a, **kw)

        def drain(fn=wfq_drain_cuda, a=dargs):
            return fn(*a, **dkw)

        accepted = int(enq()[4].sum())
        # the drain is timed on these rings, as this enqueue left them
        pending = int((rings["sq_key"] >= 0).sum())
        # a one-lane submission on rings of one queue a device, and a
        # one-entry ring
        one = [x[:c["nd"], :1].contiguous() for x in r]
        one_state = [state["sq_tail"][:c["nd"]].contiguous(),
                     state["sq_head"][:c["nd"]].contiguous(),
                     torch.zeros_like(state["rr_ptr"]),
                     state["dev_enqueued"]]
        one_args = (*one, *one_state, *(v[:1] for v in lanes.values()))
        one_kw = dict(kw, seg_bounds=((0, 1),))
        b_enq, b_drain = queue_bounds(c, lanes, accepted, pending, fault)
        for name, fn, plain, floor, nbytes in (
                ("sq_enqueue", enq, lambda: enq(ref.sq_enqueue_ref),
                 lambda: sq_enqueue_cuda(*one_args, **one_kw), b_enq),
                ("wfq_drain", drain, lambda: drain(ref.wfq_drain_ref),
                 lambda: wfq_drain_cuda(*(x[:1, :1].contiguous()
                                          for x in dargs), n_devices=1,
                                        n_tenants=1, fault=fault), b_drain)):
            t = dict(ms=cuda_time_ms(fn, iters=50),
                     device_ms=cuda_graph_time_ms(fn),
                     host_us=host_us_per_call(fn),
                     floor_ms=cuda_graph_time_ms(floor),
                     plain_ms=cuda_time_ms(plain, iters=5),
                     bound_ms=bound_ms(nbytes),
                     shape=(f"{c['nq']} x {c['depth']} rings over "
                            f"{c['nd']} devices (failed {c['failed']}), "
                            + (f"{sum(c['segs'])} lanes in "
                               f"{len(c['segs'])} segments"
                               if name == "sq_enqueue" else "fault model "
                               "on")))
            if shape == "faults":
                out[name].update(t, max_abs_err=0.0, library_ms=None,
                                 library="none: no PyTorch call routes "
                                         "commands to rings")
            else:
                out[name]["bfs"] = t
        out["sq_enqueue"].setdefault("accepted", accepted)
        out["wfq_drain"].setdefault("pending", pending)
    return out


def queue_kernel_phase(dev, seed) -> dict:
    """The two queue kernels: :func:`queue_checks`, then
    :func:`queue_times`."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed + 26)
    t0 = time.perf_counter()
    checks = queue_checks(dev, gen)
    log(f"queue kernels: sq_enqueue and wfq_drain bit-identical to their "
        f"plain versions in {len(QUEUE_CHECKS)} checks (drain with and "
        f"without faults, two runs each, one enqueue replayed from a CUDA "
        f"graph) in {time.perf_counter() - t0:.3f} s: {checks['checks']}")
    res = queue_times(dev, gen)
    res["sq_enqueue"]["checks"] = checks["checks"]
    for name, r in res.items():
        b = r["bfs"]
        log(f"kernel {name} at BFS's shape ({b['shape']}): device "
            f"{b['device_ms']:.6f} ms, eager {b['ms']:.6f} ms, host "
            f"{b['host_us']:.3f} us, floor {b['floor_ms']:.6f} ms, plain "
            f"{b['plain_ms']:.6f} ms, bound {b['bound_ms']:.6f} ms")
    return res


def kernel_phase(dev, seed, S=16384, m=262144, log2_lanes=28):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.cache_probe import cache_probe_cuda
    from repro_torch.kernels.gather_blocks import gather_blocks_cuda
    from repro_torch.kernels.probe_allocate import probe_allocate_cuda
    from repro_torch.utils import mix_hash

    W = WAYS
    d, keys, skew, gen = probe_inputs(dev, seed, S, m, W)
    valid = keys >= 0
    sets_touched = torch.unique(mix_hash(keys) % S).numel()
    results = {}

    # -- both probes bit-identical to their plain versions: the six
    #    policy variants at every way count the kernels take up to 32, a
    #    skewed wavefront (8 sets, buckets far over W), all-hit and empty
    #    wavefronts, and two runs of one input
    probe_checks(dev, gen, S, m)
    owner_mixed = torch.randint(0, 2, (S, W), generator=gen, device=dev,
                                dtype=torch.int32)
    dargs = (d["tags"], owner_mixed, d["refcount"], d["dirty"],
             d["speculative"], d["clock_hand"])
    prot = torch.randint(-1, S * W, (64,), generator=gen, device=dev,
                         dtype=torch.int32)
    for kw in (dict(), dict(tenant=2, way_lo=0, way_hi=2, spec_insert=True)):
        args = (*dargs, skew, skew >= 0, None, prot)
        require_equal(f"probe_allocate skewed {kw}",
                      probe_allocate_cuda(*args, **kw),
                      ref.probe_allocate_ref(*args, **kw))
    main = (d["tags"], d["owner"], d["refcount"], d["dirty"],
            d["speculative"], d["clock_hand"], keys, valid)
    skewed = (*main[:6], skew, skew >= 0)
    for name, args in (("main", main), ("skewed", skewed)):
        first = probe_allocate_cuda(*args)
        require_equal(f"probe_allocate {name}", first,
                      ref.probe_allocate_ref(*args))
        require_equal(f"probe_allocate {name}, second run", first,
                      probe_allocate_cuda(*args))
        first = cache_probe_cuda(d["tags"], args[6], d["owner"], 0)
        require_equal(f"cache_probe {name}", first,
                      ref.cache_probe_ref(d["tags"], args[6], d["owner"], 0))
        require_equal(f"cache_probe {name}, second run", first,
                      cache_probe_cuda(d["tags"], args[6], d["owner"], 0))
    log(f"probes: bit-identical to their plain versions at W 2-32 under the "
        f"seven variants, on the skewed, all-hit and empty wavefronts, at "
        f"the readahead path's shape, and across two runs")
    times = probe_times(d, keys, skew)
    hit, _ = cache_probe_cuda(d["tags"], keys, d["owner"], 0)
    results["cache_probe"] = dict(
        **times["cache_probe"],
        plain_ms=cuda_time_ms(lambda: ref.cache_probe_ref(
            d["tags"], keys, d["owner"], 0)),
        bound_ms=bound_ms(m * 4 + m * 5 + sets_touched * W * 4 * 2),
        max_abs_err=0.0, shape=f"S={S} W={W} m={m}",
        hit_fraction=float(hit.float().mean()))
    ok = probe_allocate_cuda(*main)[3]
    results["probe_allocate"] = dict(
        **times["probe_allocate"],
        plain_ms=cuda_time_ms(lambda: ref.probe_allocate_ref(*main)),
        bound_ms=bound_ms(m * 4 + m * 1 + sets_touched * (W * 14 + 4)
                          + m * 15),
        max_abs_err=0.0, shape=f"S={S} W={W} m={m}",
        skewed_shape=f"m={skew.numel()} keys over 8 sets",
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
    results.update(queue_kernel_phase(dev, seed))
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


# (B, Hq, Hkv, D, pages of 256, seq_lens range) of the families' decode;
# hymba's global layers hold 128 meta tokens before 200-400 prompt and 32
# new tokens
PAGED_FAMILY_SHAPES = [(8, 16, 16, 128, 2, (200, 432)),
                       (8, 20, 20, 64, 2, (64, 448)),
                       (8, 16, 8, 256, 5, (1030, 1166)),
                       (8, 25, 5, 64, 3, (328, 560))]


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
        bf16_rounding_ratio=paged_ratio, case_errs={}, case_ratios={},
        shape=("B=8 Hq=40 Hkv=8 D=128 page=256 NP=P=5 bf16, seq_lens "
               f"{sl.tolist()}, one hole per sequence"))
    # the model families' decode shapes: olmoe (G 1, D 128), whisper's
    # decoder (G 1, D 64), gemma3-12b's global layers (G 2, D 256),
    # hymba's global layers (G 5, D 64)
    for B, Hq, Hkv, D, NP, lens in PAGED_FAMILY_SHAPES:
        for dtype in ("float32", "bfloat16"):
            name = f"paged_attention B={B} Hq={Hq} Hkv={Hkv} D={D} {dtype}"
            q2, kp2, vp2, pt2, sl2 = paged_inputs(
                B, Hq, Hkv, D, 256, NP, lens, getattr(torch, dtype), gen, dev)
            out = paged_attention_cuda(q2, kp2, vp2, pt2, sl2)
            err = require_close(name, out, ref.paged_attention_ref(
                q2, kp2, vp2, pt2, sl2), dtype)
            results["paged_attention"]["case_errs"][name] = err
            errs.append(err)
            if dtype == "bfloat16":
                qf, kf, vf = q2.float(), kp2.float(), vp2.float()
                r = bf16_rounding_ratio(
                    out, ref.paged_attention_ref(qf, kf, vf, pt2, sl2),
                    ref.paged_attention_ref(qf, kf, vf.abs(), pt2, sl2))
                del qf, kf, vf
                results["paged_attention"]["case_ratios"][name] = r
                if r > 1:
                    raise AssertionError(f"{name}: {r} times the bf16 "
                                         f"rounding limit")
            log(f"{name}: max abs err {err}"
                + (f", {r} of the bf16 rounding limit"
                   if dtype == "bfloat16" else ""))
            del q2, kp2, vp2, pt2, sl2, out
    results["paged_attention"]["max_abs_err"] = max(errs)

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
    # the model families' shapes: whisper's encoder self-attention (1500
    # frames, G 1, D 64) and its cross-attention (64 text queries against
    # the 1500 frames), llava's 2880 patches plus 64 text tokens (G 4)
    cases += [(2, 20, 20, Sq, 1500, 64, False, None, dtype)
              for Sq in (1500, 64) for dtype in ("float32", "bfloat16")]
    cases += [(2, 32, 8, 2944, 2944, 128, True, None, dtype)
              for dtype in ("float32", "bfloat16")]
    # hymba's forward: 25 over 5 heads of 64 (G 5), 1024 prompt tokens
    # after its 128 meta tokens, windowed at 1024
    cases += [(2, 25, 5, 1152, 1152, 64, True, 1024, dtype)
              for dtype in ("float32", "bfloat16")]
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


# ---------------------------------------------------------- attn_bwd --
PEAK_F32_FLOPS = 67e12          # SIMT float32, NVIDIA data sheet
# The flash backward against its plain version on the same inputs.  In f32
# each gradient (and each forward's lse) within 1e-4 of the plain version's
# largest magnitude: both sum in f32, over at most Sq G terms, in other
# orders.  In bf16 the kernel reads bf16, computes in f32 and rounds each
# gradient to bf16 once, which moves an element by at most 2^-8 of its size;
# so against the plain version computed in f32 from the same bf16 inputs
# (and the forward's lse and output) an element may differ by 2^-8 of its
# size plus the f32 limit.  A planted fault (Delta left out, the window one
# key too wide) must exceed that limit.
BWD_F32_LIMIT = 1e-4
BWD_BF16_ROUNDING = dict(rel=2.0 ** -8, f32=BWD_F32_LIMIT)
# The tensor-core variant ("tc", bf16 at D 64, 128, 256) also rounds P and
# dS to bf16 before the three products that read them (dV = P^T dO, dK =
# dS^T Q, dQ = dS K): each of a gradient element's terms moves by at most
# 2^-9 of itself, independently, so the element by a random walk of
# standard deviation 2^-9 / sqrt(3) times the root-sum-square R of its
# terms (ref.flash_attention_bwd_rss_ref).  Its limit adds 4 x 2^-9 R =
# 2^-7 R to BWD_BF16_ROUNDING's: 6.9 standard deviations, and the worst
# case (every term rounded by 2^-9 in one direction) up to 16 terms.  The
# same planted faults must exceed it, and its largest error against the
# plain version may be at most twice SDPA's bf16 backward's on the same
# inputs (BWD_TC_VS_SDPA).
BWD_TC_ROUNDING = dict(rel=2.0 ** -8, rss=2.0 ** -7, f32=BWD_F32_LIMIT)
BWD_TC_VS_SDPA = 2.0
# name, B, Hq, Hkv, Sq, Skv, D, causal, window
ATTN_BWD_CASES = [
    ("gemma3-1b window", 4, 4, 1, 1024, 1024, 256, True, 512),
    ("gemma3-1b global", 4, 4, 1, 1024, 1024, 256, True, None),
    ("hymba-1.5b", 2, 25, 5, 1152, 1152, 64, True, 1024),
    ("whisper encoder", 2, 20, 20, 1500, 1500, 64, False, None),
    ("qwen2.5-14b", 1, 40, 8, 4096, 4096, 128, True, None),
    ("ragged", 2, 3, 3, 33, 65, 16, False, None),
    ("rows without a key", 1, 4, 2, 64, 24, 32, True, 8),
]


def live_pairs(Sq, Skv, causal, window) -> int:
    """Live (query, key) pairs of one head under the causal and window
    masks: the pairs this run's data needs."""
    import numpy as np

    qp = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(qp, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(qp - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def bwd_bound(q, k, pairs, dtype):
    """(bound ms, what bounds it, flops) of one backward call: 2 D flops a
    live pair for each of the five products the function needs (S, dV,
    dP, dQ, dK; both variants do just those) at the card's peak for the
    inputs' type, against q, k, v, O, dO and lse read once and dq, dk, dv
    written once."""
    B, Hq, Sq, D = q.shape
    flops = 2 * 5 * D * pairs * B * Hq
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
        + B * Hq * Sq * 4
    peak = PEAK_F32_FLOPS if dtype == "float32" else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes", flops)


def graph_spread_ms(fn, calls=20, readings=7, stream=None) -> tuple:
    """(median, least, most) device ms of one call over ``readings``
    replays, each between CUDA events, of ``calls`` calls captured in one
    CUDA graph: a time with the spread it was read within, the host's cost
    of issuing each call left out."""
    import torch

    graph = capture_graph(fn, calls, stream)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t = []
    for _ in range(readings):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        t.append(start.elapsed_time(end) / calls)
    t.sort()
    return statistics.median(t), t[0], t[-1]


def bwd_rel_err(got, want) -> float:
    """max |got - want| over the plain version's largest magnitude."""
    scale = float(want.double().abs().max())
    return float((got.double() - want.double()).abs().max()) / max(
        scale, 1e-30)


def bwd_bf16_ratio(got, want32, rss=None) -> float:
    """The largest |got - want32| / (2^-8 |want32| + 1e-4 max |want32|):
    at most 1 for a kernel whose only error beyond f32 is rounding each
    gradient to bf16 (``BWD_BF16_ROUNDING``).  With ``rss`` (the root-sum-
    square of each element's terms) the ``"tc"`` variant's limit adds 2^-7
    rss (``BWD_TC_ROUNDING``)."""
    w = want32.double()
    lim = BWD_BF16_ROUNDING["rel"] * w.abs() \
        + BWD_BF16_ROUNDING["f32"] * float(w.abs().max())
    if rss is not None:
        lim = lim + BWD_TC_ROUNDING["rss"] * rss.double()
    err = (got.double() - w).abs().nan_to_num(float("inf"))
    return float((err / lim.clamp(min=1e-30)).max())


def attention_bwd_phase(dev, seed):
    """``attn_bwd``: the flash backward's two variants and the forward
    kernels' log-sum-exp against their plain versions on the card
    (``ATTN_BWD_CASES`` in f32, on ``"simt"``, and in bf16, on ``"tc"`` at
    D 64, 128 and 256 and on ``"simt"`` elsewhere; both forward variants),
    two runs bit-identical, the planted faults over each bf16 limit,
    ``"tc"`` no further from the plain version than twice SDPA's bf16
    backward, and at the train step's shape each variant timed from a CUDA
    graph beside its bound, its plain version and SDPA's backward in its
    dtype.  TF32 off."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        bwd_launches, bwd_variant, bwd_variant_launches,
        flash_attention_bwd_cuda, flash_attention_cuda, variant)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    cases, lse_errs, errs, abs_errs, times, timed = {}, [], [], [], {}, {}
    for name, B, Hq, Hkv, Sq, Skv, D, causal, window in ATTN_BWD_CASES:
        pairs = live_pairs(Sq, Skv, causal, window)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q = torch.randn((B, Hq, Sq, D), generator=gen, device=dev).to(dt)
            k = torch.randn((B, Hkv, Skv, D), generator=gen, device=dev).to(dt)
            v = torch.randn((B, Hkv, Skv, D), generator=gen, device=dev).to(dt)
            dout = torch.randn((B, Hq, Sq, D), generator=gen,
                               device=dev).to(dt)
            kw = dict(causal=causal, window=window)
            kind, bkind = variant(q, k), bwd_variant(q, k)
            if bkind != ("tc" if dtype == "bfloat16" and D in (64, 128, 256)
                         else "simt"):
                raise AssertionError(f"attn_bwd {name} {dtype}: {bkind}")
            out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
            want_out, want_lse = ref.flash_attention_lse_ref(q, k, v, **kw)
            live = want_lse > -1e29
            if not torch.equal(live, lse > -1e29):
                raise AssertionError(f"attn_bwd {name} {dtype}: lse marks "
                                     f"other rows as having no live key")
            lse_err = bwd_rel_err(lse[live], want_lse[live])
            if lse_err > BWD_F32_LIMIT:
                raise AssertionError(f"attn_bwd {name} {dtype} ({kind}): lse "
                                     f"error {lse_err} over {BWD_F32_LIMIT}")
            lse_errs.append(lse_err)
            del want_out, want_lse
            n0, v0 = bwd_launches.n, bwd_variant_launches[bkind].n
            got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
            again = flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
            if (bwd_launches.n, bwd_variant_launches[bkind].n) \
                    != (n0 + 2, v0 + 2):
                raise AssertionError(f"attn_bwd {name}: launches not counted")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"attn_bwd {name} {dtype}: two runs of "
                                     f"one input differ")
            del again
            r = dict(kind=kind, bwd_kind=bkind, lse_err=lse_err)
            if dtype == "float32":
                want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                   **kw)
                r["errs"] = [bwd_rel_err(a, b) for a, b in zip(got, want)]
                r["abs_errs"] = [max_abs_err(a, b) for a, b in zip(got, want)]
                if max(r["errs"]) > BWD_F32_LIMIT:
                    raise AssertionError(f"attn_bwd {name} f32: errors "
                                         f"{r['errs']} over {BWD_F32_LIMIT}")
                errs.extend(r["errs"])
                abs_errs.extend(r["abs_errs"])
            else:
                f32 = [t.float() for t in (q, k, v, out)]
                do32 = dout.float()
                want = ref.flash_attention_bwd_ref(*f32, lse, do32, **kw)
                # "tc": BWD_TC_ROUNDING (its rounding points' random walk)
                rss = (ref.flash_attention_bwd_rss_ref(*f32, lse, do32, **kw)
                       if bkind == "tc" else (None,) * 3)
                r["ratios"] = [bwd_bf16_ratio(a, b, c)
                               for a, b, c in zip(got, want, rss)]
                planted = {"delta_left_out": ref.flash_attention_bwd_ref(
                    *f32[:3], torch.zeros_like(f32[3]), lse, do32, **kw)}
                if window is not None and bool(live.all()):
                    # (where a row has no live key, its lse cannot weigh a
                    # key the wider window would add)
                    planted["window_plus_one"] = ref.flash_attention_bwd_ref(
                        *f32, lse, do32, causal=causal, window=window + 1)
                r["planted"] = {p: max(bwd_bf16_ratio(a, b, c)
                                       for a, b, c in zip(got, w, rss))
                                for p, w in planted.items()}
                del planted, rss
                if bkind == "tc":
                    emul = ref.flash_attention_bwd_tc_ref(*f32, lse, do32,
                                                          **kw)
                    r["emulation_rel_errs"] = [bwd_rel_err(a, b)
                                               for a, b in zip(got, emul)]
                    del emul
                    r["rel_errs"] = [bwd_rel_err(a, b)
                                     for a, b in zip(got, want)]
                    sdpa, _ = sdpa_backward(q, k, v, dout, causal, window)
                    r["sdpa_rel_errs"] = [bwd_rel_err(a, b)
                                          for a, b in zip(sdpa(), want)]
                    del sdpa
                    if max(r["rel_errs"]) \
                            > BWD_TC_VS_SDPA * max(r["sdpa_rel_errs"]):
                        raise AssertionError(
                            f"attn_bwd {name} bf16: tc errors "
                            f"{r['rel_errs']} over {BWD_TC_VS_SDPA} x SDPA's "
                            f"{r['sdpa_rel_errs']}")
                del f32, do32
                if max(r["ratios"]) > 1 or min(r["planted"].values()) <= 1:
                    raise AssertionError(f"attn_bwd {name} bf16: ratios to "
                                         f"the bf16 limit {r}")
            del want
            ms = cuda_time_ms(lambda: flash_attention_bwd_cuda(
                q, k, v, out, lse, dout, **kw), iters=5)
            bms, by, flops = bwd_bound(q, k, pairs, dtype)
            r.update(ms=ms, bound_ms=bms, bound_by=by, flops=flops)
            times[f"{name} {dtype}"] = ms
            log(f"attn_bwd {name} {dtype}: forward {kind}, backward {bkind}, "
                f"{r}; on {nvidia_smi()}")
            if name == ATTN_BWD_CASES[0][0]:
                # the train step's shape (f32: gemma3-1b's window layers):
                # each variant and SDPA's backward in its dtype, read from a
                # CUDA graph of 20 calls
                ms, *ms_spread = graph_spread_ms(
                    lambda: flash_attention_bwd_cuda(q, k, v, out, lse,
                                                     dout, **kw))
                eff = dtype == "float32"
                sdpa, side = sdpa_backward(q, k, v, dout, causal, window,
                                           efficient=eff)
                lib_ms, *lib_spread = graph_spread_ms(sdpa, stream=side)
                del sdpa
                timed[bkind] = dict(
                    dtype=dtype, ms=ms, ms_spread=ms_spread, bound_ms=bms,
                    bound_by=by, flops=flops,
                    plain_ms=cuda_time_ms(lambda: ref.flash_attention_bwd_ref(
                        q, k, v, out, lse, dout, **kw), iters=3),
                    library_ms=lib_ms, library_ms_spread=lib_spread,
                    library=("SDPA backward, memory-efficient backend, f32, "
                             "kv heads repeated over the group" if eff else
                             "SDPA backward, bf16, PyTorch's backend"))
                log(f"attn_bwd {name} {dtype} ({bkind}) timed: "
                    f"{timed[bkind]}")
            cases[f"{name} {dtype}"] = r
            del q, k, v, dout, out, lse, got
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    entry = dict(timed["simt"], max_abs_err=max(abs_errs),
                 max_rel_err=max(errs), lse_max_rel_err=max(lse_errs),
                 variants=timed, cases=cases, times=times,
                 shape=("B=4 Hq=4 Hkv=1 S=1024 D=256 f32 causal window 512 "
                        "(gemma3-1b's window layers, the train step's "
                        "shape; the simt variant); variants: the same "
                        "shape in f32 (simt) and bf16 (tc); max_abs_err "
                        "over every f32 case, max_rel_err relative to the "
                        "plain version's largest gradient"))
    return {"flash_attention_bwd": entry}


def sdpa_backward(q, k, v, dout, causal, window, efficient=False):
    """SDPA's forward with grad on copies of q, k and v (the window as a
    boolean mask) on a side stream, and a function that runs its backward
    for ``dout`` and returns (dq, dk, dv); with the side stream, for
    ``graph_spread_ms``.  With ``efficient`` the memory-efficient backend,
    the one that takes f32, on kv heads repeated over their groups (it
    takes no GQA; dk and dv then come per query head).  The library
    yardstick, timed and compared only: the port never calls SDPA (eager
    readings of its backward ranged from 0.262 to 1.266 ms over two runs
    on an H100 80GB HBM3 at 700 W, so it is read from a CUDA graph)."""
    import contextlib

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if efficient:
        G = q.shape[1] // k.shape[1]
        k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    Sq, Skv = q.shape[2], k.shape[2]
    # autograd runs a backward on its forward's stream: the captured one
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    backend = (sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION) if efficient
               else contextlib.nullcontext())
    with torch.cuda.stream(side), backend:
        kw = dict(enable_gqa=not efficient)
        if window is None:
            o = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                               **kw)
        else:
            qp = torch.arange(Sq, device=q.device)[:, None]
            kp = torch.arange(Skv, device=q.device)[None, :]
            mask = kp > qp - window
            if causal:
                mask &= kp <= qp
            o = F.scaled_dot_product_attention(*leaves, attn_mask=mask, **kw)
    torch.cuda.current_stream().wait_stream(side)
    return (lambda: torch.autograd.grad(o, leaves, dout,
                                        retain_graph=True)), side


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
    # kernel launches issued from the host (the runtime's launch calls)
    launches = sum(e.count for e in ka if e.device_type
                   == torch.autograd.DeviceType.CPU
                   and e.key.startswith(("cudaLaunch", "cuLaunch")))
    (out_dir / f"profile_{name}.txt").write_text(
        ka.table(sort_by="self_cpu_time_total", row_limit=25) + "\n"
        + ka.table(sort_by="self_cuda_time_total", row_limit=25))
    log(f"profile {name}: wall {wall:.6f} s under the profiler, device "
        f"busy {busy:.6f} s ({busy / wall:.6f} of wall), {launches} kernel "
        f"launches")
    for e in sorted(ka, key=lambda e: -e.self_cpu_time_total)[:6]:
        log(f"  host  {e.key}: {e.self_cpu_time_total / 1e6:.6f} s "
            f"self CPU, {e.count} calls")
    for e in sorted(on_dev, key=lambda e: -dev_us(e))[:8]:
        log(f"  device {e.key}: {dev_us(e) / 1e6:.6f} s, {e.count} calls")
    return dict(wall_s=wall, device_busy_s=busy, launches=launches)


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

    # the same traversals with frontier hints (BFS) and an all-edge warm-up
    # (CC) through the readahead lane
    phase_launches = {}
    for name, fn, want in (
            ("bfs_prefetch", lambda: bfs(g, 0, prefetch=True), depth),
            ("cc_prefetch", lambda: cc(g, prefetch=True), labels)):
        (got, st), phase_launches[name], wall = counted_run(counters, fn)
        require_launched(name, phase_launches[name])
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: result differs from the run "
                                 f"without prefetch")
        m = st.metrics.summary()
        base = runs[name.split("_")[0]]
        runs[name] = dict(
            wall_s=wall, edges_traversed=m["requests"],
            edges_per_s=m["requests"] / wall, hit_rate=m["hit_rate"],
            amplification=m["amplification"], misses=m["misses"],
            prefetch_issued=m["prefetch_issued"],
            prefetch_hits=m["prefetch_hits"],
            prefetch_accuracy=m["prefetch_accuracy"],
            bytes_from_storage=m["bytes_from_storage"],
            sim_time_s=m["sim_time_s"], dropped=m["dropped"])
        log(f"{name}: wall {wall:.6f} s (without prefetch "
            f"{base['wall_s']:.6f} s), hit rate {m['hit_rate']:.6f} "
            f"({base['hit_rate']:.6f}), I/O amplification "
            f"{m['amplification']:.6f} ({base['amplification']:.6f}), "
            f"prefetch issued {m['prefetch_issued']:.0f}, hits "
            f"{m['prefetch_hits']:.0f}; launches {phase_launches[name]}; "
            f"equal to the run without prefetch")

    if profile:
        profile_runs(g)
    t_check, n_comp = scipy_check(indptr, dst, depth, labels)
    reached = int((depth >= 0).sum())
    log(f"scipy check passed in {t_check:.3f} s: {reached} vertices reached, "
        f"max depth {int(depth.max())}, {n_comp} components")
    if not np.isfinite(runs["bfs"]["sim_time_s"]):
        raise AssertionError("non-finite simulated time")
    return dict(graph_build_s=t_graph, bam_build_s=t_bam, runs=runs,
                launches=launches, phase_launches=phase_launches,
                launches_per_bfs=per_bfs,
                launches_per_cc=per_cc, peak_device_bytes=peak,
                scipy_check_s=t_check, n_vertices=n, n_edges=int(len(dst)),
                components=n_comp, vertices_reached=reached)


# --------------------------------------------------------------- phase 6 --
TAXI_ROWS = 1 << 27           # cut from the paper's 1.7B rows
TAXI_WAVE = 65536             # rows a scan wavefront: 512 lines of 512 B
TAXI_SCAN_ROWS = 1 << 24      # the scans' rows, cut for the run's time


def column_like(arr, st, data, device, prefetch=None):
    """A ``BamArray`` and its initial state over the 1-D host array
    ``data`` on ``device``, with ``arr``'s line, cache, ring and SSD
    configuration (``st`` is a state of ``arr``)."""
    from repro_torch.core.bam_array import BamArray

    return BamArray.build(
        data.reshape(1, -1), block_elems=arr.block_elems,
        num_sets=st.cache.num_sets, ways=st.cache.ways,
        num_queues=st.queues.num_queues, queue_depth=st.queues.depth,
        ssd=arr.ssd, prefetch=prefetch, device=device)


def taxi_phase(dev, seed, counters, rows=TAXI_ROWS, wave=TAXI_WAVE,
               scan_rows=TAXI_SCAN_ROWS, profile=False):
    """Q1-Q6 on a ``rows``-row table, then three scans of the first
    ``scan_rows`` rows of ``trip_dist`` (an array of their own with the
    column's configuration, so readahead stops at its end), ``wave`` rows a
    wavefront; with ``profile``, the first 64 wavefronts of the demand and
    readahead scans once more under torch.profiler (after the checks)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.analytics import taxi as T
    from repro_torch.core.prefetch import PrefetchConfig

    t0 = time.perf_counter()
    tbl = T.make_taxi_table(rows, selectivity=5e-4, block_bytes=512,
                            cache_bytes=1 << 27, seed=seed, n_devices=4,
                            device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    rows_np = np.flatnonzero(tbl.host["pickup_gid"] == T.WILLIAMSBURG)
    rows_t = torch.from_numpy(rows_np).to(dev)
    log(f"taxi: table of {rows} rows, {len(rows_np)} matching, built "
        f"in {t_build:.3f} s (host numpy + pinned columns)")

    queries, phase_launches = {}, {}
    for q, dep in T.QUERIES.items():
        (res, io), launches, wall = counted_run(
            counters, lambda: T.run_query(tbl, q))
        require_launched(f"taxi {q}", launches)
        phase_launches[f"taxi_{q}"] = launches
        for name in dep:
            v = io["values"][name]
            got = v[rows_t].cpu().numpy()
            if not np.array_equal(got.view(np.int32),
                                  tbl.host[name][rows_np].view(np.int32)):
                raise AssertionError(f"taxi {q}: {name} gathered values "
                                     f"differ from the host column")
            if int(torch.count_nonzero(v)) != int(np.count_nonzero(got)):
                raise AssertionError(f"taxi {q}: {name} has a value outside "
                                     f"the matching rows")
        t0 = time.perf_counter()
        base, bio = T.run_query_baseline(tbl, q)
        t_base = time.perf_counter() - t0
        rel = abs(res["value"] - base["value"]) / abs(base["value"])
        if not np.isfinite(res["value"]) or rel > 1e-4:
            raise AssertionError(f"taxi {q}: {res['value']} against the "
                                 f"baseline's {base['value']} (rel {rel})")
        queries[q] = dict(
            wall_s=wall, value=res["value"], baseline_value=base["value"],
            rel_err=rel, bytes_moved_total=io["bytes_moved_total"],
            amplification=io["amplification"],
            baseline_bytes_moved_total=bio["bytes_moved_total"],
            baseline_amplification=bio["amplification"],
            baseline_host_s=t_base, launches=launches)
        log(f"taxi {q}: wall {wall:.6f} s, value {res['value']} (baseline "
            f"{base['value']}, rel {rel:.3e}), bytes moved "
            f"{io['bytes_moved_total']:.0f} (baseline "
            f"{bio['bytes_moved_total']:.0f}), amplification "
            f"{io['amplification']:.6f} (baseline "
            f"{bio['amplification']:.6f}); gathered values bit-identical "
            f"to the host column; launches {launches}")
        del res, io

    host = tbl.host["trip_dist"][:scan_rows]
    want = float(host.astype(np.float64).sum())
    arr0, cold = column_like(tbl.cols["trip_dist"], tbl.states["trip_dist"],
                             host, dev)
    stbl = T.TaxiTable(n_rows=scan_rows, pickup=tbl.pickup[:scan_rows],
                       cols={}, states={}, host={"trip_dist": host})
    del tbl                         # the six pinned columns go here
    gc.collect()
    ra = PrefetchConfig(enabled=True, window=wave // 128)
    scans = {}
    for name, cfg, window in (("demand", PrefetchConfig(), 0),
                              ("readahead", ra, 0),
                              ("readahead_w4", ra, 4)):
        stbl.cols["trip_dist"] = arr0.with_prefetch(cfg)
        stbl.states["trip_dist"] = cold.clone()
        (total, m), launches, wall = counted_run(
            counters, lambda: T.scan_column(stbl, "trip_dist",
                                            wavefront=wave,
                                            window=window))
        require_launched(f"scan {name}", launches)
        phase_launches[f"scan_{name}"] = launches
        scans[name] = dict(
            wall_s=wall, checksum=total, hit_rate=m["hit_rate"],
            misses=m["misses"], prefetch_issued=m["prefetch_issued"],
            prefetch_hits=m["prefetch_hits"],
            prefetch_accuracy=m["prefetch_accuracy"],
            amplification=m["amplification"], sim_time_s=m["sim_time_s"],
            launches=launches)
        log(f"scan {name}: wall {wall:.6f} s, checksum {total!r}, hit rate "
            f"{m['hit_rate']:.6f}, misses {m['misses']:.0f}, prefetch "
            f"issued/hits {m['prefetch_issued']:.0f}/"
            f"{m['prefetch_hits']:.0f}, amplification "
            f"{m['amplification']:.6f}, sim_time_s {m['sim_time_s']:.6f}; "
            f"launches {launches}")
    sums = {s_["checksum"] for s_ in scans.values()}
    rel = abs(scans["demand"]["checksum"] - want) / want
    if len(sums) != 1 or rel > 1e-5:
        raise AssertionError(f"scan checksums {sums} (numpy {want}, rel "
                             f"{rel})")
    demand = scans["demand"]
    for name in ("readahead", "readahead_w4"):
        s_ = scans[name]
        if not (s_["hit_rate"] > demand["hit_rate"]
                and s_["prefetch_accuracy"] >= 0.99
                and s_["amplification"] <= demand["amplification"]):
            raise AssertionError(f"scan {name}: hit rate {s_['hit_rate']} "
                                 f"(demand {demand['hit_rate']}), accuracy "
                                 f"{s_['prefetch_accuracy']}, amplification "
                                 f"{s_['amplification']} (demand "
                                 f"{demand['amplification']})")
    log(f"scans: one checksum, numpy's {want!r} within rel {rel:.3e}; "
        f"readahead raised the hit rate, accuracy >= 0.99, amplification "
        f"did not rise")
    scans["readahead_w4"]["vs_cpu"] = scan_vs_cpu(
        stbl, arr0.with_prefetch(ra), cold.clone(), wave, window=4)
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprof
        head = dataclasses.replace(stbl, n_rows=64 * wave)
        for name, cfg in (("scan_demand", PrefetchConfig()),
                          ("scan_readahead", ra)):
            head.cols["trip_dist"] = arr0.with_prefetch(cfg)
            head.states["trip_dist"] = cold.clone()
            torch.cuda.synchronize()
            with tprof(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                T.scan_column(head, "trip_dist", wavefront=wave)
                torch.cuda.synchronize()
                t_prof = time.perf_counter() - t0
            pt = scans[name.split("_", 1)[1]]["profile"] = profile_table(
                name, prof, t_prof)
            log(f"profile {name}: {pt['launches'] / 64:.2f} kernel launches "
                f"a wavefront over 64 wavefronts")
    del stbl, cold, arr0
    return dict(rows=rows, scan_rows=scan_rows,
                matching_rows=int(len(rows_np)),
                build_s=t_build, queries=queries, scans=scans,
                numpy_checksum=want, phase_launches=phase_launches)


def scan_vs_cpu(tbl, arr, st, wave, window, waves=24) -> dict:
    """The first ``waves`` wavefronts of a ``scan_column`` of
    ``trip_dist`` through ``arr`` (readahead on) with ``window`` tokens in
    flight, from state ``st`` on the card and from a CPU array built alike
    from the host column (the plain versions of the kernels): the tokens'
    readahead keys and tickets after each submit, and the values and the
    whole cache, ring and metrics state after each wait, bit-identical."""
    import collections

    import numpy as np
    import torch
    from repro_torch.core.bam_array import IORequest
    from repro_torch.interop import state_to_numpy

    t0 = time.perf_counter()
    ca, cst = column_like(arr, st, tbl.host["trip_dist"], "cpu",
                          prefetch=arr.prefetch_cfg)
    sides = {"card": [arr, st, collections.deque()],
             "cpu": [ca, cst, collections.deque()]}

    def same(what, a, b):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if a.dtype != b.dtype or not np.array_equal(
                a.view(np.int32) if a.dtype == np.float32 else a,
                b.view(np.int32) if b.dtype == np.float32 else b):
            raise AssertionError(f"scan vs CPU: {what} differs")

    def wait_both(i):
        out = {}
        for side, (a, s_, pend) in sides.items():
            s_, v = a.wait(s_, pend.popleft())
            sides[side][1] = s_
            out[side] = v
        same(f"values of wavefront {i}", out["card"], out["cpu"])
        gs, cs = state_to_numpy(sides["card"][1]), state_to_numpy(
            sides["cpu"][1])
        for k in cs:
            if not np.array_equal(gs[k], cs[k]):
                raise AssertionError(f"scan vs CPU: {k} differs after "
                                     f"wavefront {i}")

    claimed = 0
    for i in range(waves):
        toks = {}
        for side, (a, s_, pend) in sides.items():
            idx = torch.arange(i * wave, (i + 1) * wave, dtype=torch.int32,
                               device=a.device)
            s_, tok = a.submit(s_, IORequest.read(idx))
            sides[side][1] = s_
            pend.append(tok)
            toks[side] = tok
        for f in ("ticket", "ra_keys", "ra_ticket"):
            same(f"{f} of wavefront {i}", getattr(toks["card"], f),
                 getattr(toks["cpu"], f))
        claimed += int((toks["cpu"].ra_keys >= 0).sum())
        if len(sides["card"][2]) >= window:
            wait_both(i - window + 1)
    for j in range(len(sides["card"][2])):
        wait_both(waves - window + 1 + j)
    if claimed == 0:
        raise AssertionError("scan vs CPU: readahead claimed no line")
    wall = time.perf_counter() - t0
    log(f"scan vs CPU: {waves} wavefronts of {wave} rows with {window} "
        f"tokens in flight, readahead claims {claimed} lines; tickets, "
        f"readahead keys, values and state bit-identical to the CPU run "
        f"after every op ({wall:.3f} s)")
    return dict(waves=waves, window=window, claimed=claimed, wall_s=wall)


# --------------------------------------------------------------- phase 7 --
# The fault phase's readahead run: sequential reads ("seq", each going on
# where the last one stopped) under a 512-line readahead window, and
# prefetch hints ("hint") whose lanes the next random read reads.
FAULT_READAHEAD_OPS = ["seq", "seq", "hint", "read", "write", "seq", "seq",
                       "flush", "read", "hint", "read", "seq", "write",
                       "seq", "seq", "write", "read", "flush"]


def fault_phase(dev, seed, counters, size=1 << 24, lanes=65536,
                readahead=False):
    """16 seeded read/write/flush ops of ``lanes`` lanes on a ``size``
    element array under an enabled fault model, on the card and on the
    CPU, held bit for bit and against a numpy oracle.  With ``readahead``
    the array reads ahead 512 lines and the ops are
    ``FAULT_READAHEAD_OPS``, with sequential reads and prefetch hints."""
    import numpy as np
    import torch
    from repro_torch.core.bam_array import BamArray, IORequest
    from repro_torch.core.prefetch import PrefetchConfig
    from repro_torch.core.ssd import (ArrayOfSSDs, FaultModel,
                                      INTEL_OPTANE_P5800X)
    from repro_torch.interop import state_to_numpy

    fault = FaultModel(transient_error_rate=0.05, tail_latency_mult=2.0,
                       retry_budget=1, failed_devices=(1,), seed=0)
    rng = np.random.default_rng(seed + 5)
    data = rng.standard_normal(size).astype(np.float32)
    cfg = dict(block_elems=128, num_sets=4096, ways=4, num_queues=16,
               queue_depth=4096,
               ssd=ArrayOfSSDs(INTEL_OPTANE_P5800X, 4, fault=fault),
               prefetch=PrefetchConfig(enabled=readahead,
                                       window=lanes // 128))
    if readahead:
        rng = np.random.default_rng(seed + 6)
        kinds = FAULT_READAHEAD_OPS
    else:
        kinds = rng.permutation(["read"] * 8 + ["write"] * 6
                                + ["flush"] * 2)
    ops, hint = [], None
    pos = int(rng.integers(0, size // 2)) if readahead else 0
    for kind in kinds:
        if kind == "seq":
            ops.append((kind, np.arange(pos, pos + lanes, dtype=np.int32),
                        None))
            pos += lanes
        elif kind in ("read", "hint"):
            idx = rng.integers(-2, size + 3, lanes).astype(np.int32)
            if kind == "read" and hint is not None:
                idx, hint = hint, None
            elif kind == "hint":
                hint = idx
            ops.append((kind, idx, None))
        elif kind == "write":
            ops.append((kind, rng.choice(size, lanes, replace=False).astype(
                np.int32), rng.standard_normal(lanes).astype(np.float32)))
        else:
            ops.append((kind, None, None))

    def run(device, fused_rounds=True):
        arr, st = BamArray.build(data, device=device,
                                 fused_rounds=fused_rounds, **cfg)
        outs = []
        for kind, idx, vals in ops:
            if kind == "flush":
                st = arr.flush(st)
                outs.append((None, state_to_numpy(st)))
                continue
            i = torch.from_numpy(idx).to(device)
            if kind == "write":
                req = IORequest.write(i, torch.from_numpy(vals).to(device))
            elif kind == "hint":
                req = IORequest.prefetch(i)
            else:
                req = IORequest.read(i)
            st, tok = arr.submit(st, req)
            st, v, e = arr.wait_ex(st, tok)
            outs.append(((v.cpu().numpy(), e.cpu().numpy(),
                          tok.dropped_mask.cpu().numpy()),
                         state_to_numpy(st)))
        st = arr.flush(st)
        return arr, st, outs

    name = "faults_readahead" if readahead else "faults"
    (ga, gst, gouts), launches, wall = counted_run(counters, lambda: run(dev))
    require_launched(name, launches)
    t0 = time.perf_counter()
    ca, cst, couts = run("cpu")
    t_cpu = time.perf_counter() - t0
    gouts.append((None, state_to_numpy(gst)))        # after the last flush
    couts.append((None, state_to_numpy(cst)))
    for i, ((gv, gs), (cv, cs)) in enumerate(zip(gouts, couts)):
        for j, (a, b) in enumerate(zip(gv or (), cv or ())):
            if a.dtype != b.dtype or not np.array_equal(
                    a.view(np.int32) if a.dtype == np.float32 else a,
                    b.view(np.int32) if b.dtype == np.float32 else b):
                raise AssertionError(f"{name} op {i}: output {j} differs "
                                     f"from the CPU run")
        for k in cs:
            if not np.array_equal(gs[k], cs[k]):
                raise AssertionError(f"{name} op {i}: {k} differs from the "
                                     f"CPU run")
    oracle, n_err = data.copy(), 0
    for (kind, idx, vals), (out, _) in zip(ops, gouts[:-1]):
        if kind in ("read", "seq"):
            v, e, _ = out
            ok = (idx >= 0) & (idx < size) & ~e
            if not np.array_equal(v[ok], oracle[idx[ok]]) or v[e].any():
                raise AssertionError(f"{name}: a read lane disagrees with "
                                     f"the numpy oracle")
            n_err += int(e.sum())
        elif kind == "hint":
            v, e, _ = out
            if v.any():
                raise AssertionError(f"{name}: a prefetch returned values")
            n_err += int(e.sum())
        elif kind == "write":
            e = out[1]
            oracle[idx[~e]] = vals[~e]
            n_err += int(e.sum())
    if not (np.array_equal(ga.storage.data.numpy().reshape(-1)[:size],
                           oracle)
            and torch.equal(ga.storage.data, ca.storage.data)):
        raise AssertionError(f"{name}: storage after the last flush differs "
                             "from the numpy oracle or the CPU run")
    if bool(gst.cache.refcount.any()) or bool(gst.cache.inflight.any()):
        raise AssertionError(f"{name}: a pin or in-flight bit was left")
    legacy = None
    if not readahead:
        # the legacy step-by-step path on the card, op for op against the
        # fused run
        (la, lst, louts), legacy, t_legacy = counted_run(
            counters, lambda: run(dev, fused_rounds=False))
        require_launched(f"{name}_legacy", legacy)
        louts.append((None, state_to_numpy(lst)))
        for i, ((gv, gs), (lv, ls)) in enumerate(zip(gouts, louts)):
            for j, (a, b) in enumerate(zip(gv or (), lv or ())):
                if not np.array_equal(a, b):
                    raise AssertionError(f"{name} legacy op {i}: output {j} "
                                         "differs from the fused run")
            for k in gs:
                if not np.array_equal(gs[k], ls[k]):
                    raise AssertionError(f"{name} legacy op {i}: {k} differs "
                                         "from the fused run")
        if not torch.equal(la.storage.data, ga.storage.data):
            raise AssertionError(f"{name} legacy: storage differs")
        log(f"{name}: the same ops with fused_rounds=False on the card in "
            f"{t_legacy:.6f} s: values, masks and state bit-identical to the "
            f"fused run after every op; launches {legacy}")
    m = gst.metrics.summary()
    if not (m["transient_errors"] > 0 and m["retries"] > 0
            and m["failed_commands"] > 0 and m["degraded_reads"] == n_err
            and m["dev_reads"][1] == 0):
        raise AssertionError(f"{name}: counters {m}")
    if readahead and not (m["prefetch_issued"] > 0
                          and m["prefetch_hits"] > 0):
        raise AssertionError(f"{name}: no prefetch issued or hit: {m}")
    log(f"{name}: {len(ops)} ops of {lanes} lanes on a {size}-element array "
        f"over 4 devices (device 1 failed): card {wall:.6f} s, CPU "
        f"{t_cpu:.6f} s; values, error and drop masks, cache, rings and "
        f"metrics bit-identical to the CPU run; oracle exact; transient "
        f"errors {m['transient_errors']:.0f}, retries {m['retries']:.0f}, "
        f"failed commands {m['failed_commands']:.0f}, degraded lanes "
        f"{n_err}, dropped {m['dropped']:.0f}, prefetch issued/hits "
        f"{m['prefetch_issued']:.0f}/{m['prefetch_hits']:.0f}; launches "
        f"{launches}")
    return dict(ops=[o[0] for o in ops], lanes=lanes, size=size, wall_s=wall,
                cpu_s=t_cpu, degraded_lanes=n_err,
                transient_errors=m["transient_errors"], retries=m["retries"],
                failed_commands=m["failed_commands"], dropped=m["dropped"],
                prefetch_issued=m["prefetch_issued"],
                prefetch_hits=m["prefetch_hits"],
                sim_time_s=m["sim_time_s"], launches=launches,
                legacy_launches=legacy)


# --------------------------------------------------------------- phase 8 --
# The shared multi-tenant runtime at a deployment's size: the scenario of
# benchmarks/mixed_tenants.py (a KV store with a hot set, a BFS, a column
# scan, all against one cache and one ring pool, drained once a round) with
# 512-byte lines, a 256 MiB cache of 65,536 sets x 8 ways, and each tenant's
# data 256 MiB in pinned host storage.
RT_DEPLOY = dict(
    line=128, sets=65536, quotas=(4, 2, 2), scan_weight=0.5,
    n_keys=1 << 20, value=32, capacity=1 << 21, hot=1 << 17, hot_frac=0.9,
    batch=16384, nodes=1 << 22, deg=16, scan_rows=1 << 26, scan_wave=65536,
    rounds=48, warm=8, queues=16, depth=1024)
# benchmarks/mixed_tenants.py's own (non-smoke) sizes, held card against CPU
RT_SMALL = dict(
    line=32, sets=64, quotas=(4, 2, 2), scan_weight=0.5,
    n_keys=2048, value=8, capacity=4096, hot=128, hot_frac=0.9, batch=256,
    nodes=2048, deg=8, scan_rows=1 << 15, scan_wave=4096, rounds=16,
    warm=0, queues=8, depth=1024)
INF_DEPTH = 2 ** 30


def runtime_data(cfg, seed):
    """The three tenants' host data, from ``seed``: the KV table (keys
    0..n_keys-1, ``value`` floats each, placed at ``capacity``), the CSR
    graph and a positive float32 column (trip distances)."""
    import numpy as np
    from repro_torch.core.bam_array import BamKVStore
    from repro_torch.graph.analytics import random_graph

    rng = np.random.default_rng(seed + 7)
    t0 = time.perf_counter()
    values = rng.standard_normal((cfg["n_keys"], cfg["value"])).astype(
        np.float32)
    table, store_vals, cap = BamKVStore.build_table(
        np.arange(cfg["n_keys"], dtype=np.int32), values,
        capacity=cfg["capacity"], probes=8)
    t_kv = time.perf_counter() - t0
    t0 = time.perf_counter()
    indptr, dst = random_graph(cfg["nodes"], cfg["deg"], seed=seed + 1)
    t_graph = time.perf_counter() - t0
    col = rng.random(cfg["scan_rows"], dtype=np.float32)
    brng = np.random.default_rng(seed + 1000)
    batches = []
    for _ in range(cfg["rounds"]):
        hot = brng.integers(0, cfg["hot"], cfg["batch"])
        cold = brng.integers(0, cfg["n_keys"], cfg["batch"])
        pick = brng.random(cfg["batch"]) < cfg["hot_frac"]
        batches.append(np.where(pick, hot, cold).astype(np.int32))
    return dict(values=values, table=table, store_vals=store_vals,
                capacity=cap, indptr=indptr, dst=dst.astype(np.int32),
                col=col, batches=batches, build_table_s=t_kv,
                graph_s=t_graph)


class RuntimeBfs:
    """One BFS frontier step a round over the runtime tenant "bfs",
    restarting from the next source (+17) when a traversal ends, as the
    reference benchmark's ``_BfsDriver`` does; finished traversals are
    kept as ``(source, depth)``, -1 unreached."""

    def __init__(self, rt, rst, indptr):
        import torch
        from repro_torch.graph.analytics import BamGraph

        self.rt = rt
        self.g = BamGraph.from_runtime(rt, rst, "bfs", indptr)
        self.finished = []
        self.depth = torch.empty((self.g.n_nodes,), dtype=torch.int32,
                                 device=self.g.device)
        self._start(0)

    def _start(self, source):
        self.source, self.it = source, 0
        self.depth.fill_(INF_DEPTH)
        self.depth[source] = 0

    def round(self, rst):
        import torch

        g = self.g
        active = (self.depth == self.it)[g.edge_src]
        nbrs, rst = self.rt.read(rst, "bfs", torch.where(active, g.edge_ids,
                                                         -1), active)
        nbrs = nbrs[active].to(torch.int64)
        first = nbrs[self.depth[nbrs] >= INF_DEPTH]
        self.depth[first] = self.it + 1
        self.it += 1
        if first.numel() == 0:
            self.finished.append((self.source, torch.where(
                self.depth >= INF_DEPTH, -1, self.depth).cpu().numpy()))
            self._start((self.source + 17) % g.n_nodes)
        return rst


def mixed_tenants(cfg, data, dev, isolation, *, neighbours=True, fault=None,
                  on_op=None, capture=None):
    """One interleaved run: each round one scan wavefront, one KV batch
    and one BFS step, then one drain of the shared rings.  ``on_op(label,
    rst, outputs)`` sees the state after every op and ``on_op("drain",
    rst, comps)`` after every drain.  Checks every KV value against its
    host row, every scan wave's sum against numpy (1e-5), the metric
    invariant after every round and ring conservation after every drain
    (without a fault model: ``fault`` withholds errored lanes' values).
    Returns per-tenant window summaries, the wall of the rounds and the
    finished BFS traversals."""
    import numpy as np
    import torch
    from repro_torch.analytics.taxi import scan_column_runtime
    from repro_torch.core.bam_array import BamKVStore, BamRuntime, TenantSpec
    from repro_torch.core.ssd import (ArrayOfSSDs, FaultModel,
                                      INTEL_OPTANE_P5800X)

    kq, bq, sq = cfg["quotas"]
    line = cfg["line"]
    specs = [TenantSpec("kv", data["store_vals"], line, ways=kq)]
    if neighbours:
        specs += [TenantSpec("bfs", data["dst"], line, ways=bq),
                  TenantSpec("scan", data["col"], line, ways=sq,
                             weight=cfg["scan_weight"])]
    ssd = ArrayOfSSDs(INTEL_OPTANE_P5800X, 4, fault=fault or FaultModel())
    rt, rst = BamRuntime.build(
        specs, num_sets=cfg["sets"], ways=kq + (bq + sq if neighbours else 0),
        num_queues=cfg["queues"], queue_depth=cfg["depth"], ssd=ssd,
        isolation=isolation, drain="deferred", device=dev)
    kv = BamKVStore(array=rt.array("kv"), capacity=data["capacity"],
                    value_elems=cfg["value"], probes=8)
    table = torch.from_numpy(data["table"]).to(dev)
    check_vals = fault is None or not fault.enabled
    values = torch.from_numpy(data["values"]).to(dev) if check_vals else None
    bfs = RuntimeBfs(rt, rst, data["indptr"]) if neighbours else None
    col, wave, rows = data["col"], cfg["scan_wave"], cfg["scan_rows"]
    on_card = torch.device(dev).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    pos, start_summ, wall, n_waves = 0, None, 0.0, 0
    for r in range(cfg["rounds"]):
        if r == cfg["warm"]:
            start_summ = {n: rt.tenant_summary(rst, n) for n in rt.tenants}
            wall = 0.0
        keys = torch.from_numpy(data["batches"][r]).to(dev)
        sync()
        t0 = time.perf_counter()
        if neighbours:
            part, rst, nxt = scan_column_runtime(
                rt, rst, "scan", n_rows=rows, wavefront=wave, start=pos,
                waves=1)
            if on_op:
                on_op("scan", rst, [torch.tensor(part)])
        st = rt.tenant_view(rst, "kv")
        vals, found, st = kv.lookup(st, table, keys)
        rst = rt.absorb(rst, "kv", st)
        if on_op:
            on_op("kv", rst, [vals, found])
        if neighbours:
            rst = bfs.round(rst)
            if on_op:
                on_op("bfs", rst, [bfs.depth])
        rst, comps = rt.drain(rst)
        sync()
        wall += time.perf_counter() - t0
        if on_op:
            on_op("drain", rst, comps)
        # the round's checks, outside the timed section
        if not bool(found.all()):
            raise AssertionError("kv lookup lost keys under sharing")
        if check_vals and not torch.equal(vals, values[keys.long()]):
            raise AssertionError(f"round {r}: a KV value differs from its "
                                 "host row")
        if neighbours:
            want = float(col[pos:pos + wave].astype(np.float64).sum())
            if check_vals and not np.isclose(part, want, rtol=1e-5, atol=0):
                raise AssertionError(f"round {r}: scan sum {part} against "
                                     f"numpy's {want}")
            pos, n_waves = nxt, n_waves + 1
        rt.assert_metrics_consistent(rst)
        qs = rst.queues
        if not torch.equal(qs.tenant_enqueued, qs.tenant_completed):
            raise AssertionError(f"round {r}: rings not drained: "
                                 f"{qs.tenant_enqueued.tolist()} enqueued, "
                                 f"{qs.tenant_completed.tolist()} completed")
    out = {}
    for n in rt.tenants:
        end = rt.tenant_summary(rst, n)
        s0 = start_summ[n] if start_summ else {k: 0.0 for k in end}
        d = {k: end[k] - s0[k] for k in ("hits", "misses", "requests",
                                         "bytes_requested",
                                         "bytes_from_storage", "dropped")}
        d["hit_rate"] = d["hits"] / max(d["hits"] + d["misses"], 1.0)
        d["amplification"] = d["bytes_from_storage"] / max(
            d["bytes_requested"], 1.0)
        out[n] = d
    return dict(tenants=out, wall_s=wall,
                rounds_timed=cfg["rounds"] - cfg["warm"],
                finished=bfs.finished if bfs else [],
                summary=rst.metrics.summary())


def bfs_depths_scipy(a, source):
    """BFS depths from ``source`` over the CSR matrix ``a`` by scipy's
    breadth-first order (its predecessors, followed level by level), -1
    unreached."""
    import numpy as np
    from scipy.sparse import csgraph

    n = a.shape[0]
    order, pred = csgraph.breadth_first_order(a, source, directed=True,
                                              return_predecessors=True)
    depth = np.full(n, -1, np.int64)
    depth[order] = 0
    has = pred >= 0
    while True:
        nxt = np.where(has, depth[np.where(has, pred, 0)] + 1, depth)
        if np.array_equal(nxt, depth):
            return depth.astype(np.int32)
        depth = nxt


def _scipy_depths_of(shared, source):
    """One worker's :func:`bfs_depths_scipy`, over the CSR arrays in the
    shared-memory blocks ``shared`` ((name, shape, dtype) of indptr and
    indices)."""
    import numpy as np
    import scipy.sparse as sp
    from multiprocessing import shared_memory

    blocks = [shared_memory.SharedMemory(name=name) for name, _, _ in shared]
    indptr, dst = (np.ndarray(shape, dtype, buffer=b.buf)
                   for b, (_, shape, dtype) in zip(blocks, shared))
    n = indptr.shape[0] - 1
    a = sp.csr_matrix((np.ones(dst.shape[0], np.float64), dst.copy(),
                       indptr.copy()), shape=(n, n))
    del indptr, dst
    for b in blocks:
        b.close()
    return source, bfs_depths_scipy(a, source)


def scipy_depths(indptr, dst, sources) -> dict:
    """:func:`bfs_depths_scipy` from each source, in spawned worker
    processes (one a source, at most the host's cores) that read the graph
    from shared memory; the workers end with the pool and the blocks are
    unlinked."""
    import multiprocessing
    import os

    import numpy as np
    from multiprocessing import shared_memory

    blocks, shared = [], []
    for arr in (np.asarray(indptr, np.int32), np.asarray(dst, np.int32)):
        b = shared_memory.SharedMemory(create=True, size=arr.nbytes)
        np.ndarray(arr.shape, arr.dtype, buffer=b.buf)[:] = arr
        blocks.append(b)
        shared.append((b.name, arr.shape, arr.dtype.str))
    try:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(max(1, min(len(sources), os.cpu_count() or 1))) as pool:
            return dict(pool.starmap(_scipy_depths_of,
                                     [(shared, s) for s in sources]))
    finally:
        for b in blocks:
            b.close()
            b.unlink()


def capture_probes(tenant, way_lo):
    """Wrap the probe dispatchers so that the widest ``probe_allocate``
    launch of ``tenant`` with way window from ``way_lo`` and the widest
    owner-matched ``cache_probe`` of ``tenant`` keep copies of their
    inputs; returns ``(captured, restore)``."""
    import torch
    from repro_torch.kernels import ops

    captured, orig = {}, (ops.probe_allocate, ops.cache_probe)

    def keep(args, kw):
        copy = (lambda x: x.clone() if isinstance(x, torch.Tensor) else x)
        return [copy(a) for a in args], {k: copy(v) for k, v in kw.items()}

    def wider(name, keys):
        return name not in captured \
            or keys.shape[0] > captured[name][0][-1].shape[0]

    def pa(*args, **kw):
        if kw.get("tenant") == tenant and kw.get("way_lo") == way_lo \
                and wider("probe_allocate", args[6]):
            captured["probe_allocate"] = keep(args, kw)
        return orig[0](*args, **kw)

    def cp(*args, **kw):
        if kw.get("tenant") == tenant and kw.get("owner") is not None \
                and wider("cache_probe", args[1]):
            captured["cache_probe"] = keep(args[:2], kw)
        return orig[1](*args, **kw)

    ops.probe_allocate, ops.cache_probe = pa, cp

    def restore():
        ops.probe_allocate, ops.cache_probe = orig

    return captured, restore


def captured_probe_checks(captured) -> dict:
    """Each captured launch again, kernel against plain version, bit for
    bit."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.cache_probe import cache_probe_cuda
    from repro_torch.kernels.probe_allocate import probe_allocate_cuda

    args, kw = captured["probe_allocate"]
    kw = dict(kw)
    extra = [kw.pop("valid"), kw.pop("alloc_mask"), kw.pop("protect_slots")]
    got = probe_allocate_cuda(*args, *extra, **kw)
    want = ref.probe_allocate_ref(*args, *extra, **kw)
    require_equal("probe_allocate (runtime capture)", got, want)
    pa = dict(m=int(args[6].shape[0]), tenant=kw["tenant"],
              way_window=[kw["way_lo"], kw["way_hi"]],
              spec_insert=kw["spec_insert"], hits=int(want[0].sum()),
              granted=int(want[3].sum()))
    args, kw = captured["cache_probe"]
    got = cache_probe_cuda(*args, **kw)
    want = ref.cache_probe_ref(*args, **kw)
    require_equal("cache_probe (runtime capture)", got, want)
    cp = dict(m=int(args[1].shape[0]), tenant=kw["tenant"],
              hits=int(want[0].sum()))
    return dict(probe_allocate=pa, cache_probe=cp)


def runtime_phase(dev, seed, counters, profile=False):
    """The deployment under KV solo, partitioned and shared; a captured
    probe_allocate launch of the partitioned BFS tenant (tenant 1, ways
    [4, 6)) and an owner-matched cache_probe, each against its plain
    version; then the benchmark's own sizes under a fault model on the
    card and on the CPU, bit-identical after every op and drain."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from repro_torch.core.ssd import FaultModel
    from repro_torch.interop import runtime_state_to_numpy

    t_phase = time.perf_counter()
    cfg = RT_DEPLOY
    data = runtime_data(cfg, seed)
    log(f"runtime: KV table of {cfg['n_keys']} keys x {cfg['value']} floats "
        f"placed at capacity {data['capacity']} in "
        f"{data['build_table_s']:.3f} s (host loop); graph of {cfg['nodes']} "
        f"vertices, {len(data['dst'])} edges in {data['graph_s']:.3f} s; "
        f"scan column {cfg['scan_rows']} rows")
    runs, phases = {}, {}
    captured, restore = {}, None
    for name, iso, nb in (("solo", "partitioned", False),
                          ("partitioned", "partitioned", True),
                          ("shared", "shared", True)):
        if name == "partitioned":
            captured, restore = capture_probes(1, cfg["quotas"][0])
        res, phases[f"runtime_{name}"], wall = counted_run(
            counters, lambda: mixed_tenants(cfg, data, dev, iso,
                                            neighbours=nb))
        if restore:
            restore()
            restore = None
        require_launched(f"runtime_{name}", phases[f"runtime_{name}"])
        runs[name] = res
        tn = res["tenants"]
        log(f"runtime {name}: {res['rounds_timed']} timed rounds in "
            f"{res['wall_s']:.6f} s ({res['wall_s'] / res['rounds_timed']:.6f}"
            f" s a round; whole run with checks {wall:.6f} s); "
            + "; ".join(f"{n} hit rate {d['hit_rate']:.6f}, amplification "
                        f"{d['amplification']:.6f}, dropped {d['dropped']:.0f}"
                        for n, d in tn.items())
            + f"; launches {phases[f'runtime_{name}']}")
        gc.collect()
        torch.cuda.empty_cache()
    solo = runs["solo"]["tenants"]["kv"]["hit_rate"]
    part = runs["partitioned"]["tenants"]["kv"]["hit_rate"]
    shared = runs["shared"]["tenants"]["kv"]["hit_rate"]
    if part < 0.8 * solo:
        raise AssertionError(f"partitioned KV hit rate {part} under 0.8 of "
                             f"solo {solo}")
    log(f"runtime: KV hit rate solo {solo:.6f}, partitioned {part:.6f} "
        f"({part / solo:.6f} of solo), shared {shared:.6f} "
        f"({shared / part if part else 0.0:.6f} of partitioned)")
    t0 = time.perf_counter()
    finished = {name: runs[name].pop("finished")
                for name in ("partitioned", "shared")}
    traversals = scipy_depths(data["indptr"], data["dst"],
                              sorted({src for f in finished.values()
                                      for src, _ in f}))
    for name, done in finished.items():
        for source, depth in done:
            if not np.array_equal(depth, traversals[source]):
                raise AssertionError(f"runtime {name}: BFS from {source} "
                                     "differs from scipy")
            runs[name].setdefault("bfs_sources", []).append(source)
    if not all(runs[n].get("bfs_sources") for n in ("partitioned",
                                                    "shared")):
        raise AssertionError("runtime: no BFS traversal finished")
    t_scipy = time.perf_counter() - t0
    log(f"runtime: BFS traversals from sources "
        f"{ {n: runs[n]['bfs_sources'] for n in ('partitioned', 'shared')} }"
        f" equal scipy's ({t_scipy:.3f} s)")
    probes = captured_probe_checks(captured)
    log(f"runtime: captured launches bit-identical to the plain versions: "
        f"{probes}")
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile

        short = dict(cfg, rounds=8, warm=0)
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mixed_tenants(short, data, dev, "partitioned")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        profile_table("runtime_partitioned", prof, wall)
    del data
    gc.collect()
    torch.cuda.empty_cache()

    # card against CPU at the benchmark's own sizes, under faults
    small = runtime_data(RT_SMALL, seed)
    fault = FaultModel(transient_error_rate=0.05, failed_devices=(1,),
                       seed=0)
    cmp = {}
    for iso in ("partitioned", "shared"):
        logs = {}
        for device in (dev, "cpu"):
            trace = logs[str(device)] = []

            def on_op(label, rst, out, trace=trace):
                if label == "drain":
                    out = [getattr(out, f.name)
                           for f in dataclasses.fields(out)]
                trace.append((label, [t.cpu().clone() for t in out],
                              runtime_state_to_numpy(rst)))

            if torch.device(device).type == "cuda":
                res, phases[f"runtime_vs_cpu_{iso}"], _ = counted_run(
                    counters, lambda: mixed_tenants(
                        RT_SMALL, small, device, iso, fault=fault,
                        on_op=on_op))
                require_launched(f"runtime_vs_cpu_{iso}",
                                 phases[f"runtime_vs_cpu_{iso}"])
            else:
                res = mixed_tenants(RT_SMALL, small, device, iso,
                                    fault=fault, on_op=on_op)
        g, c = logs[str(dev)], logs["cpu"]
        if len(g) != len(c):
            raise AssertionError("runtime card/CPU: op counts differ")
        for i, ((lg, og, sg), (lc, oc, sc)) in enumerate(zip(g, c)):
            for j, (a, b) in enumerate(zip(og, oc)):
                if lg == "scan":    # float32 sums in the card's order
                    same = np.isclose(float(a), float(b), rtol=1e-5, atol=0)
                else:
                    same = a.dtype == b.dtype \
                        and torch.equal(_bits(a), _bits(b))
                if not same:
                    raise AssertionError(f"runtime card/CPU {iso}: op {i} "
                                         f"({lg}) output {j} differs")
            for k in sc:
                if not np.array_equal(sg[k], sc[k]):
                    raise AssertionError(f"runtime card/CPU {iso}: op {i} "
                                         f"({lg}) {k} differs")
        m = res["summary"]
        if not (m["transient_errors"] > 0 and m["dev_reads"][1] == 0):
            raise AssertionError(f"runtime card/CPU: fault counters {m}")
        cmp[iso] = dict(ops=len(g), drains=sum(x[0] == "drain" for x in g),
                        transient_errors=m["transient_errors"],
                        failed_commands=m["failed_commands"],
                        degraded_reads=m["degraded_reads"])
    log(f"runtime card/CPU at the benchmark's sizes under faults: every "
        f"op's outputs and RuntimeState, and every drain's Completions, "
        f"bit-identical: {cmp}")
    total = time.perf_counter() - t_phase
    log(f"runtime phase: {total:.3f} s")
    return dict(config=cfg, runs=runs, kv_hit=dict(
        solo=solo, partitioned=part, shared=shared,
        retained_partitioned=part / solo if solo else 0.0),
        scipy_s=t_scipy, captured=probes, card_vs_cpu=cmp,
        phase_launches=phases, total_s=total)


# --------------------------------------------------------------- phase 9 --
def weight_bytes_per_step(model, cfg, B) -> int:
    """Weight bytes one decode step reads: every parameter, except that an
    untied embedding table gives only the B rows it looks up (hymba and
    xLSTM read their untied head whole) and hymba's meta tokens are read
    only while priming.  A MoE step reads every expert (each holds C >= 8
    slots a sequence, filled or not)."""
    def nbytes(t):
        return t.numel() * t.element_size()

    total = sum(nbytes(p) for p in model.parameters())
    if not cfg.tie_embeddings:
        t = model.embed.table
        total -= (t.shape[0] - B) * t.shape[1] * t.element_size()
    if getattr(model, "meta", None) is not None:
        total -= nbytes(model.meta)
    return total


def layer_kinds(cache) -> list:
    """Each layer's kind of a decode cache: ``paged``, ``ring``, ``mlstm``
    or ``slstm`` (a hymba layer is ``(Tagged, ssm state)``)."""
    return [(t[0] if isinstance(t, tuple) else t).kind
            for t in cache["layers"]]


def cache_bytes(cache) -> int:
    """Bytes of every tensor of a decode cache (pools, rings, SSM and
    xLSTM states, page tables, lengths)."""
    from repro_torch.serving.engine import _leaves

    return sum(t.numel() * t.element_size() for t in _leaves(cache))


# The served deployments: (arch, prompt length range, new tokens, keep_last,
# max_seq, engine steps traced with --profile, all eight slots busy in
# each window).  Eight slots each.  hymba's paged pools hold max_seq + its
# 128 meta tokens (640 positions); xlstm-1.3b has no KV cache to page.
SERVE = {
    "qwen2.5-14b": ((600, 1000), 32, 512, 1280, (900, 933)),
    "gemma3-12b": ((1030, 1150), 16, 512, 1280, (1000, 1033)),
    "olmoe-1b-7b": ((200, 400), 32, 128, 512, (150, 183)),
    "hymba-1.5b": ((200, 400), 32, 128, 512, (150, 183)),
    "xlstm-1.3b": ((200, 400), 32, 128, 512, (150, 183)),
}
# Depth cuts of the served deployments, for the script's time (the
# training and mesh phases came after them), widths unchanged:
# qwen2.5-14b serves 12 of its 48 layers, every one paged; gemma3-12b 12 of
# its 48, 10 rings and 2 paged layers, its prompts still past the
# 1024-token window (24 layers before the mesh_tp cells, 16 before the
# mesh_fsdp cell).
SERVE_DEPTH = {"qwen2.5-14b": 12, "gemma3-12b": 12}


def serving_phase(dev, seed, counters, arch="qwen2.5-14b", profile=False,
                  keep=False):
    """One deployment of SERVE at full width and depth, bf16, through the
    engine; returns the result (and the API and model with ``keep``).  The
    launch counts run from before the engine is built, so hymba's priming
    (its meta tokens through the decode path) counts toward them."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model, count_params
    from repro_torch.serving import PagedKVManager, Request, ServeEngine

    cfg = get_config(arch)
    if arch in SERVE_DEPTH:
        cfg = cfg.replace(n_layers=SERVE_DEPTH[arch])
    (lo, hi), new_tokens, keep_last, max_seq, prof_window = SERVE[arch]
    tag = f"serving {cfg.name}"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    api = build_model(cfg, dev)
    model = api.init(seed)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = count_params(model)
    log(f"{tag}: {n_params} parameters ({cfg.dtype}), random init on the "
        f"card in {t_init:.3f} s")

    B = 8
    kv = PagedKVManager(keep_last=keep_last)
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
    for c in counters.values():
        c.n = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, model, batch_slots=B, max_seq=max_seq,
                      kv_manager=kv, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_prime = cfg.n_meta_tokens if eng.api.prime is not None else 0
    kinds = layer_kinds(eng.cache)
    n_paged = kinds.count("paged")
    kv_cache_bytes = cache_bytes(eng.cache)
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(
        2, cfg.vocab, int(rng.integers(lo, hi + 1))).tolist(),
        max_new_tokens=new_tokens) for i in range(B)]
    for r in reqs:
        eng.submit(r)
    prof_res = None
    # (host seconds, engine steps) before, in and after the traced window
    spans = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.queue or any(sl.req is not None for sl in eng.slots):
        if profile and eng.n_steps == prof_window[0]:
            from torch.profiler import ProfilerActivity, profile as tprof
            torch.cuda.synchronize()
            spans["before"] = (time.perf_counter() - t0, eng.n_steps)
            with tprof(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
                tp = time.perf_counter()
                while eng.n_steps < prof_window[1] and (
                        eng.queue or any(sl.req for sl in eng.slots)):
                    eng.step()
                torch.cuda.synchronize()
                twall = time.perf_counter() - tp
            spans["in"] = (twall, eng.n_steps - prof_window[0])
            t_after, n_after = time.perf_counter(), eng.n_steps
            prof_res = profile_table(
                "serve" if arch == "qwen2.5-14b" else
                "serve_" + arch.split("-")[0], prof, twall)
            continue
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if spans:
        spans["after"] = (time.perf_counter() - t_after,
                          eng.n_steps - n_after)
    launches = {k: c.n for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    if not all(r.done and len(r.out) == new_tokens for r in reqs):
        raise AssertionError(f"{tag}: not every request completed")
    m = kv.metrics.summary()
    if n_paged and not (m["write_ops"] > 0 and m["misses"] > 0):
        raise AssertionError(f"{tag}: no pages spilled ({m['write_ops']}) "
                             f"or fetched ({m['misses']})")
    if not n_paged and (m["write_ops"] or m["misses"]):
        raise AssertionError(f"{tag}: no paged layer, yet pages spilled "
                             f"({m['write_ops']}) or fetched ({m['misses']})")
    if m["write_ops"] != m["misses"]:
        raise AssertionError(f"{tag}: {m['write_ops']} pages spilled, "
                             f"{m['misses']} fetched")
    want = n_paged * (eng.n_steps + n_prime)
    if launches["paged_attention"] != want:
        raise AssertionError(f"{tag}: paged_attention launched "
                             f"{launches['paged_attention']} times, want "
                             f"{want} ({n_paged} x ({eng.n_steps} steps + "
                             f"{n_prime} priming steps))")
    gen_tokens = sum(len(r.out) for r in reqs)
    all_tokens = sum(len(r.prompt) + len(r.out) for r in reqs)
    wbytes = weight_bytes_per_step(model, cfg, B)
    res = dict(
        arch=cfg.name, params=n_params, init_s=t_init, slots=B,
        max_seq=max_seq, keep_last=keep_last,
        layer_kinds={k: kinds.count(k) for k in sorted(set(kinds))},
        paged_layers=n_paged, priming_steps=n_prime,
        engine_build_s=t_build, cache_bytes=kv_cache_bytes,
        prompt_lens=[len(r.prompt) for r in reqs],
        new_tokens=new_tokens, wall_s=wall, engine_steps=eng.n_steps,
        ms_per_step=wall / eng.n_steps * 1e3,
        weight_bytes_per_step=wbytes,
        weight_bound_ms_per_step=bound_ms(wbytes),
        generated_tokens=gen_tokens, generated_tokens_per_s=gen_tokens / wall,
        tokens_through_decode=all_tokens,
        decode_tokens_per_s=all_tokens / wall,
        pages_spilled=m["write_ops"], pages_fetched=m["misses"],
        bytes_to_storage=m["bytes_to_storage"],
        bytes_from_storage=m["bytes_from_storage"],
        sim_time_s=m["sim_time_s"], page_bytes=kv.page_bytes,
        kv_manager_host_s=kv_s,
        ms_per_step_by_span={k: t / n * 1e3 if n else None
                             for k, (t, n) in spans.items()},
        peak_device_bytes=peak, launches=launches, profiled=profile,
        profile=prof_res)
    log(f"{tag}: layers {res['layer_kinds']}; decode cache {kv_cache_bytes} "
        f"bytes; engine built in {t_build:.6f} s ({n_prime} priming "
        f"steps); wall {wall:.6f} s"
        f"{' (with a profiled window)' if profile else ''}, "
        f"{eng.n_steps} engine steps, {res['ms_per_step']:.6f} ms per step "
        f"(weights read a step {wbytes} bytes, "
        f"{res['weight_bound_ms_per_step']:.6f} ms at the HBM rate), "
        f"{gen_tokens} generated tokens ({res['generated_tokens_per_s']:.6f}"
        f" tokens/s; {res['decode_tokens_per_s']:.6f} tokens/s through "
        f"decode, prompts included)")
    log(f"{tag}: pages spilled {m['write_ops']:.0f} "
        f"({m['bytes_to_storage']:.0f} bytes), fetched {m['misses']:.0f} ({m['bytes_from_storage']:.0f} "
        f"bytes); simulated device time {m['sim_time_s']:.6f} s"
        + ("" if kv_s is None else f"; host time in maybe_spill "
           f"{kv_s['maybe_spill']:.6f} s, in ensure_resident "
           f"{kv_s['ensure_resident']:.6f} s; ms a step before, in and "
           f"after the traced window {res['ms_per_step_by_span']}"))
    log(f"{tag}: peak device memory {peak} bytes ({peak / 2 ** 30:.3f} "
        f"GiB); launches {launches}")
    del eng
    if keep:
        return api, model, res
    del api, model
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return res


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


# Limits of phase 10 (last-token logits of 256 decode steps against forward,
# full width, 4 layers) as (atol, rtol).  float32 (TF32 off): the two paths
# sum in different orders, nothing else.  bfloat16: forward's tensor-core
# flash kernel rounds P to bf16 before P.V, and the two paths round K, V and
# every activation to bf16 at different points, so the logits (of size
# about 5) differ far more: the first chip run of this check gave a max abs
# err of 0.04296875 (NVIDIA H100 80GB HBM3), and the limit is 3.5 times it.
DVF_LIMITS = {"float32": (2e-3, 2e-3), "bfloat16": (0.15, 0.0)}


# The decode-vs-forward deployments: full width, depth cut to ``layers``
# (whisper's encoder too), batch B, S tokens.  gemma3-12b's 6 layers are 5
# local and 1 global, and S 1100 passes the 1024-token window, so decode
# wraps the rings while forward runs the windowed flash kernel.  olmoe's
# S is its per-sequence capacity C = 8: no expert can then take more than
# C choices of a sequence, so forward drops none and computes decode's
# function (at S 16 its forward dropped 15 of 1,024 choices on the card).
# hymba's 4 layers are global at {0, 2, 3} and windowed at 1, and S 1000
# plus its 128 meta tokens passes the 1024-token window: decode (after
# ``prime``) wraps the ring while forward runs the windowed flash kernel.
# xlstm-1.3b's 8 layers are the least depth that holds an sLSTM (layer 7),
# and S 512 is two mLSTM chunks of 256, so forward carries the state from
# one chunk to the next.
DVF = {
    "qwen2.5-14b": (4, 2, 256),
    "gemma3-12b": (6, 2, 1100),
    "olmoe-1b-7b": (4, 2, 8),
    "whisper-large-v3": (4, 2, 64),
    "llava-next-mistral-7b": (4, 2, 256),
    "hymba-1.5b": (4, 2, 1000),
    "xlstm-1.3b": (8, 2, 512),
}
LLAVA_TEXT = 64            # text tokens after llava's 2880 patches


def decode_vs_forward_phase(dev, seed, counters, arch="qwen2.5-14b",
                            dtype="float32", profile=False):
    """Full width, depth cut: S decode steps (paged kernel, rings, the
    cross-attention over ``xkv`` that ``prefill`` fills; hymba's after
    ``prime``, its Mamba path one step at a time; xLSTM's recurrent steps)
    against forward (flash kernel: SIMT in float32, tensor cores in
    bfloat16; hymba's chunked SSM scan; xLSTM's chunkwise mLSTM and its
    sLSTM loop), last-token logits within DVF_LIMITS.  MoE: forward must
    drop no (token, expert) choice, or the two compute different
    functions.  llava: one more forward with its 2880 patch embeddings
    before 64 text tokens.  With ``profile``, one more forward runs under
    torch.profiler (``chiprun_out/profile_forward_<family>.txt``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers, B, S = DVF[arch]
    cfg = get_config(arch).replace(n_layers=layers, dtype=dtype)
    if cfg.enc_dec:
        cfg = cfg.replace(n_enc_layers=layers)
    tag = f"decode vs forward ({cfg.name}, {layers} layers, {dtype})"
    torch.cuda.reset_peak_memory_stats()
    api = build_model(cfg, dev)
    model = api.init(seed + 3, max_seq=S)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev,
                         dtype=torch.int32)
    batch = {"tokens": toks}
    if cfg.enc_dec:
        batch["enc_frames"] = torch.randn(
            (B, cfg.enc_seq, cfg.d_model), generator=gen, device=dev).to(
                cfg.compute_dtype)
    for c in counters.values():
        c.n = 0
    t0 = time.perf_counter()
    fwd, aux = api.forward(model, batch)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    fwd_launches = {k: c.n for k, c in counters.items()}
    fwd_prof = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprof
        with tprof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            tp = time.perf_counter()
            api.forward(model, batch)
            torch.cuda.synchronize()
            twall = time.perf_counter() - tp
        fwd_prof = profile_table("forward_" + arch.split("-")[0], prof,
                                 twall)
    want_kind = "flash_attention.tc" if dtype == "bfloat16" \
        else "flash_attention.simt"
    # decoder self-attention; with enc-dec also the encoder's and the
    # cross-attention of every decoder layer; none in xLSTM
    n_flash = 0 if cfg.family == "ssm" else cfg.n_layers + (
        cfg.n_enc_layers + cfg.n_layers if cfg.enc_dec else 0)
    if fwd_launches[want_kind] != n_flash:
        raise AssertionError(f"{tag}: forward launched {fwd_launches}, want "
                             f"{n_flash} of {want_kind}")
    dropped = float(aux["dropped"]) if cfg.moe else None
    if cfg.moe and dropped != 0:
        raise AssertionError(f"{tag}: forward dropped {dropped} (token, "
                             f"expert) choices past capacity")
    kinds = layer_kinds(api.init_decode_cache(1, S))
    n_prime = cfg.n_meta_tokens if api.prime is not None else 0
    for c in counters.values():
        c.n = 0
    t0 = time.perf_counter()
    if cfg.enc_dec:
        lg, cache = transformer.prefill(cfg, model, batch, S)
    else:
        cache = api.init_decode_cache(B, S)
        if api.prime is not None:
            cache = api.prime(model, cache)
        for t in range(S):
            lg, cache = api.decode_step(model, cache, toks[:, t])
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    dec_launches = {k: c.n for k, c in counters.items()}
    want_paged = kinds.count("paged") * (S + n_prime)
    if dec_launches["paged_attention"] != want_paged:
        raise AssertionError(f"{tag}: decode launched {dec_launches}, want "
                             f"{kinds.count('paged')} x ({S} + {n_prime}) "
                             f"paged")
    a, b = lg.double(), fwd[:, -1].double()
    err = float((a - b).abs().max())
    atol, rtol = DVF_LIMITS[dtype]
    lim = dict(atol=atol, rtol=rtol)
    # the largest |a - b| / (atol + rtol |b|): at most 1 within the limit
    ratio = float(((a - b).abs() / (atol + rtol * b.abs())).max())
    if not bool(torch.isfinite(a).all()) or not ratio <= 1:
        raise AssertionError(f"{tag}: max abs err {err} outside {lim} "
                             f"({ratio} of it)")
    del cache, fwd
    res = dict(arch=cfg.name, max_abs_err=err, limit=lim,
               limit_ratio=ratio, forward_s=t_fwd,
               decode_s=t_dec, forward_launches=fwd_launches,
               decode_launches=dec_launches,
               layer_kinds={k: kinds.count(k) for k in sorted(set(kinds))},
               layers=cfg.n_layers, B=B, S=S, dtype=dtype,
               priming_steps=n_prime, forward_flash_layers=n_flash,
               forward_profile=fwd_prof,
               logits_max_abs=float(b.abs().max()), moe_dropped=dropped)
    log(f"{tag}, B {B}, S {S}, layers {res['layer_kinds']}: max abs err "
        f"{err} ({ratio} of the limit {lim}, logits max abs "
        f"{float(b.abs().max())}); "
        f"forward {t_fwd:.6f} s, {S} decode steps"
        + (f" after {n_prime} priming steps" if n_prime else "")
        + f" {t_dec:.6f} s; forward "
        f"launches {fwd_launches}; decode launches {dec_launches}"
        + ("" if dropped is None else f"; forward dropped {dropped}"))
    if cfg.family == "vlm":
        pe = torch.randn((B, cfg.n_patches, cfg.d_model), generator=gen,
                         device=dev).to(cfg.compute_dtype)
        for c in counters.values():
            c.n = 0
        t0 = time.perf_counter()
        out, _ = api.forward(model, {"tokens": toks[:, :LLAVA_TEXT],
                                     "patch_embeds": pe})
        torch.cuda.synchronize()
        t_pf = time.perf_counter() - t0
        pf_launches = {k: c.n for k, c in counters.items()}
        want_shape = (B, cfg.n_patches + LLAVA_TEXT, cfg.vocab)
        if tuple(out.shape) != want_shape or not bool(
                torch.isfinite(out).all()):
            raise AssertionError(f"{tag}: patch forward gave "
                                 f"{tuple(out.shape)} (want {want_shape}) "
                                 f"or non-finite logits")
        if pf_launches[want_kind] != cfg.n_layers:
            raise AssertionError(f"{tag}: patch forward launched "
                                 f"{pf_launches}, want {cfg.n_layers} of "
                                 f"{want_kind}")
        res.update(patch_forward_s=t_pf, patch_forward_launches=pf_launches,
                   patch_forward_shape=list(want_shape))
        log(f"{tag}: forward over {cfg.n_patches} patches + {LLAVA_TEXT} "
            f"tokens in {t_pf:.6f} s, logits {want_shape} finite; launches "
            f"{pf_launches}")
        del out, pe
    peak = torch.cuda.max_memory_allocated()
    res["peak_device_bytes"] = peak
    log(f"{tag}: peak device memory {peak} bytes")
    del model
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return res


def model_phases(dev, seed, attn, profile=False) -> dict:
    """Phases 9-13: qwen2.5-14b serving and its spill/fetch round trip;
    qwen's decode vs forward in float32 and bfloat16; gemma3-12b,
    olmoe-1b-7b, hymba-1.5b and xlstm-1.3b serving, each model freed
    before the next; decode vs forward of gemma3-12b, olmoe-1b-7b,
    whisper-large-v3, llava-next-mistral-7b, hymba-1.5b and xlstm-1.3b in
    float32."""
    import torch

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    api, model, serve = serving_phase(dev, seed, attn, profile=profile,
                                      keep=True)
    out = {"serving": serve, "roundtrip": roundtrip_phase(api, model, seed)}
    del api, model
    free()
    out["decode_vs_forward"] = decode_vs_forward_phase(dev, seed, attn)
    out["decode_vs_forward_bf16"] = decode_vs_forward_phase(
        dev, seed, attn, dtype="bfloat16")
    for arch in ("gemma3-12b", "olmoe-1b-7b", "hymba-1.5b", "xlstm-1.3b"):
        out[f"serving_{arch}"] = serving_phase(dev, seed, attn, arch,
                                               profile=profile)
        free()
    for arch in ("gemma3-12b", "olmoe-1b-7b", "whisper-large-v3",
                 "llava-next-mistral-7b", "hymba-1.5b", "xlstm-1.3b"):
        out[f"decode_vs_forward_{arch}"] = decode_vs_forward_phase(
            dev, seed, attn, arch,
            profile=profile and arch in ("hymba-1.5b", "xlstm-1.3b"))
        free()
    return out


# ------------------------------------------------------------ training --
# train_vs_cpu: each parameter's gradient on the card (kernels) against the
# same model's on the CPU (plain versions), as ||g_card - g_cpu|| /
# ||g_cpu||: both f32 with TF32 off, summed in other orders over at most
# 262,144 terms (the tied embedding's logits), about sqrt(2^18) f32
# roundings, 3e-5; the loss within 1e-5 relative.
TRAIN_VS_CPU_GRAD = 1e-4
TRAIN_VS_CPU_LOSS = 1e-5
TRAIN_STEPS = 8
TRAIN_FAIL_AT = 4


def train_counters():
    from repro_torch.kernels import flash_attention

    return {"flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention.bwd_launches,
            "flash_attention_bwd.simt":
                flash_attention.bwd_variant_launches["simt"]}


def train_vs_cpu_phase(dev, seed):
    """``train_vs_cpu``: gemma3-1b at full width cut to 6 layers (5
    windowed, 1 global), B 1, S 576 (past the 512 window), f32, seed-0
    weights: the loss and every parameter's gradient on the card against
    the same model on the CPU."""
    import numpy as np
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("gemma3-1b").replace(n_layers=6, dtype="float32")
    S = 576
    windows = [w for w in cfg.layer_windows(S) if w < S]
    if len(windows) != 5:
        raise AssertionError(f"train_vs_cpu: {len(windows)} window layers")
    model = build_model(cfg, dev).init(seed).requires_grad_(True)
    cpu_model = interop.params_from_numpy(
        cfg, interop.params_to_numpy(model), "cpu").requires_grad_(True)
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab, (1, S)).astype(np.int32)

    def grads(m, device):
        api = build_model(cfg, device)
        loss, _ = api.loss(m, {"tokens": torch.from_numpy(tokens).to(
            device)})
        names, params = zip(*m.named_parameters())
        return loss.detach(), dict(zip(names, torch.autograd.grad(loss,
                                                                  params)))

    (loss, g), launches, wall = counted_run(train_counters(),
                                            lambda: grads(model, dev))
    # forward + remat, backward (all on the f32 variant)
    want = 2 * cfg.n_layers, cfg.n_layers, cfg.n_layers
    if (launches["flash_attention"], launches["flash_attention_bwd"],
            launches["flash_attention_bwd.simt"]) != want:
        raise AssertionError(f"train_vs_cpu: launches {launches}, want "
                             f"{want}")
    t0 = time.perf_counter()
    loss_c, g_c = grads(cpu_model, "cpu")
    cpu_s = time.perf_counter() - t0
    loss_err = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
    errs = {n: float((g[n].cpu().double() - g_c[n].double()).norm()
                     / g_c[n].double().norm().clamp(min=1e-30))
            for n in g_c}
    worst = max(errs, key=errs.get)
    log(f"train_vs_cpu: loss {float(loss)} (CPU {float(loss_c)}, rel err "
        f"{loss_err}); largest relative-norm gradient error {errs[worst]} "
        f"({worst}); card {wall:.3f} s, CPU {cpu_s:.3f} s; launches "
        f"{launches}")
    if not loss_err <= TRAIN_VS_CPU_LOSS or not max(errs.values()) \
            <= TRAIN_VS_CPU_GRAD:
        over = {n: e for n, e in errs.items() if e > TRAIN_VS_CPU_GRAD}
        raise AssertionError(f"train_vs_cpu: loss err {loss_err}, gradient "
                             f"errors over {TRAIN_VS_CPU_GRAD}: {over}")
    del model, cpu_model, g, g_c
    return dict(loss=float(loss), loss_cpu=float(loss_c),
                loss_rel_err=loss_err,
                grad_rel_norm_errs=errs, max_grad_rel_norm_err=errs[worst],
                card_s=wall, cpu_s=cpu_s, launches=launches,
                shape="gemma3-1b full width, 6 layers (5 window, 1 global), "
                      "B 1, S 576, f32")


def train_phase(dev, seed, profile=False):
    """``train:gemma3-1b``: gemma3-1b at full width and depth (26 layers,
    f32, remat "full") through ``launch/train``'s ``run``: a Loader over a
    1M-token synthetic corpus, B 4, S 1024, 8 AdamW steps through
    ``run_training`` with one failure injected before step 4 and no
    checkpoint directory (a fresh restart: 12 steps run).  Checks finite
    losses, grad_norm > 0, changed parameters, one restart and the flash
    launches (2 x 26 forwards and 26 backwards a step run, every backward
    on the f32 ``"simt"`` variant)."""
    import math
    import shutil

    import torch
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.roofline import (PEAK_FLOPS_F32,
                                             model_flops_for_cell)
    from repro_torch.models.model import build_model, model_flops_per_token
    from repro_torch.training.fault_tolerance import FailureInjector

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S = 4, 1024
    work = ROOT / "build" / "chip_train"
    shutil.rmtree(work, ignore_errors=True)     # the corpus is made anew
    args = launch_train.parser().parse_args([
        "--arch", "gemma3-1b", "--seq", str(S), "--batch", str(B),
        "--steps", str(TRAIN_STEPS), "--workdir", str(work)])
    cfg = get_config(args.arch).replace(dtype="float32")
    step_times = []     # the host clock once a step's metrics are read back
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = counted_run(
        train_counters(), lambda: launch_train.run(
            args, ckpt_dir=None,
            failure_injector=FailureInjector(fail_at=(TRAIN_FAIL_AT,)),
            on_metrics=lambda s, m: step_times.append(time.perf_counter())))
    peak = torch.cuda.max_memory_allocated()
    hist = res.metrics_history
    steps_run = TRAIN_FAIL_AT + TRAIN_STEPS
    if res.restarts != 1 or res.step != TRAIN_STEPS \
            or len(hist) != steps_run:
        raise AssertionError(f"train: restarts {res.restarts}, step "
                             f"{res.step}, {len(hist)} steps run")
    if not all(math.isfinite(m["loss"]) and m["grad_norm"] > 0
               for m in hist):
        raise AssertionError(f"train: losses or grad norms {hist}")
    want = {"flash_attention": 2 * cfg.n_layers * steps_run,
            "flash_attention_bwd": cfg.n_layers * steps_run,
            "flash_attention_bwd.simt": cfg.n_layers * steps_run}
    if launches != want:
        raise AssertionError(f"train: launches {launches}, want {want}")
    model = res.state["params"]
    api = build_model(cfg, dev)
    fresh = api.init(0, S)
    changed = sum(not torch.equal(p, q) for p, q in zip(
        model.parameters(), fresh.parameters()))
    n_params = sum(p.numel() for p in model.parameters())
    if changed != len(list(model.parameters())):
        raise AssertionError(f"train: {changed} parameters changed")
    del fresh
    t = step_times[-TRAIN_STEPS:]
    step_s = statistics.median(b - a for a, b in zip(t, t[1:]))
    n_act, attn = model_flops_per_token(cfg, S)
    flops_tok = 6 * n_act + 3 * attn
    mfu = flops_tok * B * S / step_s
    # the dry run's yardstick: MODEL_FLOPS of this cell over the measured
    # step, against the f32 peak
    model_flops = model_flops_for_cell(cfg, ShapeCell("train", S, B,
                                                      "train"))
    rf = dict(model_flops=model_flops, step_s=step_s,
              model_flops_per_s=model_flops / step_s,
              peak_flops=PEAK_FLOPS_F32,
              roofline_fraction=model_flops / step_s / PEAK_FLOPS_F32)
    r = dict(arch=cfg.name, params=n_params, B=B, S=S, steps=TRAIN_STEPS,
             steps_run=steps_run, restarts=res.restarts, wall_s=wall,
             losses=[m["loss"] for m in hist],
             grad_norms=[m["grad_norm"] for m in hist],
             ms_per_step=step_s * 1e3, tokens_per_s=B * S / step_s,
             peak_bytes=peak, model_flops_per_token=flops_tok,
             model_flops_per_s=mfu, share_of_f32_peak=mfu / PEAK_F32_FLOPS,
             roofline=rf, launches=launches, parameters_changed=changed)
    if profile:
        r["profile"] = train_profile(args, cfg, api, res.state)
    log(f"train:{cfg.name}: {n_params} parameters, {steps_run} steps run "
        f"(restart at {TRAIN_FAIL_AT}), losses {r['losses']}; "
        f"{r['ms_per_step']:.3f} ms a step (median of steps 2-8), "
        f"{r['tokens_per_s']:.1f} tokens/s, peak {peak} bytes, model "
        f"{mfu:.4e} FLOP/s ({r['share_of_f32_peak']:.4f} of 67 TFLOP/s f32); "
        f"roofline: MODEL_FLOPS {model_flops:.6e} a step (model_flops_for_"
        f"cell), {rf['model_flops_per_s']:.4e} FLOP/s, roofline_fraction "
        f"{rf['roofline_fraction']:.4f}; launches {launches}; on "
        f"{nvidia_smi()}")
    del res, model, api
    return r


def train_profile(args, cfg, api, state) -> dict:
    """One more train step under torch.profiler (the launcher's step and
    batch, made as ``launch/train`` makes them): device time by kernel,
    and the flash backward kernels' share of the step's device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprof
    from repro_torch.data import DataConfig, Loader, TokenStore
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step

    step = make_train_step(cfg, api, adamw=opt.AdamWConfig(
        lr=args.lr, warmup=10, total_steps=args.steps))
    corpus = pathlib.Path(args.workdir) / "corpus.bin"
    loader = Loader(TokenStore.open(corpus),
                    DataConfig(seq_len=args.seq, global_batch=args.batch))
    batch = {"tokens": torch.from_numpy(
        loader.batch_for_step(0)["tokens"]).to(api.device)}
    with tprof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof_res = profile_table("train_gemma3", prof, wall)
    kernels = {e.key: getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages()
               if e.device_type != torch.autograd.DeviceType.CPU}
    total = max(sum(kernels.values()), 1e-9)
    shares = {part: sum(v for k, v in kernels.items() if key in k) / total
              for part, key in (("flash_bwd", "fa_bwd"),
                                ("flash_fwd", "flash_fwd"))}
    log(f"train profile: flash backward {shares['flash_bwd']:.6f} and "
        f"forward {shares['flash_fwd']:.6f} of the step's device time")
    return dict(prof_res, **{f"{k}_share": v for k, v in shares.items()})


def train_ckpt_phase(dev, seed):
    """``train_ckpt``: the restart drill on the card at gemma3-1b's smoke
    config (head dim 16, as the kernels take a multiple of 8), f32: 8
    steps saving every 2 with a failure injected before step 5 restore
    step 4 from ``LATEST`` and replay; the final parameters and moments
    must be bit-identical to an uninterrupted run's."""
    import shutil

    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.data import DataConfig, Loader, TokenStore, synth_corpus
    from repro_torch.models.model import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.fault_tolerance import (FailureInjector,
                                                      run_training)
    from repro_torch.training.train_loop import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_config("gemma3-1b").replace(head_dim=16, dtype="float32")
    api = build_model(cfg, dev)
    acfg = opt.AdamWConfig(lr=1e-2, warmup=2, total_steps=TRAIN_STEPS)
    step = make_train_step(cfg, api, adamw=acfg)
    work = ROOT / "build" / "chip_train_ckpt"
    shutil.rmtree(work, ignore_errors=True)
    loader = Loader(TokenStore.open(synth_corpus(
        work / "corpus.bin", n_tokens=20_000, vocab=cfg.vocab, seed=seed)),
        DataConfig(seq_len=32, global_batch=4))

    def init():
        model = api.init(seed, 32)
        return {"params": model, "opt": opt.adamw_init(model, acfg)}

    def batch_for_step(s):
        return {"tokens": torch.from_numpy(
            loader.batch_for_step(s)["tokens"]).to(dev)}

    plain, launches, _ = counted_run(train_counters(), lambda: run_training(
        step, init, batch_for_step, TRAIN_STEPS))
    require_launched("train_ckpt", launches)
    drill = run_training(step, init, batch_for_step, TRAIN_STEPS,
                         ckpt_dir=work / "ckpt", ckpt_every=2,
                         failure_injector=FailureInjector(fail_at=(5,)))
    if drill.restarts != 1 or len(drill.metrics_history) != TRAIN_STEPS + 1:
        raise AssertionError(f"train_ckpt: {drill.restarts} restarts, "
                             f"{len(drill.metrics_history)} steps run")
    pa, pb = plain.state, drill.state
    same = all(torch.equal(a, b) for a, b in zip(
        pa["params"].parameters(), pb["params"].parameters()))
    same &= all(torch.equal(pa["opt"][k][n], pb["opt"][k][n])
                for k in ("mu", "nu") for n in pa["opt"][k])
    same &= int(pa["opt"]["step"]) == int(pb["opt"]["step"])
    if not same:
        raise AssertionError("train_ckpt: the restored run differs from the "
                             "uninterrupted one")
    log(f"train_ckpt: restored from step 4 after a failure at step 5, final "
        f"parameters and moments bit-identical to the uninterrupted run; "
        f"launches {launches}")
    shutil.rmtree(work, ignore_errors=True)
    return dict(restarts=drill.restarts, bit_identical=True,
                losses=[m["loss"] for m in plain.metrics_history],
                launches=launches)


def train_phases(dev, seed, profile=False) -> dict:
    """The training slice: train_vs_cpu, train:gemma3-1b and train_ckpt,
    each freed before the next."""
    import torch

    out = {}
    for name, fn in (("train_vs_cpu", lambda: train_vs_cpu_phase(dev, seed)),
                     ("train:gemma3-1b", lambda: train_phase(dev, seed,
                                                             profile)),
                     ("train_ckpt", lambda: train_ckpt_phase(dev, seed))):
        t0 = time.perf_counter()
        out[name] = fn()
        out[name]["phase_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- the mesh --
MESH_TRAIN_STEPS = 3
FLASH_DECODE_SHARDS = (1, 2, 4, 8)


def start_world1():
    """A process group of one rank over NCCL, met through a FileStore under
    ``build/`` (no network), for the mesh phases; ``stop_world1`` ends
    it."""
    import torch
    import torch.distributed as dist

    path = ROOT / "build" / "chip_nccl_store"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(path), 1),
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))


def warm_groups(mesh) -> float:
    """One all-reduce on each axis's group of ``mesh``, so that NCCL makes
    its communicators before a timed run; returns the seconds it took."""
    import torch
    import torch.distributed as dist

    t0 = time.perf_counter()
    for axis in mesh.mesh_dim_names:
        dist.all_reduce(torch.zeros(1, device="cuda"),
                        group=mesh.get_group(axis))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def stop_world1():
    import torch.distributed as dist

    dist.destroy_process_group()
    (ROOT / "build" / "chip_nccl_store").unlink(missing_ok=True)


def mesh_train_phase(dev, seed):
    """``mesh_train:gemma3-1b``: gemma3-1b at full width cut to 6 layers (5
    window, 1 global), B 4, S 1024, f32 with TF32 off.  MESH_TRAIN_STEPS
    steps of ``make_train_step(mesh=...)`` on a (1, 1) data/model mesh of
    the world-1 NCCL group (the state sharded by ``state_shardings``),
    then as many plain steps from the same seed and batches: losses,
    metrics and every parameter bit-identical.  Then one pod-compressed
    step on a (1, 1, 1) pod/data/model mesh: its loss the plain one's and
    its residual ``ef`` exactly ``gf - q * scale`` of the plain gradient.
    ms a step of both steps (median, host clock after each step's loss
    reaches the host)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.interop import param_axes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import (make_train_step,
                                                 shard_state,
                                                 state_shardings)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S = 4, 1024
    cfg = get_config("gemma3-1b").replace(n_layers=6, dtype="float32")
    if sum(w < S for w in cfg.layer_windows(S)) != 5:
        raise AssertionError("mesh_train: not 5 window layers")
    api = build_model(cfg, dev)
    acfg = opt.AdamWConfig(lr=3e-3, warmup=10, total_steps=MESH_TRAIN_STEPS)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    batches = [{"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                        device=dev, dtype=torch.int32)}
               for _ in range(MESH_TRAIN_STEPS)]

    def fresh():
        model = api.init(seed, S).requires_grad_(True)
        return {"params": model, "opt": opt.adamw_init(model, acfg)}

    def run(step, state, n):
        metrics, times = [], []
        for b in batches[:n]:
            t0 = time.perf_counter()
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
            times.append(time.perf_counter() - t0)
        return state, metrics, times

    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    nccl_s = warm_groups(mesh)
    state = fresh()
    state = shard_state(state, state_shardings(
        cfg, param_axes(state["params"]), mesh, state["params"], acfg))
    step = make_train_step(cfg, api, adamw=acfg, mesh=mesh)
    # the steps' peak: what the allocator held at most over the mesh
    # steps, less what was there before them other than the step's own
    # arguments (the sharded state and one batch)
    held = sum(t.to_local().numel() * t.element_size() for t in
               list(state["params"].parameters())
               + list(state["opt"]["mu"].values())
               + list(state["opt"]["nu"].values())) \
        + state["opt"]["step"].numel() * state["opt"]["step"].element_size() \
        + batches[0]["tokens"].numel() * batches[0]["tokens"].element_size()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (state, mesh_m, mesh_t), launches, _ = counted_run(
        train_counters(), lambda: run(step, state, MESH_TRAIN_STEPS))
    peak = torch.cuda.max_memory_allocated()
    require_launched("mesh_train", launches)
    mesh_params = {n: p.to_local() for n, p in
                   state["params"].named_parameters()}
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    plain, plain_m, plain_t = run(make_train_step(cfg, api, adamw=acfg),
                                  fresh(), MESH_TRAIN_STEPS)
    differ = [n for n, p in plain["params"].named_parameters()
              if not torch.equal(p, mesh_params[n])]
    if mesh_m != plain_m or differ:
        raise AssertionError(f"mesh_train: the mesh step differs from the "
                             f"plain step: metrics {mesh_m} against "
                             f"{plain_m}; parameters {differ}")
    del plain, mesh_params
    gc.collect()
    torch.cuda.empty_cache()

    # the pod-compressed step on (1, 1, 1): one pod, so the mean is the
    # quantised gradient and ef its quantisation error
    pcfg = dataclasses.replace(acfg, pod_compression=True)
    mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"), "cuda")
    nccl_s += warm_groups(mesh3)
    ref_model = api.init(seed, S).requires_grad_(True)
    loss, _ = api.loss(ref_model, batches[0])
    names, params = zip(*ref_model.named_parameters())
    gf = dict(zip(names, torch.autograd.grad(loss, params)))
    del ref_model
    st = fresh()
    st["opt"] = opt.adamw_init(st["params"], pcfg)
    st = shard_state(st, state_shardings(cfg, param_axes(st["params"]),
                                         mesh3, st["params"], pcfg))
    t0 = time.perf_counter()
    st, pm = make_train_step(cfg, api, adamw=pcfg, mesh=mesh3)(st, batches[0])
    pod_loss = float(pm["loss"])
    pod_s = time.perf_counter() - t0
    bad = []
    for n, g in gf.items():
        scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127)
        if not torch.equal(st["opt"]["ef"][n].to_local(), g - q * scale):
            bad.append(n)
    if bad or pod_loss != plain_m[0]["loss"]:
        raise AssertionError(f"mesh_train pod step: loss {pod_loss} (plain "
                             f"{plain_m[0]['loss']}); ef != gf - q * scale "
                             f"for {bad}")
    del st, gf
    gc.collect()
    torch.cuda.empty_cache()
    r = dict(arch=cfg.name, layers=cfg.n_layers, B=B, S=S,
             steps=MESH_TRAIN_STEPS, losses=[m["loss"] for m in mesh_m],
             bit_identical=True, mesh_ms_per_step=statistics.median(mesh_t)
             * 1e3, plain_ms_per_step=statistics.median(plain_t) * 1e3,
             mesh_step_s=mesh_t, plain_step_s=plain_t,
             pod_step_s=pod_s, pod_ef_exact=True, launches=launches,
             nccl_setup_s=nccl_s, peak_bytes=peak, allocated_before=before,
             arguments_bytes=held, step_peak_bytes=peak - before + held)
    log(f"mesh_train:{cfg.name} (6 layers, B {B}, S {S}, f32): "
        f"{MESH_TRAIN_STEPS} steps on a (1, 1) mesh bit-identical to the "
        f"plain steps (losses {r['losses']}); "
        f"{r['mesh_ms_per_step']:.3f} ms a mesh step, "
        f"{r['plain_ms_per_step']:.3f} ms a plain step; pod step on "
        f"(1, 1, 1) {pod_s * 1e3:.3f} ms, loss equal, ef = gf - q * scale "
        f"exactly; peak {peak} bytes over the mesh steps ({before} "
        f"allocated before them, {held} of it the state and a batch: the "
        f"steps held {r['step_peak_bytes']} bytes at most); launches "
        f"{launches}; on {nvidia_smi()}")
    return r


def flash_decode_phase(dev, seed, attn, profile=False):
    """``flash_decode_shards``: the paged kernel's log-sum-exp at the
    serving phase's paged shape (qwen2.5-14b: B 8, 40 over 8 heads of 128,
    5 pages of 256, one hole a sequence, the last sequence empty) against
    its plain version, f32 and bf16, the output unchanged by asking for
    it; 1, 2, 4 and 8 shards emulated (each a contiguous range of physical
    pages, the rest of the table -1, combined by ``combine_shards``)
    against the unsharded kernel, within TOL in f32 and bf16 rounding of
    the plain f32 version in bf16; then ``prefill`` of qwen2.5-14b at full
    width, 4 layers (``DVF``), bf16, B 2, S 256 with ``flash_decode_shards``
    under the world-1 mesh, logits bit-identical to the plain decode's and
    every paged launch the lse variant.  With ``profile``, 16 more steps
    of each decode run under torch.profiler
    (``chiprun_out/profile_flash_decode_{plain,mesh}.txt``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (lse_launches,
                                                     paged_attention_cuda)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model

    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    res = {"lse_errs": {}, "shard_errs": {}, "shard_ratios": {}}
    for dtype in ("float32", "bfloat16"):
        q, kp, vp, pt, sl = paged_inputs(8, 40, 8, 128, 256, 5, (600, 1280),
                                         getattr(torch, dtype), gen, dev)
        sl[-1] = 0                                  # a row with no live key
        out, lse = paged_attention_cuda(q, kp, vp, pt, sl, return_lse=True)
        if not torch.equal(out, paged_attention_cuda(q, kp, vp, pt, sl)):
            raise AssertionError(f"flash_decode {dtype}: asking for the lse "
                                 "changed the output")
        want_out, want_lse = ref.paged_attention_lse_ref(q, kp, vp, pt, sl)
        require_close(f"paged lse output {dtype}", out, want_out, dtype)
        empty = torch.isneginf(want_lse)
        if not torch.equal(torch.isneginf(lse), empty) or out[-1].any():
            raise AssertionError(f"flash_decode {dtype}: the empty row's lse "
                                 f"or output is wrong")
        res["lse_errs"][dtype] = require_close(
            f"paged lse {dtype}", lse[~empty], want_lse[~empty], "float32")
        qf, kf, vf = q.float(), kp.float(), vp.float()
        want32 = ref.paged_attention_ref(qf, kf, vf, pt, sl)
        scale = ref.paged_attention_ref(qf, kf, vf.abs(), pt, sl)
        P = kp.shape[1]
        for n in FLASH_DECODE_SHARDS:
            parts = [paged_attention_cuda(
                q, kp, vp, torch.where((pt >= 0) & (pt * n // P == s), pt,
                                       -1).to(torch.int32), sl,
                return_lse=True) for s in range(n)]
            got = T.combine_shards(torch.stack([o for o, _ in parts]),
                                   torch.stack([l for _, l in parts]),
                                   lambda t: t.amax(0), lambda t: t.sum(0))
            name = f"{n} shards {dtype}"
            res["shard_errs"][name] = require_close(
                f"flash_decode {name}", got, out, dtype)
            if dtype == "bfloat16":
                r = bf16_rounding_ratio(got, want32, scale)
                res["shard_ratios"][name] = r
                if r > 1:
                    raise AssertionError(f"flash_decode {name}: {r} times "
                                         f"the bf16 rounding limit")
        if dtype == "bfloat16":
            res["lse_ms"] = cuda_time_ms(lambda: paged_attention_cuda(
                q, kp, vp, pt, sl, return_lse=True), iters=50)
            res["ms"] = cuda_time_ms(lambda: paged_attention_cuda(
                q, kp, vp, pt, sl), iters=50)
        del q, kp, vp, pt, sl, qf, kf, vf, want32, scale
    log(f"flash_decode_shards: paged lse within TOL ({res['lse_errs']}), "
        f"the empty row -inf and 0; shards {FLASH_DECODE_SHARDS} combined "
        f"within TOL of the unsharded kernel ({res['shard_errs']}), bf16 "
        f"within {max(res['shard_ratios'].values())} of the rounding limit; "
        f"bf16 {res['lse_ms']:.6f} ms with the lse, {res['ms']:.6f} without")

    layers, B, S = DVF["qwen2.5-14b"]
    cfg = get_config("qwen2.5-14b").replace(n_layers=layers,
                                            dtype="bfloat16")
    model = build_model(cfg, dev).init(seed + 3, max_seq=S)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev,
                         dtype=torch.int32)
    counters = dict(attn, **{"paged_attention.lse": lse_launches})
    (plain, _), plain_launches, plain_s = counted_run(
        counters, lambda: T.prefill(cfg, model, {"tokens": toks}, S))
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    nccl_s = warm_groups(mesh)
    fcfg = cfg.replace(flash_decode_shards=True)

    def sharded():
        with shd.activate(mesh):
            return T.prefill(fcfg, model, {"tokens": toks}, S)

    (logits, cache), launches, mesh_s = counted_run(counters, sharded)
    pools = [t.value["k_pages"] for t in cache["layers"]
             if t.kind == "paged"]
    want = layers * S
    if plain_launches["paged_attention"] != want \
            or launches["paged_attention"] != want \
            or launches["paged_attention.lse"] != want \
            or plain_launches["paged_attention.lse"] != 0:
        raise AssertionError(f"flash_decode: launches {launches} (plain "
                             f"{plain_launches}), want {want} lse launches")
    if not all(shd.spec_of(p) == T.POOL_SPEC for p in pools):
        raise AssertionError("flash_decode: the pools are not split on the "
                             "page axis")
    if not torch.equal(logits, plain):
        raise AssertionError(f"flash_decode: logits under the mesh differ "
                             f"from the plain decode by "
                             f"{max_abs_err(logits, plain)}")
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprof
        for tag, c, act in (("plain", cfg, None), ("mesh", fcfg, mesh)):
            with tprof(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                with shd.activate(act):
                    T.prefill(c, model, {"tokens": toks[:, :16]}, S)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            res[f"profile_{tag}"] = profile_table(f"flash_decode_{tag}",
                                                  prof, wall)
    del model, cache
    gc.collect()
    torch.cuda.empty_cache()
    res.update(decode_launches=launches, plain_decode_launches=plain_launches,
               decode_s=mesh_s, plain_decode_s=plain_s, layers=layers, B=B,
               S=S, logits_bit_identical=True, nccl_setup_s=nccl_s)
    log(f"flash_decode_shards: qwen2.5-14b, {layers} layers, bf16, B {B}, S "
        f"{S} under the world-1 mesh: logits bit-identical to the plain "
        f"decode; {mesh_s:.3f} s against {plain_s:.3f} s (NCCL's groups "
        f"made before, in {nccl_s:.3f} s); launches {launches}")
    return res


def mesh_phases(dev, seed, attn) -> dict:
    """The mesh slice on the world-1 NCCL group: ``mesh_train:gemma3-1b``
    and ``flash_decode_shards``, each timed."""
    start_world1()
    out = {}
    try:
        for name, fn in (("mesh_train:gemma3-1b",
                          lambda: mesh_train_phase(dev, seed)),
                         ("flash_decode_shards",
                          lambda: flash_decode_phase(dev, seed, attn))):
            t0 = time.perf_counter()
            out[name] = fn()
            out[name]["phase_s"] = time.perf_counter() - t0
    finally:
        stop_world1()
    return out


# ------------------------------------------------------------ the dry run --
DRYRUN_BAND = (0.8, 1.25)      # predicted over measured peak of mesh_train
DRYRUN_CHILD = r"""
import json, time
t0 = time.perf_counter()
from repro_torch.configs import ShapeCell, get_config
from repro_torch.launch import dryrun
out = {"import_s": time.perf_counter() - t0}
cfg = get_config("gemma3-1b")
with dryrun.fake_process_group(256):
    out["mesh_train"] = dryrun.run_cell(
        "gemma3-1b", "train_4k", False,
        cfg_override=cfg.replace(n_layers=6, dtype="float32"),
        cell=ShapeCell("mesh_train", 1024, 4, "train"), mesh_shape=(1, 1))
    out["mesh_fsdp"] = dryrun.run_cell(
        "gemma3-1b", "train_4k", False,
        cfg_override=cfg.replace(n_layers=6, dtype="float32"),
        cell=ShapeCell("mesh_fsdp", 1024, 4, "train"), mesh_shape=(2, 1))
    out["train_4k"] = dryrun.run_cell("gemma3-1b", "train_4k", False)
print(json.dumps(out))
"""


def start_dryrun():
    """Start the dry run's child process (see :func:`dryrun_phase`): no
    card (``CUDA_VISIBLE_DEVICES`` empty), one core, so it runs beside the
    mesh phases; returns it and its start time."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return (subprocess.Popen([sys.executable, "-c", DRYRUN_CHILD], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, cwd=str(ROOT)),
            time.perf_counter())


def dryrun_phase(mesh_train, child=None) -> dict:
    """``dryrun``: one child process (:func:`start_dryrun`; the fake
    process group cannot share this process with the mesh phases' NCCL
    group) runs ``repro_torch.launch.dryrun.run_cell`` on a fake group of
    256 ranks on ``meta`` for (a) ``mesh_train:gemma3-1b``'s cell (6
    layers, B 4, S 1024, f32, a (1, 1) mesh), whose ``per_device_total``
    must be within DRYRUN_BAND of the bytes the mesh steps held at most on
    the card (``mesh_train``'s ``step_peak_bytes``), and (b)
    ``gemma3-1b|train_4k|single`` at full size on the 16 x 16 mesh: its
    memory, ``fits`` and roofline (CPU model outputs for the H100's peaks,
    not card times), and (c) ``mesh_fsdp:gemma3-1b``'s cell (that of (a)
    on a (2, 1) mesh), returned for :func:`fsdp_vs_dryrun` to hold against
    the ranks' steps after ``mesh_tp``.  ``child`` is one started earlier;
    ``wait_s`` is what the phase adds to the run after the mesh
    phases."""
    proc, t_start = child or start_dryrun()
    t0 = time.perf_counter()
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    wait = time.perf_counter() - t0
    wall = time.perf_counter() - t_start
    if proc.returncode != 0:
        raise AssertionError(f"dryrun: the child failed (rc "
                             f"{proc.returncode}):\n{stderr[-4000:]}")
    out = json.loads(stdout.strip().splitlines()[-1])
    a, b = out["mesh_train"], out["train_4k"]
    measured = mesh_train["step_peak_bytes"]
    ratio = a["memory"]["per_device_total"] / measured
    r = dict(wall_s=wall, wait_s=wait, import_s=out["import_s"],
             mesh_train=dict(memory=a["memory"], hlo=a["hlo"],
                             timings=a["timings"],
                             measured_step_peak_bytes=measured,
                             measured_peak_bytes=mesh_train["peak_bytes"],
                             ratio=ratio),
             train_4k=dict(memory=b["memory"], hlo=b["hlo"],
                           roofline=b["roofline"], peaks=b["peaks"],
                           timings=b["timings"]),
             mesh_fsdp=dict(memory=out["mesh_fsdp"]["memory"],
                            hlo=out["mesh_fsdp"]["hlo"],
                            timings=out["mesh_fsdp"]["timings"]))
    m = b["memory"]
    log(f"dryrun (a) mesh_train:gemma3-1b: predicted per_device_total "
        f"{a['memory']['per_device_total']} bytes (arguments "
        f"{a['memory']['argument_bytes']}, temp {a['memory']['temp_bytes']};"
        f" the plain attention's own {a['memory']['plain_attention_bytes']}"
        f" left out) against {measured} measured over the mesh steps "
        f"(raw peak {mesh_train['peak_bytes']}): ratio {ratio:.4f}, band "
        f"{DRYRUN_BAND}; traced in {a['timings']['compile_s']:.3f} s")
    log(f"dryrun (b) gemma3-1b|train_4k|single (16 x 16, bf16, CPU model "
        f"for the H100's peaks): per_device_total {m['per_device_total']} "
        f"bytes, fits {m['fits']} (80 GB), the plain attention "
        f"{m['plain_attention_bytes']} more; roofline "
        f"{json.dumps(b['roofline'])}; traced in "
        f"{b['timings']['compile_s']:.3f} s")
    log(f"dryrun: {wall:.3f} s in the child (imports {out['import_s']:.3f} "
        f"s), {wait:.3f} s waited for it after the mesh phases")
    if not DRYRUN_BAND[0] <= ratio <= DRYRUN_BAND[1]:
        raise AssertionError(f"dryrun: predicted over measured peak {ratio} "
                             f"outside {DRYRUN_BAND}")
    if not (m["per_device_total"] > m["argument_bytes"] > 0
            and b["roofline"]["step_s"] > 0):
        raise AssertionError(f"dryrun (b): {m}, {b['roofline']}")
    return r


# ----------------------------------------------------- tensor parallelism --
MESH_TP_WORLD = 2
STEP_TOL = dict(atol=2e-3, rtol=2e-3)   # tests/test_torch_distributed.py's
UPDATE_TOL = 1e-4    # each parameter's update against the plain step's,
#                      in relative norm (the distributed tests' limit)
MESH_TP_GO_TIMEOUT_S = 900


# the cells of ``mesh_tp`` in the order the ranks run them: full width,
# depth cut, f32 (TF32 off); B, S; the q heads each rank's flash kernels
# run on (None: no attention); the local weights recorded; AdamW's
# ``eps`` where it is not mesh_train's 1e-8; ``per_step``: each step held
# alone against a plain step from the same state, not chained; and the
# largest relative error of an update in norm against the plain steps'.
#
# Why hymba and xLSTM differ from gemma3-1b (tools/torch_tp_floor.py and
# this phase on an NVIDIA H100 80GB HBM3 at 700.00 W): two plain
# runs that differ only in the order of their sums (the batch in 2
# microbatches) drift apart by more than UPDATE_TOL.  hymba: 1.21e-4 over
# 3 chained steps at eps 1e-8, where Adam's first update lr * g / (|g| +
# eps) gives gradients of rounding size (|g| near eps) a sizeable step;
# at eps 1e-6 3.42e-5 (the tensor-parallel steps 3.46e-5).  xLSTM: its
# gradients at full width are ill-conditioned (the mLSTM's max(|den|,
# exp(-m)) and the gates' max stabilisers switch branch on rounding):
# the microbatched first step's gradient norm is 5.3e-4 off, and chained
# steps diverge (gradient norm 54.7 against 65.7 at step 3, updates 0.42
# off at eps 1e-8, 7.0e-3 even at eps 1e-3); held a step at a time from
# the same state, the tensor-parallel updates were 7.8e-3 off at eps 1e-6
# (the microbatched step 7.4e-3), the losses 1.9e-6 and the gradient
# norms 9.7e-3.  Planted faults (z from the rank's own block, a dropped
# w_bc or w_if reduction) are 1.3-1.7 off on the CPU
# (tests/test_torch_tp_recurrent.py).
MESH_TP_CELLS = {
    "gemma3-1b": dict(layers=6, B=4, S=1024, q_heads=2, per_step=False,
                      update_tol=UPDATE_TOL,
                      shapes=("embed.table", "blocks.0.attn.wq.w",
                              "blocks.0.attn.wk.w", "blocks.0.attn.wo.w",
                              "blocks.0.mlp.w1.w", "blocks.0.mlp.w2.w")),
    # global layers {0, 3, 5}; 1024 tokens after the 128 meta tokens, so
    # the 1024 window masks on the others; 25 q heads over 2 ranks: 12.5
    # heads of wo's rows a rank, so 13 q heads across the GQA groups
    "hymba-1.5b": dict(layers=6, B=2, S=1024, q_heads=13, eps=1e-6,
                       per_step=False, update_tol=UPDATE_TOL,
                       shapes=("blocks.0.mamba.w_in", "blocks.0.mamba.w_dt",
                               "blocks.0.mamba.w_bc", "blocks.0.mamba.w_out",
                               "blocks.0.attn.wq.w", "blocks.0.attn.wk.w")),
    # 7 mLSTM blocks and the sLSTM at layer 7; 4 heads, 2 a rank
    "xlstm-1.3b": dict(layers=8, B=2, S=256, q_heads=None, eps=1e-6,
                       per_step=True, update_tol=3e-2,
                       shapes=("blocks.0.w_up.w", "blocks.0.w_if.w",
                               "blocks.0.w_down.w", "blocks.7.w_in.w",
                               "blocks.7.r", "blocks.7.w_down.w")),
}


# ``mesh_fsdp:gemma3-1b``: ZeRO-3 block by block, the gemma3-1b cell's
# settings (MESH_TP_CELLS) on a (MESH_TP_WORLD, 1) data/model mesh: each
# rank half the batch and its half of every weight's d_model dimension,
# each block gathered over data in the layer loop and its gradient
# reduce-scattered back; held against the gemma3-1b cell's plain steps
MESH_FSDP_ARCH = "gemma3-1b"
MESH_FSDP_SHAPE = (MESH_TP_WORLD, 1)


def mesh_tp_adamw(arch: str):
    """The AdamW settings of ``MESH_TP_CELLS[arch]``: ``mesh_train``'s,
    with the cell's ``eps`` where it sets one."""
    from repro_torch.training import optimizer as opt

    return opt.AdamWConfig(lr=3e-3, warmup=10, total_steps=MESH_TRAIN_STEPS,
                           eps=MESH_TP_CELLS[arch].get("eps", 1e-8))


def _gather_whole(tensors: dict, mesh) -> dict:
    """Each DTensor of ``tensors`` (name -> DTensor on ``mesh``) whole: its
    local shard gathered over ``data`` (``tensor_parallel.local_of``), then
    over ``model`` on each dimension its spec splits there."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tensor_parallel as tp

    out, n = {}, shd._size(mesh, "model")
    with torch.no_grad():
        for name, p in tensors.items():
            x = tp.local_of(p, mesh)
            for d in tp.model_dims(shd.spec_of(p)) if n > 1 else ():
                parts = [torch.empty_like(x) for _ in range(n)]
                dist.all_gather(parts, x.contiguous(),
                                group=mesh.get_group("model"))
                x = torch.cat(parts, d)
            out[name] = x
    return out


def _held_to_plain(name, metrics, pm, full, plain_params, init,
                   tol) -> dict:
    """The mesh cell ``name``'s ``metrics`` and gathered parameters
    ``full`` against the plain steps' ``pm`` and ``plain_params``, both
    from the parameters ``init`` (f64): losses and gradient norms and
    parameters within STEP_TOL, each parameter's update within ``tol`` in
    relative norm (raises otherwise).  Returns the largest
    differences."""
    import torch

    errs = {}
    for k in ("loss", "grad_norm"):
        got = torch.tensor([m[k] for m in metrics], dtype=torch.float64)
        want = torch.tensor([m[k] for m in pm], dtype=torch.float64)
        if not torch.allclose(got, want, **STEP_TOL):
            raise AssertionError(f"{name}: {k} {got.tolist()} "
                                 f"against plain {want.tolist()}")
        errs[k] = float((got - want).abs().max())
    worst, bad, upd = 0.0, [], {}
    with torch.no_grad():
        for n, p in plain_params.items():
            f = full[n].to(p.device)
            if not torch.allclose(f, p, **STEP_TOL):
                bad.append(n)
            worst = max(worst, float((f - p).abs().max()))
            i = init[n].to(p.device)
            want = p.double() - i
            upd[n] = float((f.double() - i - want).norm()
                           / want.norm().clamp(min=1e-30))
    if bad:
        raise AssertionError(f"{name}: parameters beyond STEP_TOL of the "
                             f"plain steps: {bad}")
    top = sorted(upd.items(), key=lambda kv: -kv[1])[:4]
    if top[0][1] > tol:
        raise AssertionError(f"{name}: updates beyond {tol} of the plain "
                             f"steps' in relative norm: {top}")
    return dict(metric_errs=errs, param_max_abs_err=worst,
                update_rel_errs=top)


def _per_step_errs(arch, state, plain, before, mesh) -> dict:
    """One ``per_step`` comparison (see :func:`mesh_tp_cell`): this rank's
    shards of the tensor-parallel parameters after a step against the
    same slices of the plain parameters after the plain step from the
    same state ``before``, within STEP_TOL, and each parameter's update
    against the plain one's in relative norm (the squares summed over the
    ranks' shards, a parameter whole on every rank counted once), within
    the cell's ``update_tol``.  Raises otherwise; returns the largest
    absolute difference and the four largest relative errors."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tensor_parallel as tp

    names, sq, worst, bad = [], [], 0.0, []
    own = mesh.get_local_rank("model") == 0
    pp = dict(plain["params"].named_parameters())
    with torch.no_grad():
        for n, p in state["params"].named_parameters():
            spec = shd.spec_of(p)
            got = p.to_local()
            want = shd.local_slice(pp[n].detach(), mesh, spec)
            start = shd.local_slice(before[n], mesh, spec)
            if not torch.allclose(got, want, **STEP_TOL):
                bad.append(n)
            worst = max(worst, float((got - want).abs().max()))
            count = own or bool(tp.model_dims(spec))
            d = (got.double() - want.double()).square().sum()
            u = (want.double() - start.double()).square().sum()
            names.append(n)
            sq.append(torch.stack([d, u]) * count)
    sq = torch.stack(sq)
    dist.all_reduce(sq, group=mesh.get_group("model"))
    if bad:
        raise AssertionError(f"mesh_tp:{arch}: parameters beyond STEP_TOL "
                             f"of the plain step: {bad}")
    rel = (sq[:, 0] / sq[:, 1].clamp(min=1e-60)).sqrt().tolist()
    top = sorted(zip(names, rel), key=lambda kv: -kv[1])[:4]
    tol = MESH_TP_CELLS[arch]["update_tol"]
    if top[0][1] > tol:
        raise AssertionError(f"mesh_tp:{arch}: updates beyond {tol} of the "
                             f"plain step's in relative norm: {top}")
    return dict(param_max_abs_err=worst, update_rel_errs=top)


def mesh_tp_cell(rank: int, arch: str, seed: int, dev,
                 shape=(1, MESH_TP_WORLD), plain_run=None) -> dict:
    """One cell of ``MESH_TP_CELLS`` on this rank (see
    :func:`mesh_tp_rank`): MESH_TRAIN_STEPS mesh steps on a ``shape``
    data/model mesh (by default (1, MESH_TP_WORLD): tensor-parallel;
    MESH_FSDP_SHAPE: ZeRO-3 block by block, the batch split over data),
    the launch counts set to 0 before each
    and read after it, the flash kernels' q head counts recorded on the
    way, held against as many plain steps from the same seed and batches:
    the losses and gradient norms within STEP_TOL, the parameters within
    STEP_TOL and each parameter's update within the cell's ``update_tol``
    in relative norm.  Chained: rank 0 runs the plain steps after the
    tensor-parallel ones and holds them against the parameters gathered
    at the end.  ``per_step``: every rank runs each plain step beside the
    tensor-parallel one from the same state and holds its shards against
    the plain step's slices (:func:`_per_step_errs`), then loads the plain
    state's slices into its shards, so each step is held alone (xLSTM's
    rounding differences grow over chained steps: see MESH_TP_CELLS).
    ``plain_run``, a dict, carries a chained cell's plain steps to the
    next cell of the same arch: rank 0 fills it (their metrics and final
    parameters, on the host) when it is empty and holds the steps against
    it, with no plain steps of its own, when it is not.  The record's
    ``step_peak_bytes`` is what the steps held at most less what was
    allocated before them, plus the state's shards and a batch (the dry
    run's arguments), as ``mesh_train``'s."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.interop import param_axes
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import (make_train_step,
                                                 shard_state,
                                                 state_shardings)

    cell = MESH_TP_CELLS[arch]
    B, S = cell["B"], cell["S"]
    cfg = get_config(arch).replace(n_layers=cell["layers"], dtype="float32")
    api = build_model(cfg, dev)
    acfg = mesh_tp_adamw(arch)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    batches = [{"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                        device=dev, dtype=torch.int32)}
               for _ in range(MESH_TRAIN_STEPS)]

    def fresh():
        model = api.init(seed, S).requires_grad_(True)
        return {"params": model, "opt": opt.adamw_init(model, acfg)}

    heads = {"fwd": set(), "bwd": set()}
    fwd, bwd = ops.flash_attention_cuda, ops.flash_attention_bwd_cuda

    def fwd_heads(q, *a, **kw):
        heads["fwd"].add(q.shape[1])
        return fwd(q, *a, **kw)

    def bwd_heads(q, *a, **kw):
        heads["bwd"].add(q.shape[1])
        return bwd(q, *a, **kw)

    name = ("mesh_tp:" if shape[0] == 1 else "mesh_fsdp:") + arch
    mesh = make_mesh(shape, ("data", "model"), "cuda")
    state = fresh()
    state = shard_state(state, state_shardings(
        cfg, param_axes(state["params"]), mesh, state["params"], acfg))
    step = make_train_step(cfg, api, adamw=acfg, mesh=mesh)
    held_bytes = sum(t.to_local().numel() * t.element_size() for t in (
        list(state["params"].parameters()) + list(state["opt"]["mu"].values())
        + list(state["opt"]["nu"].values()))) \
        + batches[0]["tokens"].numel() * batches[0]["tokens"].element_size()
    per_step = cell["per_step"]
    plain = fresh() if per_step else None
    pstep = make_train_step(cfg, api, adamw=acfg) \
        if per_step or rank == 0 else None
    plain_bytes = sum(t.numel() * t.element_size() for t in (
        list(plain["params"].parameters()) + list(plain["opt"]["mu"].values())
        + list(plain["opt"]["nu"].values()))) if per_step else 0
    counters = train_counters()
    launches = {k: 0 for k in counters}
    metrics, times, peaks, pm, held = [], [], [], [], []
    torch.cuda.synchronize()
    before_steps = torch.cuda.memory_allocated() - plain_bytes
    for t, b in enumerate(batches):
        dist.barrier()
        for c in counters.values():
            c.n = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.flash_attention_cuda, ops.flash_attention_bwd_cuda = \
            fwd_heads, bwd_heads
        try:
            t0 = time.perf_counter()
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        finally:
            ops.flash_attention_cuda, ops.flash_attention_bwd_cuda = fwd, bwd
        for k, c in counters.items():
            launches[k] += c.n
        # a per-step cell holds the plain state beside the step's: leave
        # it out of the step's peak
        peaks.append(torch.cuda.max_memory_allocated() - plain_bytes)
        if not per_step:
            continue
        before = {n: p.detach().clone() for n, p in
                  plain["params"].named_parameters()}
        plain, pmt = pstep(plain, b)
        pm.append({k: float(v) for k, v in pmt.items()})
        for k in ("loss", "grad_norm"):
            if not math.isclose(metrics[-1][k], pm[-1][k],
                                rel_tol=STEP_TOL["rtol"],
                                abs_tol=STEP_TOL["atol"]):
                raise AssertionError(f"{name} step {t}: {k} "
                                     f"{metrics[-1][k]} against plain "
                                     f"{pm[-1][k]}")
        held.append(_per_step_errs(arch, state, plain, before, mesh))
        held[-1]["metric_errs"] = {k: abs(metrics[-1][k] - pm[-1][k])
                                   for k in ("loss", "grad_norm")}
        del before
        with torch.no_grad():           # the next step from the same state
            pp = dict(plain["params"].named_parameters())
            for n, p in state["params"].named_parameters():
                p.to_local().copy_(shd.local_slice(pp[n].detach(), mesh,
                                                   shd.spec_of(p)))
            for k in ("mu", "nu"):
                for n, x in state["opt"][k].items():
                    x.to_local().copy_(shd.local_slice(
                        plain["opt"][k][n], mesh, shd.spec_of(x)))
    local = {n: list(p.shape) for n, p in
             step.work["model"].named_parameters()}
    r = dict(losses=[m["loss"] for m in metrics],
             grad_norms=[m["grad_norm"] for m in metrics],
             step_s=times, ms_per_step=statistics.median(times) * 1e3,
             peak_bytes=max(peaks), launches=launches, mesh=list(shape),
             step_peak_bytes=max(peaks) - before_steps + held_bytes,
             q_heads={k: sorted(v) for k, v in heads.items()},
             local_shapes={n: local[n] for n in cell["shapes"]},
             compared="each step from the same state" if per_step
             else "chained", adamw_eps=acfg.eps)
    full = None if per_step else _gather_whole(
        dict(state["params"].named_parameters()), mesh)
    del state, step, plain
    if rank == 0 and not per_step:
        gc.collect()
        torch.cuda.empty_cache()
        plain = fresh()
        init = {n: p.detach().double() for n, p in
                plain["params"].named_parameters()}
        if plain_run:
            del plain
            pm = plain_run["metrics"]
            params = {n: p.to(dev) for n, p in plain_run["params"].items()}
        else:
            for b in batches:
                plain, m = pstep(plain, b)
                pm.append({k: float(v) for k, v in m.items()})
            params = dict(plain["params"].named_parameters())
            del plain
            if plain_run is not None:
                plain_run.update(metrics=pm, params={
                    n: p.detach().cpu() for n, p in params.items()})
        held.append(_held_to_plain(name, metrics, pm, full, params, init,
                                   cell["update_tol"]))
        del params, init
    if held:
        r.update(plain_losses=[m["loss"] for m in pm],
                 plain_grad_norms=[m["grad_norm"] for m in pm],
                 metric_errs={k: max(h["metric_errs"][k] for h in held)
                              for k in ("loss", "grad_norm")},
                 param_max_abs_err=max(h["param_max_abs_err"]
                                       for h in held),
                 update_rel_errs=sorted(
                     (e for h in held for e in h["update_rel_errs"]),
                     key=lambda kv: -kv[1])[:4])
    del full
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return r


MESH_CELLS = tuple(MESH_TP_CELLS) + ("mesh_fsdp",)


def mesh_tp_rank(rank: int, store: str, go: str, seed: int,
                 cells=MESH_CELLS) -> dict:
    """One rank of ``mesh_tp`` (see :func:`mesh_tp_phase`), in a process
    of its own: a gloo group of MESH_TP_WORLD ranks on the one card (met
    through a FileStore).  It starts the group, then waits for the file
    ``go`` (:func:`release_mesh_tp`) before it does any work on the card,
    so it can start beside timed phases without running beside them; then
    each of ``cells`` in turn (:func:`mesh_tp_cell`): the cells of
    MESH_TP_CELLS by arch, and ``mesh_fsdp`` (MESH_FSDP_ARCH on
    MESH_FSDP_SHAPE), which takes the plain steps of that arch's cell when
    it ran before it.  Returns the rank's records (printed as JSON)."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build.lib()
    dist.init_process_group("gloo", store=dist.FileStore(store, MESH_TP_WORLD),
                            rank=rank, world_size=MESH_TP_WORLD,
                            timeout=datetime.timedelta(seconds=180))
    out = {"rank": rank, "cells": {}}
    try:
        deadline = time.monotonic() + MESH_TP_GO_TIMEOUT_S
        while not pathlib.Path(go).exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f"mesh_tp: no {go} after "
                                   f"{MESH_TP_GO_TIMEOUT_S} s")
            time.sleep(0.05)
        t_go = time.perf_counter()
        plain_run = {}
        for cell in cells:
            t0 = time.perf_counter()
            if cell == "mesh_fsdp":
                r = mesh_tp_cell(rank, MESH_FSDP_ARCH, seed, dev,
                                 MESH_FSDP_SHAPE, plain_run)
            else:
                r = mesh_tp_cell(rank, cell, seed, dev, plain_run=(
                    plain_run if cell == MESH_FSDP_ARCH else None))
            out["cells"][cell] = dict(r, cell_s=time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()
    out["wall_s"] = time.perf_counter() - t_start
    out["work_s"] = time.perf_counter() - t_go
    return out


MESH_TP_CHILD = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import chip_smoke
print(json.dumps(chip_smoke.mesh_tp_rank(int(sys.argv[2]), sys.argv[3],
                                         sys.argv[4], int(sys.argv[5]),
                                         sys.argv[6].split(","))))
"""


MESH_TP_GO = ROOT / "build" / "chip_tp_go"


def start_mesh_tp(seed, cells=MESH_CELLS):
    """Start the MESH_TP_WORLD rank processes of ``mesh_tp`` running
    ``cells`` (see :func:`mesh_tp_rank` and :func:`mesh_tp_phase`); they
    start up and wait, off the card, for :func:`release_mesh_tp`.
    Returns them and the start time."""
    import os

    store = ROOT / "build" / "chip_tp_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    MESH_TP_GO.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_TP_CHILD, str(ROOT), str(r), str(store),
         str(MESH_TP_GO), str(seed), ",".join(cells)], env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=str(ROOT))
        for r in range(MESH_TP_WORLD)]
    return procs, time.perf_counter()


def release_mesh_tp() -> None:
    """Let the ranks of :func:`start_mesh_tp` go on to their work on the
    card."""
    MESH_TP_GO.touch()


def stop_children(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def mesh_tp_phase(child, dry=None) -> dict:
    """``mesh_tp``: mesh training on one card, a record for each cell the
    ranks ran (``mesh_tp:<arch>``, ``mesh_fsdp:gemma3-1b``).  NCCL takes
    one rank a device, so MESH_TP_WORLD processes share the card in a
    gloo group on CUDA tensors (:func:`start_mesh_tp`, started earlier,
    released here if not before; :func:`mesh_tp_rank`).  On a (1, 2)
    data/model mesh, tensor-parallel: ``mesh_train``'s gemma3-1b cell
    (each rank 2 of the 4 q heads, half of each kv projection's columns
    gathered to the 1 kv head, half of the MLP and of the tied
    vocabulary), hymba-1.5b (half of d_inner a rank: xm's and z's columns
    of ``mamba.w_in`` from both ranks' blocks, the scan on the rank's
    channels, 13 of the 25 q heads) and xlstm-1.3b (half of each mLSTM's
    and of the sLSTM's inner dimension, 2 of the 4 heads).  On a (2, 1)
    mesh, ``mesh_fsdp:gemma3-1b``: the gemma3-1b cell's batch split 2 a
    rank, every weight's d_model dimension split over data, each block
    gathered in the layer loop and its gradient reduce-scattered, all 4 q
    heads a rank.  MESH_TRAIN_STEPS steps each; rank 0's losses, gradient
    norms and updated parameters within STEP_TOL of as many plain steps
    on the card (the FSDP cell takes the gemma3-1b cell's), each
    parameter's update within the cell's ``update_tol`` in relative norm
    (:func:`mesh_tp_cell`); on both ranks the flash forward and its f32
    ``simt`` backward launched on the cell's q heads only (xLSTM none).
    ``dry`` (:func:`dryrun_phase`'s record) holds the FSDP cell's
    ``step_peak_bytes`` on each rank against the dry run's prediction of
    that cell, within DRYRUN_BAND.  Prints each rank's local weight
    shapes, ms a step and peak bytes."""
    procs, t_start = child
    release_mesh_tp()
    t0 = time.perf_counter()
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        stop_children(procs)
    wait = time.perf_counter() - t0
    bad = [(r, p.returncode, err[-4000:]) for r, (p, (_, err)) in
           enumerate(zip(procs, outs)) if p.returncode != 0]
    if bad:
        raise AssertionError(f"mesh_tp: ranks failed: {bad}")
    from repro_torch.configs import get_config

    ranks = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    res = {}
    for key in ranks[0]["cells"]:
        fsdp = key == "mesh_fsdp"
        arch = MESH_FSDP_ARCH if fsdp else key
        cell = MESH_TP_CELLS[arch]
        name = f"{key}:{arch}" if fsdp else f"mesh_tp:{arch}"
        # data parallel: every q head on each rank
        want = get_config(arch).n_heads if fsdp else cell["q_heads"]
        recs = [dict(r["cells"][key], rank=r["rank"]) for r in ranks]
        for r in recs:
            if want is None:
                if any(r["launches"].values()):
                    raise AssertionError(f"{name} rank {r['rank']}: "
                                         f"attention launched "
                                         f"{r['launches']}")
            else:
                require_launched(f"{name} rank {r['rank']}", r["launches"])
                if r["q_heads"] != {"fwd": [want], "bwd": [want]}:
                    raise AssertionError(
                        f"{name} rank {r['rank']}: flash ran on q heads "
                        f"{r['q_heads']}, not {want}")
            log(f"{name} rank {r['rank']}: local shapes "
                f"{r['local_shapes']}; {r['ms_per_step']:.3f} ms a step "
                f"({r['step_s']}), peak {r['peak_bytes']} bytes (the steps "
                f"held {r['step_peak_bytes']}); launches {r['launches']}; "
                f"flash q heads {r['q_heads']}; {r['cell_s']:.3f} s")
        r0 = recs[0]
        log(f"{name} ({cell['layers']} layers, B {cell['B']}, S "
            f"{cell['S']}, f32, {tuple(r0['mesh'])} on one card over "
            f"gloo): losses {r0['losses']} against plain "
            f"{r0['plain_losses']}, grad norms {r0['grad_norms']} against "
            f"{r0['plain_grad_norms']} (largest differences "
            f"{r0['metric_errs']}), parameters within "
            f"{r0['param_max_abs_err']} (STEP_TOL {STEP_TOL}), the largest "
            f"relative errors of the updates {r0['update_rel_errs']} "
            f"(within {cell['update_tol']}; {r0['compared']}, AdamW eps "
            f"{r0['adamw_eps']})")
        res[name] = dict(
            ranks=recs, launches={k: sum(r["launches"][k] for r in recs)
                                  for k in r0["launches"]},
            ms_per_step=[r["ms_per_step"] for r in recs],
            peak_bytes=[r["peak_bytes"] for r in recs],
            step_peak_bytes=[r["step_peak_bytes"] for r in recs],
            cell_s=[r["cell_s"] for r in recs])
        if fsdp and dry is not None:
            res[name]["dryrun"] = fsdp_vs_dryrun(name, recs, dry)
    log(f"mesh_tp: {wait:.3f} s waited for the ranks; "
        f"{[r['work_s'] for r in ranks]} s of work in each; on "
        f"{nvidia_smi()}")
    for r in res.values():
        r.update(wait_s=wait, wall_s=time.perf_counter() - t_start)
    return res


def fsdp_vs_dryrun(name, recs, dry) -> dict:
    """The dry run's ``per_device_total`` of the FSDP cell (``dry``'s
    ``mesh_fsdp``, rank 0 of its (2, 1) mesh) over each rank's
    ``step_peak_bytes``, within DRYRUN_BAND (raises otherwise)."""
    pred = dry["mesh_fsdp"]["memory"]["per_device_total"]
    ratios = [pred / r["step_peak_bytes"] for r in recs]
    log(f"dryrun {name}: predicted per_device_total {pred} bytes "
        f"(arguments {dry['mesh_fsdp']['memory']['argument_bytes']}, temp "
        f"{dry['mesh_fsdp']['memory']['temp_bytes']}) against "
        f"{[r['step_peak_bytes'] for r in recs]} held by the ranks' steps: "
        f"ratios {[round(x, 4) for x in ratios]}, band {DRYRUN_BAND}")
    if not all(DRYRUN_BAND[0] <= x <= DRYRUN_BAND[1] for x in ratios):
        raise AssertionError(f"dryrun {name}: predicted over measured peak "
                             f"{ratios} outside {DRYRUN_BAND}")
    return dict(predicted=pred, ratios=ratios)


REPLACES = {
    "probe_allocate": "src/repro/kernels/probe_allocate.py:167",
    "cache_probe": "src/repro/kernels/cache_probe.py:75",
    "gather_blocks": "src/repro/kernels/gather_blocks.py:39",
    "paged_attention": "src/repro/kernels/paged_attention.py:77",
    "flash_attention": "src/repro/kernels/flash_attention.py:127",
    "flash_attention_bwd": "src/repro/kernels/ref.py:110",
    "sq_enqueue": "src/repro/kernels/ops.py:98",
    "wfq_drain": "src/repro/kernels/ops.py:122",
}


def kernel_entry(name, r, launches):
    entry = {"name": name, "route": "cuda",
             "source": f"src/repro_torch/kernels/csrc/{name}.cu",
             "replaces": REPLACES[name], "launches": launches,
             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r.get("bound_by", "bytes"),
             "library_ms": r.get("library_ms")}
    for key in ("device_ms", "host_us", "floor_ms", "variant",
                "ms_spread", "library_ms_spread", "library", "variants",
                "variant_launches", "lse_ms", "lse_max_abs_err"):
        if key in r:        # device time, host time a call, fixed cost;
            entry[key] = r[key]    # flash: the kernel that was timed; the
    return entry                   # backward: spreads, each variant's times
                                   # and launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2-nodes", type=int, default=23)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace one more BFS and two CC rounds, 64 "
                         "wavefronts of two taxi scans, 8 rounds of the "
                         "partitioned runtime, a window of steps of "
                         "each serving phase, one more forward of "
                         "hymba's and xLSTM's decode-vs-forward phases, "
                         "and one more gemma3-1b train step, with "
                         "torch.profiler")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import (cache_probe, flash_attention,
                                     gather_blocks, paged_attention,
                                     probe_allocate, sq_enqueue, wfq_drain)

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
        if any(w in line for w in ("registers", "stack frame",
                                   "Function properties")) \
                or line.startswith("=="):
            log("  " + line.strip())
    hgmma = hgmma_counts(lib_path)
    log(f"HGMMA instructions per tensor-core flash kernel: {hgmma}")
    if len(hgmma) != 3 or not all(hgmma.values()):
        raise AssertionError(f"tensor-core flash kernels without wgmma: "
                             f"{hgmma}")

    kres = kernel_phase(dev, args.seed)
    kres.update(attention_kernel_phase(dev, args.seed))
    kres.update(attention_bwd_phase(dev, args.seed))
    for k, v in kres.items():
        lib = v.get("library_ms")
        log(f"kernel {k}: {v['ms']:.6f} ms (plain {v['plain_ms']:.6f} ms, "
            f"bound {v['bound_ms']:.6f} ms by {v.get('bound_by', 'bytes')}"
            + (f", library {lib:.6f} ms" if lib is not None else "")
            + (f", device {v['device_ms']:.6f} ms, host "
               f"{v['host_us']:.3f} us a call" if "device_ms" in v else "")
            + (f", floor (m = 1) {v['floor_ms']:.6f} ms"
               if "floor_ms" in v else "")
            + (f", skewed device {v['skewed_device_ms']:.6f} ms"
               if "skewed_device_ms" in v else "")
            + (f", {v['variant']} kernel" if "variant" in v else "")
            + f", max abs err {v['max_abs_err']}) at {v['shape']}")
    log(f"kernel gather_blocks (line): {kres['gather_blocks']['line_ms']:.6f}"
        f" ms (plain {kres['gather_blocks']['line_plain_ms']:.6f} ms, bound "
        f"{kres['gather_blocks']['line_bound_ms']:.6f} ms)")

    bam = {"probe_allocate": probe_allocate.launches,
           "cache_probe": cache_probe.launches,
           "gather_blocks": gather_blocks.launches,
           "sq_enqueue": sq_enqueue.launches,
           "wfq_drain": wfq_drain.launches}
    attn = {"paged_attention": paged_attention.launches,
            "flash_attention": flash_attention.launches,
            "flash_attention.tc": flash_attention.variant_launches["tc"],
            "flash_attention.simt": flash_attention.variant_launches["simt"]}
    sres = slice_phase(dev, args.log2_nodes, args.seed, bam,
                       profile=args.profile)
    gc.collect()                    # the graph's pinned store goes here
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    taxi = taxi_phase(dev, args.seed, bam, profile=args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    faults = fault_phase(dev, args.seed, bam)
    faults_ra = fault_phase(dev, args.seed, bam, readahead=True)
    torch.cuda.empty_cache()
    runtime = runtime_phase(dev, args.seed, bam, profile=args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    models = model_phases(dev, args.seed, attn, profile=args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    training = train_phases(dev, args.seed, profile=args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    child = start_dryrun()      # beside the mesh phases, on one core
    tp_child = start_mesh_tp(args.seed)     # two ranks: they start up there
    try:
        mesh = mesh_phases(dev, args.seed, attn)
        training["mesh_train:gemma3-1b"] = mesh["mesh_train:gemma3-1b"]
        release_mesh_tp()       # on the card beside the dry run's wait only
        t0 = time.perf_counter()
        dry = dryrun_phase(mesh["mesh_train:gemma3-1b"], child)
        dry["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cells = mesh_tp_phase(tp_child, dry)
        for r in cells.values():
            r["phase_s"] = time.perf_counter() - t0
        training.update(cells)
    finally:
        stop_children([child[0]] + tp_child[0])
    fds = mesh["flash_decode_shards"]
    kres["paged_attention"].update(
        lse_ms=fds["lse_ms"],
        lse_max_abs_err=max(fds["lse_errs"].values()))

    launches = dict(sres["launches"])
    # the attention kernels' launches on each model path (every path
    # counts from 0): decode through the engine (of a model with paged
    # layers), full-sequence forward (of a model with attention); xLSTM's
    # paths reach neither kernel, as the reference's reach no Pallas one
    path_launches = {
        "paged_attention": {k: r["launches"]["paged_attention"]
                            for k, r in models.items()
                            if k.startswith("serving")
                            and r["paged_layers"]},
        "flash_attention": {k: r["forward_launches"]["flash_attention"]
                            for k, r in models.items()
                            if k.startswith("decode_vs_forward")
                            and r["forward_flash_layers"]}}
    path_launches["flash_attention"].update(
        {k + ":patches": r["patch_forward_launches"]["flash_attention"]
         for k, r in models.items() if "patch_forward_launches" in r})
    # shard-local flash-decoding under the mesh: every launch the lse one
    path_launches["paged_attention"]["flash_decode_shards"] = \
        fds["decode_launches"]["paged_attention"]
    # the training paths: forward (and remat's recompute) and backward
    # (xLSTM's reaches neither kernel)
    for name in ("flash_attention", "flash_attention_bwd"):
        path_launches.setdefault(name, {}).update(
            {k: r["launches"][name] for k, r in training.items()
             if not (k.startswith("mesh_tp:") and MESH_TP_CELLS[
                 k.split(":")[1]]["q_heads"] is None)})
    for name, per_path in path_launches.items():
        require_launched(name, per_path)
        launches[name] = sum(per_path.values())
    # the backward's launches on the training paths by variant (f32: simt)
    simt = sum(r["launches"]["flash_attention_bwd.simt"]
               for r in training.values())
    kres["flash_attention_bwd"]["variant_launches"] = {
        "simt": simt, "tc": launches["flash_attention_bwd"] - simt}
    lse = fds["decode_launches"]["paged_attention.lse"]
    kres["paged_attention"]["variant_launches"] = {
        "out": launches["paged_attention"] - lse, "lse": lse}
    kernels = [kernel_entry(name, kres[name], launches[name])
               for name in REPLACES]
    phases = dict(sres["phase_launches"], **taxi["phase_launches"],
                  faults=faults["launches"],
                  faults_legacy=faults["legacy_launches"],
                  faults_readahead=faults_ra["launches"],
                  **runtime["phase_launches"])
    for entry in kernels:
        if entry["name"] in bam:
            entry["phase_launches"] = {p: n[entry["name"]]
                                       for p, n in phases.items()}
        else:
            entry["phase_launches"] = path_launches[entry["name"]]
    total_s = time.perf_counter() - t_start
    log(f"chip_smoke: all phases passed in {total_s:.3f} s")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        nvidia_smi=smi, device=torch.cuda.get_device_name(0),
        torch=torch.__version__, cuda=torch.version.cuda,
        build_s=t_build, build_log=build.build_log, hgmma=hgmma,
        kernels=kres,
        slice=sres, taxi=taxi, faults=faults, faults_readahead=faults_ra,
        runtime=runtime, **models, training=training,
        flash_decode_shards=fds, dryrun=dry, total_s=total_s),
        indent=1))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
