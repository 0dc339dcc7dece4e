"""Hill-climbing on the dry run: hypothesis -> change -> re-run ->
re-analyse.

Port of ``repro.launch.perf``: the reference's ``EXPERIMENTS`` (the
paper's technique cell, the most collective-bound cell, the worst
roofline fraction among the large models and a batch decode cell, each
with named variants of ``ArchConfig`` knobs and sharding rules) over the
port's :func:`repro_torch.launch.dryrun.run_cell` on the 16 x 16 mesh.
Results append to ``build/perf.json``; they are CPU model outputs for the
H100's peaks, not times on a card.

    PYTHONPATH=src python -m repro_torch.launch.perf [cell ...]
"""
import json
import sys
import traceback
from pathlib import Path

from repro_torch.configs.base import get_config
from repro_torch.distributed.sharding import DEFAULT_RULES
from repro_torch.launch.dryrun import fake_process_group, run_cell

SERVE_RULES = dict(DEFAULT_RULES)
SERVE_RULES["w_embed"] = None          # no ZeRO weight sharding at serve

EXPERIMENTS = {
    # ------------------------------------------------------------------
    # Cell A: the paper's technique cell — BaM-paged KV long-context decode
    "gemma3_12b|long_500k": [
        ("baseline", {}, None),
        ("serve_sharding", dict(param_dtype="bfloat16"), SERVE_RULES),
        ("serve_sharding+flash_decode",
         dict(param_dtype="bfloat16", flash_decode_shards=True),
         SERVE_RULES),
    ],
    # ------------------------------------------------------------------
    # Cell B: most collective-bound — MoE train step
    "moonshot_v1_16b_a3b|train_4k": [
        ("baseline", {}, None),
        ("local_combine", dict(moe_combine="allgather"), None),
        ("local_combine+cap1.0",
         dict(moe_combine="allgather", capacity_factor=1.0), None),
        ("scatter_combine", dict(moe_combine="scatter"), None),
        ("scatter_combine+cap1.0",
         dict(moe_combine="scatter", capacity_factor=1.0), None),
    ],
    # ------------------------------------------------------------------
    # Cell C: worst roofline fraction among the large models — 32k prefill
    "qwen2_5_14b|prefill_32k": [
        ("baseline", {}, None),
        ("bf16_tiles", dict(attn_f32=False), None),
        ("bf16_tiles+serve_sharding", dict(attn_f32=False), SERVE_RULES),
    ],
    # ------------------------------------------------------------------
    # Bonus: serve-sharding on a batch decode cell (the same fix matters
    # for every decode cell in the table)
    "olmoe_1b_7b|decode_32k": [
        ("baseline", {}, None),
        ("serve_sharding", dict(param_dtype="bfloat16"), SERVE_RULES),
        ("serve_sharding+flash_decode",
         dict(param_dtype="bfloat16", flash_decode_shards=True),
         SERVE_RULES),
    ],
}


def main():
    only = sys.argv[1:]
    out_path = Path("build/perf.json")
    results = {}
    if out_path.exists():
        results = json.loads(out_path.read_text())
    with fake_process_group():
        for cell, variants in EXPERIMENTS.items():
            if only and cell not in only:
                continue
            arch, shape = cell.split("|")
            for name, cfg_kw, rules in variants:
                key = f"{cell}|{name}"
                if key in results and "error" not in results[key]:
                    print(f"[cached] {key}")
                    continue
                print(f"[perf] {key} ...", flush=True)
                try:
                    cfg = get_config(arch).replace(use_pallas="ref",
                                                   **cfg_kw)
                    r = run_cell(arch, shape, multi_pod=False, rules=rules,
                                 cfg_override=cfg)
                    r["variant"] = name
                except Exception as e:
                    r = {"variant": name,
                         "error": f"{type(e).__name__}: {e}",
                         "traceback": traceback.format_exc()[-1500:]}
                results[key] = r
                out_path.parent.mkdir(parents=True, exist_ok=True)
                out_path.write_text(json.dumps(results, indent=1))
                if "error" in r:
                    print(f"  ERROR {r['error'][:120]}")
                elif "skipped" in r:
                    print(f"  SKIPPED: {r['skipped']}")
                else:
                    rf = r["roofline"]
                    print(f"  comp={rf['compute_s']:.4f}s "
                          f"mem={rf['memory_s']:.4f}s "
                          f"coll={rf['collective_s']:.4f}s "
                          f"bound={rf['bound']} mem/dev="
                          f"{r['memory']['per_device_total']/2**30:.1f}GiB")


if __name__ == "__main__":
    main()
