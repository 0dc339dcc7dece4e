"""Render the dry run's tables (per-device memory, FLOPs, collective bytes;
the roofline) from its JSON.

    PYTHONPATH=src python -m repro_torch.launch.report build/dryrun.json

Port of ``repro.launch.report``: ``dryrun_table`` and ``roofline_table``
print the reference's Markdown for the same dict, so either package's
``dryrun.json`` renders the same way; the titles name the meshes of H100s
the port's dry run models.  Its numbers are CPU model outputs for the
card's peaks (:mod:`repro_torch.launch.dryrun`), not times on a card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

from repro_torch.configs.base import SHAPES, list_archs


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def dryrun_table(results: dict, mesh: str) -> str:
    lines = [
        "| arch | shape | mem/dev GiB | HLO GFLOPs/dev | coll MB/dev | "
        "compile s |",
        "|---|---|---:|---:|---:|---:|",
    ]
    for arch in list_archs():
        for shape in SHAPES:
            key = f"{arch}|{shape}|{mesh}"
            r = results.get(key)
            if r is None:
                lines.append(f"| {arch} | {shape} | — | — | — | (missing) |")
            elif "skipped" in r:
                lines.append(f"| {arch} | {shape} | skip | skip | skip | "
                             "long_500k needs sub-quadratic |")
            elif "error" in r:
                lines.append(f"| {arch} | {shape} | ERR | | | "
                             f"{r['error'][:40]} |")
            else:
                m = r["memory"]["per_device_total"]
                h = r["hlo"]
                lines.append(
                    f"| {arch} | {shape} | {fmt_bytes(m)} | "
                    f"{h['flops']/1e9:.1f} | "
                    f"{h['coll_bytes_effective']/1e6:.1f} | "
                    f"{r['timings']['compile_s']:.0f} |")
    return "\n".join(lines)


def roofline_table(results: dict) -> str:
    lines = [
        "| arch | shape | compute s | memory s | collective s | bound | "
        "MODEL_FLOPS | useful | roofline frac |",
        "|---|---|---:|---:|---:|---|---:|---:|---:|",
    ]
    for arch in list_archs():
        for shape in SHAPES:
            r = results.get(f"{arch}|{shape}|single")
            if not r or "roofline" not in r:
                continue
            rf = r["roofline"]
            lines.append(
                f"| {arch} | {shape} | {rf['compute_s']:.4f} | "
                f"{rf['memory_s']:.4f} | {rf['collective_s']:.4f} | "
                f"**{rf['bound']}** | {rf['model_flops']:.3e} | "
                f"{rf['useful_flops_fraction']:.2f} | "
                f"{rf['roofline_fraction']:.4f} |")
    return "\n".join(lines)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "build/dryrun.json"
    results = json.loads(Path(path).read_text())
    print("## Dry-run — single-pod mesh (16x16 = 256 H100s)\n")
    print(dryrun_table(results, "single"))
    print("\n## Dry-run — multi-pod mesh (2x16x16 = 512 H100s)\n")
    print(dryrun_table(results, "multi"))
    print("\n## Roofline (16x16 H100s, per device)\n")
    print(roofline_table(results))


if __name__ == "__main__":
    main()
