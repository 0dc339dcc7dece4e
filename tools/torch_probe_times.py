#!/usr/bin/env python3
"""Time the PyTorch port's two probe kernels on one NVIDIA GPU.

    python3 tools/torch_probe_times.py [--src DIR] [--seed 0]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``), so a
second checkout (say, a parent commit unpacked with ``git archive``) can be
timed with the same inputs and the same timers: ``chip_smoke.py``'s
``probe_inputs`` (S 16,384 sets x 4 ways, 262,144 keys, a skewed wavefront
of 65,536 keys over 8 sets) and ``probe_times`` (eager ms, CUDA-graph device
ms, host us a call, the one-key floor).  Run the two trees in turns, each in
its own process, in one session on one card.  Prints the card's name and
power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("torch_probe_times: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch

    if pathlib.Path(repro_torch.__file__).resolve().parents[1] != src:
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}, "
                           f"not {src}")
    dev = torch.device("cuda")
    d, keys, skew, _ = chip_smoke.probe_inputs(dev, args.seed)
    times = chip_smoke.probe_times(d, keys, skew)
    print(chip_smoke.nvidia_smi())
    print(json.dumps(dict(src=str(src), device=torch.cuda.get_device_name(0),
                          **times)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
