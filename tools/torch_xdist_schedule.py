#!/usr/bin/env python3
"""Replay how pytest-xdist's ``--dist loadfile`` hands the test files to its
workers, from the per-test times of a junit file, to see which file sets
the suite's wall.

    python3 tools/torch_xdist_schedule.py JUNIT.xml [JUNIT.xml ...]
        [--workers 6] [--scale FILE=JUNIT.xml:FACTOR ...]

The rule replayed is xdist's ``LoadScopeScheduling`` with its default
``--loadscope-reorder``: the files are queued by their test count, most
first (collection order among equal counts); each worker takes one file
at the start and then the next one in the queue whenever its pending tests
fall to 2 or fewer.  Each test takes its junit time; worker start-up and
collection are left out, so the replayed wall is shorter than the real
one by about a minute.  For each junit file it prints each worker's files
with the time it took them, when ``tests/test_oracle.py`` starts and the
replayed wall.  ``--scale FILE=OTHER.xml:FACTOR`` replaces FILE's tests
(for example ``tests.test_torch_core``) by those of OTHER.xml divided by
FACTOR, to replay one tree's files at another run's speed.
"""
from __future__ import annotations

import argparse
import collections
import xml.etree.ElementTree as ET


def load(path: str) -> dict:
    """File (``tests.test_x``) -> its tests' times, in junit order."""
    out = collections.OrderedDict()
    for tc in ET.parse(path).iter("testcase"):
        f = ".".join(tc.get("classname").split(".")[:2])
        out.setdefault(f, []).append(float(tc.get("time")))
    return out


def replay(files: dict, workers: int) -> list:
    """Each worker's ``(clock, [(file, start), ...])`` at the end."""
    queue = sorted(sorted(files), key=lambda f: -len(files[f]))
    state = [{"t": 0.0, "pending": [], "log": []} for _ in range(workers)]

    def take(w):
        f = queue.pop(0)
        w["pending"] += files[f]
        w["log"].append((f, w["t"]))

    for w in state:
        if queue:
            take(w)
    for w in state:
        if queue and len(w["pending"]) <= 2:
            take(w)
    while any(w["pending"] for w in state):
        w = min((w for w in state if w["pending"]), key=lambda w: w["t"])
        w["t"] += w["pending"].pop(0)
        if queue and len(w["pending"]) <= 2:
            take(w)
    return [(w["t"], w["log"]) for w in state]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("junit", nargs="+")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--scale", action="append", default=[])
    args = ap.parse_args()
    for path in args.junit:
        files = load(path)
        for spec in args.scale:
            name, rest = spec.split("=")
            other, factor = rest.rsplit(":", 1)
            files[name] = [x / float(factor) for x in load(other)[name]]
        result = replay(files, args.workers)
        print(f"{path}:")
        for i, (t, log) in enumerate(result):
            print(f"  worker {i} ends at {t:.1f} s: "
                  + ", ".join(f"{f.split('.')[-1]} from {s:.1f}"
                              for f, s in log))
        start = [s for _, log in result for f, s in log
                 if f.endswith("test_oracle")]
        print(f"  test_oracle starts at {start[0]:.1f} s" if start else
              "  no test_oracle", f"; replayed wall {max(t for t, _ in result):.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
