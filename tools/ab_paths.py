#!/usr/bin/env python3
"""Device-resident encode and decode of two trees of this repository, in
turns, on one GPU.

    python3 tools/ab_paths.py BEFORE_DIR AFTER_DIR [--windows 2] [--out FILE]

Each turn (BEFORE, AFTER, AFTER, BEFORE) is a fresh process in that
tree: it builds the tree's kernels, stages the corpus in 256 KiB and
32 KiB streams on the card with the tree's own `chip_smoke.path_inputs`,
and times the device-resident encode (`layout.run_encode`) and decode
(`sharding.decode_batch`) after a warm call: `--windows` windows of 10
calls each with CUDA events (the tree's `chip_smoke.timed_ms`), and the
device time per call from the profiler (`chip_smoke.device_ms`, 5
calls). Prints the card's name and power limit, each side's median and
range of windows and mean device time per path, and, last, all of it as
one JSON object (also written to FILE with `--out`). Needs one CUDA card;
imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

STREAMS = (256 << 10, 32 << 10)


def worker(windows: int) -> None:
    """One turn, run from the root of a tree: its timings as JSON."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from density_tpu_torch.codecs import chameleon
    from density_tpu_torch.engine import layout
    from density_tpu_torch.kernels import _build
    from density_tpu_torch.parallel import sharding
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    _build.build()
    dev = torch.device("cuda")
    data = cs.corpus_bytes()
    out = {}
    for stream in STREAMS:
        quads, nbytes, _, dargs, _ = cs.path_inputs(dev, data, stream)
        fns = {"encode": lambda: layout.run_encode(chameleon.PIPELINE, quads,
                                                   nbytes),
               "decode": lambda: sharding.decode_batch(*dargs)}
        for what, fn in fns.items():
            out[f"{what} {stream >> 10} KiB"] = dict(
                windows=[cs.timed_ms(fn) for _ in range(windows)],
                device=cs.device_ms(fn, iters=5))
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("before")
    ap.add_argument("after", nargs="?")
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--out")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.windows)
        return 0
    if args.after is None:
        ap.error("needs BEFORE_DIR and AFTER_DIR")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    trees = {"before": os.path.abspath(args.before),
             "after": os.path.abspath(args.after)}
    runs = {side: {} for side in trees}
    for side in ("before", "after", "after", "before"):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), trees[side],
             "--worker", "--windows", str(args.windows)],
            cwd=trees[side], capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"the {side} turn failed ({proc.returncode})")
        for path, r in json.loads(proc.stdout.strip().splitlines()[-1]
                                  ).items():
            acc = runs[side].setdefault(path, dict(windows=[], device=[]))
            acc["windows"] += r["windows"]
            acc["device"].append(r["device"])
    summary = {}
    for path in runs["before"]:
        for side in trees:
            w = sorted(runs[side][path]["windows"])
            dev = statistics.mean(runs[side][path]["device"])
            summary.setdefault(path, {})[side] = dict(
                median_ms=statistics.median(w), min_ms=w[0], max_ms=w[-1],
                windows=len(w), device_ms=dev)
            print(f"{path}, {side}: median {statistics.median(w):.3f} ms "
                  f"(range {w[0]:.3f}-{w[-1]:.3f}, {len(w)} windows of 10 "
                  f"calls, in turns), device {dev:.4f} ms per call",
                  flush=True)
    result = {"device": smi, "trees": trees, "paths": summary}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
