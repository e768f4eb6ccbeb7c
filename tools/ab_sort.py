#!/usr/bin/env python3
"""The port's bigsort kernel of two trees of this repository, in turns, in
one process on one GPU.

    python3 tools/ab_sort.py BEFORE_DIR [AFTER_DIR] [--out FILE]

Builds `density_tpu_torch/csrc/bigsort.cu` of each tree (AFTER_DIR: this
one by default) with this tree's flags, both `nvcc` runs started
together, and loads each build in turn in place of this tree's. At each
shape the paths sort (S=38 x 65536, S=311 x 8192, S=622 x 4096; one key
with 2 arrays and with 1) it holds both outputs against each other and
the plain network, then takes the device time and kernel launches per
sort from torch.profiler (`chip_smoke.device_profile`, 10 warm calls) in
turns: BEFORE, AFTER, AFTER, BEFORE. Prints the card's name and power
limit, one line per shape with each side's mean of its two turns, and,
last, all of it as one JSON object (also written to FILE with `--out`).
Needs one CUDA card and `nvcc`; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(38, 65536, 2), (38, 65536, 1), (311, 8192, 2), (311, 8192, 1),
          (622, 4096, 2), (622, 4096, 1)]  # (S, N, arrays)
TURNS = ("before", "after", "after", "before")


def build(tmp: str, trees: dict[str, str]) -> dict[str, str]:
    """One library of each tree's bigsort.cu; their paths by side."""
    from density_tpu_torch.kernels import _build
    jobs = {}
    for side, tree in trees.items():
        out = os.path.join(tmp, f"libbigsort-{side}.so")
        src = os.path.join(tree, "density_tpu_torch", "csrc", "bigsort.cu")
        jobs[side] = (out, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for side, (_, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for the {side} tree:\n{log}")
    return {side: out for side, (out, _) in jobs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("before")
    ap.add_argument("after", nargs="?", default=ROOT)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import chip_smoke as cs
    from density_tpu_torch.kernels import _build, bigsort
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    trees = {"before": os.path.abspath(args.before),
             "after": os.path.abspath(args.after)}
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rows = []
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = {side: ctypes.CDLL(path)
                for side, path in build(tmp, trees).items()}
        for S, N, na in SHAPES:
            arrs = cs.sort_inputs(rng, dev, S, N, na, 1, False)
            want = bigsort.sort_plain(*arrs, n_keys=1)
            runs = {side: [] for side in trees}
            for side in TURNS:
                _build._loaded["bigsort"] = libs[side]
                got = bigsort.sort(*arrs, n_keys=1)
                if cs.max_abs_err(got, want):
                    raise SystemExit(f"the {side} tree's bigsort differs from "
                                     f"the plain network at S={S} N={N}")
                runs[side].append(cs.device_profile(
                    lambda: bigsort.sort(*arrs, n_keys=1)))
            row = dict(S=S, N=N, arrays=na)
            for side, r in runs.items():
                row[side] = dict(ms=statistics.mean(ms for ms, _ in r),
                                 turns_ms=[ms for ms, _ in r],
                                 launches=r[0][1])
            row["ratio"] = row["after"]["ms"] / row["before"]["ms"]
            rows.append(row)
            print(f"S={S} N={N} 1 key {na} array(s): before "
                  f"{row['before']['ms']:.4f} ms, after "
                  f"{row['after']['ms']:.4f} ms (after/before "
                  f"{row['ratio']:.4f}); launches per sort "
                  f"{row['before']['launches']:g} / "
                  f"{row['after']['launches']:g}", flush=True)
    _build._loaded.pop("bigsort", None)
    result = {"device": smi, "trees": trees, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
