#!/usr/bin/env python3
"""The port's bigsort kernel at each tile for rows above 16384, on one GPU.

    python3 tools/sort_tiles.py [--out FILE]

A row longer than 16384 elements is sorted in tiles whose size is fixed
when the kernel is built (`BIGSORT_LOG_TILE` in
`density_tpu_torch/csrc/bigsort.cu`: 8192 unless set). This diagnostic
builds the source once for each tile of 4096, 8192 and 16384, all
`nvcc` runs started together, loads each build in place of the default
one, holds its output against the plain network and times it at
N = 65536 with one key: 2 arrays (the forward sort of the encode, the
decode's sorts) at S = 1, 8, 33 and 38 (the main path's 256 KiB
streams), and 1 array (the unsort) at S = 38. Device time and kernel
launches per sort come from torch.profiler (`chip_smoke.device_profile`,
10 warm calls). Prints the card's name and power limit, one line per
shape and tile, and, last, all of it as one JSON object (also written to
FILE with `--out`). Needs one CUDA card and `nvcc`; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG_TILES = (12, 13, 14)
SHAPES = [(1, 2), (8, 2), (33, 2), (38, 2), (38, 1)]  # (S, arrays)
N = 65536


def build(tmp: str) -> dict[int, str]:
    """One library of bigsort.cu per tile; their paths by log2 tile."""
    from density_tpu_torch.kernels import _build
    src = str(_build.SRC_DIR / "bigsort.cu")
    jobs = {}
    for lt in LOG_TILES:
        out = os.path.join(tmp, f"libbigsort-tile{lt}.so")
        jobs[lt] = (out, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS,
             f"-DBIGSORT_LOG_TILE={lt}", "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for lt, (_, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed at BIGSORT_LOG_TILE={lt}:\n{log}")
    return {lt: out for lt, (out, _) in jobs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    inputs = {(S, na): cs.sort_inputs(rng, dev, S, N, na, 1, True)
              for S, na in SHAPES}
    rows = []
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build(tmp)
        for (S, na), arrs in inputs.items():
            want = bigsort.sort_plain(*arrs, n_keys=1)
            for lt, path in libs.items():
                _build._loaded["bigsort"] = ctypes.CDLL(path)
                got = bigsort.sort(*arrs, n_keys=1)
                if cs.max_abs_err(got, want):
                    raise SystemExit(f"tile {1 << lt} differs from the plain "
                                     f"network at S={S} arrays={na}")
                ms, n = cs.device_profile(
                    lambda: bigsort.sort(*arrs, n_keys=1))
                rows.append(dict(S=S, N=N, arrays=na, tile=1 << lt, ms=ms,
                                 launches=n))
                print(f"S={S} N={N} 1 key {na} array(s), tile {1 << lt}: "
                      f"device {ms:.4f} ms, {n:g} kernel launches per sort",
                      flush=True)
    _build._loaded.pop("bigsort", None)
    result = {"device": smi, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
