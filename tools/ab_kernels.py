#!/usr/bin/env python3
"""The port's packroute and unpack kernels of two trees of this
repository, in turns, in one process on one GPU.

    python3 tools/ab_kernels.py BEFORE_DIR [AFTER_DIR] [--out FILE]

Builds `density_tpu_torch/csrc/{packroute,unpack}.cu` of each tree
(AFTER_DIR: this one by default) with this tree's flags, all `nvcc` runs
started together, and loads each tree's wrapper module
(`density_tpu_torch/kernels/{packroute,unpack}.py`) on its own build, so
that each side is called as its own tree calls it. At each shape -- the
main path's (the corpus in 256 KiB streams: packroute S=38 x 65536,
unpack S=38 x 1024 blocks), the 32 KiB decode's, packroute at the three
geometries at 2^18 quads and on one 2^23-quad stream -- it holds both
outputs against the plain version, then takes the device time (the sum
of the card's own events: kernels and memsets) and the kernel launches
per call from torch.profiler (`chip_smoke.device_profile`, 10 warm
calls) in turns: BEFORE, AFTER, AFTER, BEFORE. Prints the card's name
and power limit, one line per shape with each side's mean of its two
turns, and, last, all of it as one JSON object (also written to FILE
with `--out`). Needs one CUDA card and `nvcc`; imports no JAX.
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
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("packroute", "unpack")
TURNS = ("before", "after", "after", "before")


def build(tmp: str, trees: dict[str, str]) -> dict[tuple[str, str], str]:
    """One library of each tree's kernel sources; their paths by (side,
    kernel)."""
    from density_tpu_torch.kernels import _build
    jobs = {}
    for side, tree in trees.items():
        for name in KERNELS:
            out = os.path.join(tmp, f"lib{name}-{side}.so")
            src = os.path.join(tree, "density_tpu_torch", "csrc",
                               f"{name}.cu")
            jobs[side, name] = (out, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for key, (_, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
    return {key: out for key, (out, _) in jobs.items()}


def wrapper(tree: str, name: str, lib: ctypes.CDLL):
    """Tree `tree`'s wrapper module of kernel `name`, calling `lib`."""
    from density_tpu_torch.kernels import _build
    path = os.path.join(tree, "density_tpu_torch", "kernels", f"{name}.py")
    mod = types.ModuleType(f"ab_{name}_{abs(hash(tree))}")
    mod.__file__ = path
    with open(path) as f:
        exec(compile(f.read(), path, "exec"), mod.__dict__)

    def function(lib_name, fn_name, n_args, int_args):
        fn = getattr(lib, fn_name)
        fn.argtypes = [ctypes.c_int if i in int_args else ctypes.c_void_p
                       for i in range(n_args)]
        fn.restype = ctypes.c_int
        return fn

    mod._build = types.SimpleNamespace(
        function=function, ptr=_build.ptr, stream_ptr=_build.stream_ptr,
        check=_build.check)
    return mod


def cases(dev):
    """(kernel, label, call(module), plain result) at each shape."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from density_tpu_torch.kernels import packroute, unpack
    data = cs.corpus_bytes()
    out = []
    main = cs.path_inputs(dev, data)
    small = cs.path_inputs(dev, data, cs.SMALL_STREAMS[0])
    pack_in = main[2]
    out.append(("packroute", f"S={pack_in[0].shape[0]} "
                f"N={pack_in[0].shape[1]} chameleon (main path)",
                lambda m: m.pack(*pack_in, **cs.CHAM),
                packroute.pack_plain(*pack_in, **cs.CHAM)))
    rng = np.random.default_rng(0)
    for (q, sw, fb), S, N in (((64, 4, 1), 8, 1 << 18),
                              ((32, 4, 2), 8, 1 << 18),
                              ((16, 3, 3), 8, 1 << 18),
                              ((64, 4, 1), 1, 1 << 23)):
        nb = np.full(S, 4 * N, np.int32)
        nb[S // 2:] -= 4 * q * 3 + 1
        toks = [x.to(dev) for x in cs.geometry_tokens(rng, S, N, q, fb, nb)]
        toks.append(torch.from_numpy(nb).to(dev))
        kw = dict(q=q, sig_words=sw, block=4 * q, flag_bits=fb)
        out.append(("packroute", f"S={S} N={N} q={q} flag_bits={fb}",
                    lambda m, t=toks, k=kw: m.pack(*t, **k),
                    packroute.pack_plain(*toks, **kw)))
    ukw = dict(q=64, sig_words=4, flag_bits=1)
    for label, inputs in (("main path", main), ("32 KiB streams", small)):
        words, woff, is_copy, nb_real, _ = inputs[3]
        live = (torch.arange(woff.shape[1], device=dev)[None, :]
                < nb_real[:, None])
        woff_k = torch.where(live, woff, -1)
        out.append(("unpack", f"S={words.shape[0]} W={words.shape[1]} "
                    f"NB={woff.shape[1]} ({label})",
                    lambda m, a=(words, woff_k, is_copy): m.unpack(*a, **ukw),
                    unpack.unpack_plain(words, woff_k, is_copy, **ukw)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("before")
    ap.add_argument("after", nargs="?", default=ROOT)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    from density_tpu_torch.kernels import _build
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
    rows = []
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build(tmp, trees)
        mods = {key: wrapper(trees[key[0]], key[1], ctypes.CDLL(path))
                for key, path in libs.items()}
        for name, label, call, want in cases(dev):
            runs = {side: [] for side in trees}
            for side in TURNS:
                m = mods[side, name]
                if cs.max_abs_err(call(m), want):
                    raise SystemExit(f"the {side} tree's {name} differs from "
                                     f"its plain version at {label}")
                runs[side].append(cs.device_profile(lambda: call(m)))
            row = dict(kernel=name, shape=label)
            for side, r in runs.items():
                row[side] = dict(ms=statistics.mean(ms for ms, _ in r),
                                 turns_ms=[ms for ms, _ in r],
                                 launches=r[0][1])
            row["ratio"] = row["after"]["ms"] / row["before"]["ms"]
            rows.append(row)
            print(f"{name} {label}: before {row['before']['ms']:.4f} ms, "
                  f"after {row['after']['ms']:.4f} ms (after/before "
                  f"{row['ratio']:.4f}); kernel launches per call "
                  f"{row['before']['launches']:g} / "
                  f"{row['after']['launches']:g}", flush=True)
    result = {"device": smi, "trees": trees, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
