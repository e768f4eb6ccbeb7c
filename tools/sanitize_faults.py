#!/usr/bin/env python3
"""Phase (x) of `chip_smoke.py` under NVIDIA's compute-sanitizer.

    python3 tools/sanitize_faults.py [--out DIR] [--tools memcheck racecheck]
                                     [--seeds N] [--timeout SECONDS]

Builds the kernels and the native runtime (`chip_smoke.phase_build`),
then runs phase (x)'s card work (`chip_smoke.fault_worker`: zero-stream
headers, the seeded container mutations on the card against the CPU
path, the adversarial FSM encodes under both sort options, the golden
vectors) once under each tool, each run a process of its own killed
after `--timeout` seconds, its report in `DIR/sanitizer-<tool>.txt`.
`--seeds` cuts the mutated inputs a codec (8 by default, as phase x).

Prints, for each tool, the launches of each kernel in that run and the
errors the tool reports in each kernel's code (by the kernel's library
in the host backtrace, or by its function name), errors in other
kernels (PyTorch's) apart; or that the tool is not on the machine, or
did not run. Exits 0 when every tool ran to its end and reported no
error.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

# __global__ functions by kernel module (`density_tpu_torch/csrc/`; the
# sort levels are in both sorts' libraries)
FUNCTIONS = {"tile_kernel": ("bigsort", "bitonic"),
             "global_kernel": ("bigsort", "bitonic"),
             "cluster_kernel": ("bitonic",),
             "pack_kernel": ("pack",),
             "packroute_kernel": ("packroute",),
             "unpack_kernel": ("unpack",)}
WORKER = """
import os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke
chip_smoke.fault_worker(seeds={seeds})
"""


def sanitizer() -> str | None:
    for cand in (shutil.which("compute-sanitizer"),
                 "/usr/local/cuda/bin/compute-sanitizer"):
        if cand and os.path.exists(cand):
            return cand
    return None


def records(report: str) -> list[str]:
    """The tool's messages: a line `========= X` opens one, indented
    `=========     ` lines continue it."""
    out = []
    for line in report.splitlines():
        if not line.startswith("========="):
            continue
        body = line[len("========="):]
        if body.startswith("     ") and out:
            out[-1] += "\n" + body.strip()
        elif body.strip():
            out.append(body.strip())
    return out


def attribute(record: str) -> tuple:
    """The kernel modules a message names: by library, else by function."""
    libs = tuple(sorted(set(re.findall(r"lib(bigsort|bitonic|packroute|"
                                       r"unpack|pack)-[0-9a-f]+\.so",
                                       record))))
    if libs:
        return libs
    for fn, mods in FUNCTIONS.items():
        if re.search(rf"\b{fn}\b", record):
            return mods
    return ("other",)


def run_tool(tool: str, exe: str, out_dir: str, seeds: int,
             timeout: int) -> dict:
    log_path = os.path.join(out_dir, f"sanitizer-{tool}.txt")
    cmd = [exe, "--tool", tool, "--log-file", log_path,
           sys.executable, "-c", WORKER.format(seeds=seeds)]
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"tool": tool, "ran": False,
                "why": f"killed after {timeout} s"}
    report = records(open(log_path).read()) if os.path.exists(
        log_path) else []
    lines = p.stdout.strip().splitlines()
    try:
        worker = json.loads(lines[-1]) if lines else None
    except ValueError:
        worker = None
    if worker is None:  # the phase did not run to its end under the tool
        return {"tool": tool, "ran": False, "rc": p.returncode,
                "why": [r.splitlines()[0] for r in report
                        if r.startswith("Error")] or p.stderr[-2000:]}
    errors: dict = {}
    for r in report:
        if "SUMMARY" in r or not re.search(
                r"Invalid|Error|error|Race|race|hazard|Hazard|Program hit",
                r):
            continue
        for mod in attribute(r):
            errors[mod] = errors.get(mod, 0) + 1
    return {"tool": tool, "ran": True, "rc": p.returncode,
            "summary": [r for r in report if "SUMMARY" in r],
            "errors": errors, "launches": worker["launches"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="sanitizer_out")
    ap.add_argument("--tools", nargs="+", default=["memcheck", "racecheck"])
    ap.add_argument("--seeds", type=int, default=chip_smoke.FAULT_SEEDS)
    ap.add_argument("--timeout", type=int, default=1200)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    exe = sanitizer()
    if exe is None:
        print(json.dumps({"sanitizer": None,
                          "why": "compute-sanitizer is not on the machine"}))
        return 1
    version = subprocess.run([exe, "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()
    print(f"{exe}: {version[-1] if version else 'no version'}", flush=True)
    chip_smoke.OUT_DIR = args.out
    chip_smoke.phase_build()
    ok = True
    for tool in args.tools:
        r = run_tool(tool, exe, args.out, args.seeds, args.timeout)
        print(json.dumps(r), flush=True)
        ok = ok and r["ran"] and not r["errors"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
