#!/usr/bin/env python3
"""What the port's spans cost while no profiler records, and what they
count per call in each one-card cell of `BENCHMARK.json`.

    python3 tools/span_costs.py [--out chiprun_out/span_costs.json]

- Off: nanoseconds of one `with tracing.span(...)`, of the check alone
  (`tracing.recording()`) and of a call of an empty function, plain and
  `traced`, the best of 5 runs of a million each, with no profiler
  session.
- Each cell (its configuration and its first object, made from seed 0
  as the benchmark makes it): one warm compress and one decompress of
  the object, each once under a profiler session (CPU activity), which
  counts the spans by name, and once under CUDA's sync debug mode,
  which counts the host syncs and names the port's line of each sync
  that does not go through `density_tpu_torch/hostsync.py` (those the
  `wait.*` spans cannot count).
Prints the card's name and power limit, a line a measurement and, last,
all of it as one JSON object (also in the `--out` file). Needs a CUDA
card; imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import timeit
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def off_ns() -> dict:
    from density_tpu_torch import tracing

    def plain():
        pass
    g = {"tracing": tracing, "plain": plain,
         "traced": tracing.traced("engine.plan")(plain)}
    n = 1_000_000
    return {stmt: min(timeit.repeat(stmt, globals=g, number=n,
                                    repeat=5)) / n * 1e9
            for stmt in ("tracing.recording()",
                         "with tracing.span('wait.read'): pass",
                         "plain()", "traced()")}


def spans_of(fn) -> dict:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return dict(collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.name().startswith("density.")))


def syncs_of(fn) -> tuple[int, list]:
    """Host syncs of one call of `fn` (CUDA's sync debug mode), and the
    port's line of each one made outside `hostsync`."""
    import torch
    torch.cuda.synchronize()
    seen, outside = [], []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            return
        seen.append(1)
        stack = traceback.extract_stack()
        if not any(f.filename.endswith("hostsync.py") for f in stack):
            outside.append(next(
                (f"{f.filename.split('density_tpu_torch')[-1]}:{f.lineno}"
                 for f in reversed(stack)
                 if "density_tpu_torch" in f.filename), "outside the port"))
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return len(seen), sorted(set(outside))


def cell_counts(name: str) -> dict:
    from portbench import objects, resolve
    from portbench.system import PortSystem
    cell = resolve.cell(name, ROOT)
    system = PortSystem(cell.config)
    objs, order = objects.make(cell.traffic, cell.config, 0, ROOT)
    data = objs[order[0]]
    blob = system.compress(data)
    if system.decompress(blob) != data:
        raise AssertionError(f"{name}: the round trip lost bytes")
    out = {}
    for half, fn in (("compress", lambda: system.compress(data)),
                     ("decompress", lambda: system.decompress(blob))):
        spans = spans_of(fn)
        syncs, outside = syncs_of(fn)
        out[half] = {"spans": sum(spans.values()), "by_name": spans,
                     "waits": sum(v for k, v in spans.items()
                                  if k.startswith("density.wait.")),
                     "syncs": syncs, "syncs_outside_hostsync": outside}
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="chiprun_out/span_costs.json")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    result = {"card": card, "torch": torch.__version__, "off_ns": off_ns()}
    for stmt, ns in result["off_ns"].items():
        print(f"off: {stmt}: {ns:.1f} ns", flush=True)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    result["cells"] = {}
    for w in bench["workloads"]:
        if w["chips"] != 1:
            continue
        got = result["cells"][w["name"]] = cell_counts(w["name"])
        for half, c in got.items():
            print(f"{w['name']} {half}: {c['spans']} spans, {c['waits']} "
                  f"waits, {c['syncs']} syncs; outside hostsync: "
                  f"{c['syncs_outside_hostsync']}; {c['by_name']}",
                  flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
