"""One run of one cell: set-up, the window, the check, the result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Set-up (`setup_s`, from the harness's first statement to the first timed
request) imports the program, loads its kernels and native runtime
(built on the first run of a checkout, under the program's own
`density_tpu_torch/build/`), makes the objects from the seed and sends
one compress and one decompress of each distinct object size, so every
shape the window uses is warm. Then the window (`window.py`); with
`--trace 1` under the profiler (`trace.py`) and at most
`TRACED_SECONDS` long, then the probes of the per-layer metrics that
have one, in the same profiler session, and the per-layer readers
(`metrics/<name>.py`). Then the check (`check.py`) and the
result: earlier lines on standard output (the card and its power limit,
the ratio, notes), each number compared beside its limit as the last
lines on standard error, and one JSON object as the last line of
standard output. No result is printed where JAX or the JAX package is
loaded, looked for once the window has closed and again just before
the result line, after the readers and the check have run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from portbench import check, objects as objects_mod, resolve, window
from portbench.trace import Trace, Tracer

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that may not be loaded in a run: JAX and the
# JAX package the program was ported from ("density_tpu_torch" is not
# "density_tpu": names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "density_tpu")
# the port's hand-written kernels: their modules' launch counters, and
# the kernel names their launches take in a trace
KERNEL_MODULES = ("bigsort", "bitonic", "pack", "packroute", "unpack")
KERNEL_NAMES = ("tile_kernel", "global_kernel", "cluster_kernel",
                "packroute_kernel", "pack_kernel", "unpack_kernel")
# the traced run's window: long enough for every per-layer reading,
# short enough that the trace is reduced well inside a run's time limit
TRACED_SECONDS = 20.0


def log(*parts) -> None:
    print(*parts, flush=True)


@dataclass
class Context:
    """What a per-layer reader (`read(ctx)`) reads, and its probe
    (`probe(ctx, tracer)`, run in the traced session after the window)."""
    cell: resolve.Cell
    system: object
    objects: list
    order: list
    cards: list
    halves: dict = field(default_factory=dict)
    trace: Trace | None = None
    card_line: str = ""
    probed: dict = field(default_factory=dict)  # what probes leave to read
    log: object = log


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def launch_counts() -> dict:
    from importlib import import_module
    return {k: import_module(f"density_tpu_torch.kernels.{k}").launches
            for k in KERNEL_MODULES}


def card_line(cards: list[int]) -> str:
    """The cards' names and power limits, as `nvidia-smi` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    rows = [r for r in out if r.split(",")[0].strip() in map(str, cards)]
    return "; ".join(rows) or "nvidia-smi listed no card"


def warm(system, objs: list) -> None:
    """One compress and one decompress of each distinct object size."""
    seen = set()
    for obj in objs:
        if len(obj) not in seen:
            seen.add(len(obj))
            if system.decompress(system.compress(obj)) != obj:
                raise RuntimeError("the warm-up round trip lost bytes")


@dataclass
class Measured:
    context: Context
    setup_s: float
    containers: list
    outputs: list
    numbers: dict = field(default_factory=dict)


def measure(cell: resolve.Cell, seed: int, seconds: float, traced: bool,
            t_start: float, device=None) -> Measured:
    """Set-up, the window and the check; `device` overrides the
    configuration's devices (the CPU tests pass "cpu")."""
    from portbench.system import PortSystem
    system = PortSystem(cell.config, device)
    system.prepare()
    objs, order = objects_mod.make(cell.traffic, cell.config, seed, ROOT)
    warm(system, objs)
    cards = system.cuda_indices()
    if cards:
        import torch
        for c in cards:
            torch.cuda.synchronize(c)
    setup_s = time.perf_counter() - t_start
    ctx = Context(cell=cell, system=system, objects=objs, order=order,
                  cards=cards)
    rng = np.random.default_rng([seed, 1])
    counts0 = launch_counts()
    if traced and seconds > TRACED_SECONDS:
        log(f"note: the traced window is {TRACED_SECONDS} s of the "
            f"run's {seconds}")
        seconds = TRACED_SECONDS
    with Tracer(traced) as tracer:
        comp, decomp, containers, outputs = window.run(
            system, objs, order, seconds,
            int(cell.traffic["check"]["outputs"]), rng, tracer)
        counts1 = launch_counts()
        if traced:
            # a metric's probe, if it has one, runs in the same session
            for metric in cell.per_layer:
                probe = getattr(resolve.module("metrics", metric.name, ROOT),
                                "probe", None)
                if probe is not None:
                    probe(ctx, tracer)
    ctx.halves = {"compress": comp, "decompress": decomp}
    if traced:
        ctx.trace = Trace(tracer.events(), cards)
        counted = sum(counts1[k] - counts0[k] for k in counts0)
        lo, hi = ctx.trace.window()
        seen = ctx.trace.kernels_named(KERNEL_NAMES, lo, hi)
        if seen < counted:
            log(f"note: the trace holds {seen} events of the port's kernels "
                f"and its launch counters count {counted} launches: the "
                "profiler dropped events")
    return Measured(context=ctx, setup_s=setup_s, containers=containers,
                    outputs=outputs)


def judge(m: Measured, seed: int) -> None:
    cfg, ctx = m.context.cell.config, m.context
    failed = sum(h.failed for h in ctx.halves.values())
    m.numbers = check.judge(
        ctx.objects, m.containers, m.outputs, failed, cfg["codec"],
        int(cfg["stream_size"]), ctx.cell.traffic["check"],
        np.random.default_rng([seed, 2]))


def end_to_end(m: Measured) -> dict:
    comp, decomp = m.context.halves["compress"], m.context.halves["decompress"]
    values = {"setup_s": m.setup_s}
    if comp.seconds:
        values["compress_GBps"] = comp.gbps()
    if decomp.seconds:
        values["decompress_GBps"] = decomp.gbps()
    for half in (comp, decomp):
        if half.calls:
            values[f"{half.name}_p95_ms"] = half.p95_ms()
    return values


def ratio_line(m: Measured) -> str:
    first = {}
    for obj, blob in m.containers:
        if blob is not None and obj not in first:
            first[obj] = len(blob)
    raw = sum(len(m.context.objects[o]) for o in first)
    packed = sum(first.values())
    return (f"ratio: {raw / packed:.4f} ({raw} bytes of {len(first)} objects "
            f"in {packed} bytes of containers)" if packed else
            "ratio: no container was made")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cards_or_exit(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: the benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        sys.exit(f"the cell needs {chips} cards, the host has "
                 f"{torch.cuda.device_count()}")


def loaded_forbidden() -> bool:
    """True, naming them on standard error, where JAX or the JAX package
    is loaded in this process."""
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the run may not load: {found}",
              file=sys.stderr, flush=True)
    return bool(found)


def device_info(ctx: Context, traced: bool) -> dict:
    """The result's `device`: the cards, the fullest card's memory peak
    and, traced, the device's busy seconds and the window's length."""
    import torch
    peak = max(torch.cuda.max_memory_allocated(c) for c in ctx.cards)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(
        ctx.cards[0]), "count": len(ctx.cards), "memory_peak_bytes": peak}
    if traced:
        lo, hi = ctx.trace.window()
        device["busy_s"] = float(np.mean(
            [ctx.trace.busy_s(c, lo, hi) for c in ctx.cards]))
        device["window_s"] = (hi - lo) / 1e9
    ctx.card_line = card_line(ctx.cards)
    log(f"cards: {ctx.card_line}")
    return device


def finish(m: Measured, traced: bool, seed: int, device: dict) -> int:
    """The metrics (traced: the per-layer readers), the check and the
    result line, which is printed only where nothing forbidden was
    loaded by then. Returns the exit code."""
    ctx = m.context
    out = {}
    breakdown = None
    if traced:
        for metric in ctx.cell.per_layer:
            value = resolve.reader(metric.name, ROOT)(ctx)
            if value is not None:
                out[metric.name] = {"value": float(value),
                                    "unit": metric.unit}
        if ctx.trace is not None:
            breakdown = {"device_ops": ctx.trace.device_ops(),
                         "idle_gaps": ctx.trace.idle_gaps()}
    else:
        values = end_to_end(m)
        for metric in ctx.cell.end_to_end:
            if metric.name in values:
                out[metric.name] = {"value": float(values[metric.name]),
                                    "unit": metric.unit}
    t = time.perf_counter()
    judge(m, seed)
    log(f"check: {time.perf_counter() - t:.3f} s after the window")
    log(ratio_line(m))
    for half in ctx.halves.values():
        lat = np.asarray(half.latencies or [0.0]) * 1e3
        log(f"{half.name}: {half.calls} calls, {half.nbytes} bytes in "
            f"{half.seconds:.4f} s, {half.failed} failed; latency ms min "
            f"{lat.min():.3f} median {np.median(lat):.3f} p95 "
            f"{np.percentile(lat, 95):.3f} max {lat.max():.3f}"
            + (f" (first error: {half.errors[0]})" if half.errors else ""))
    ok = check.correct(m.numbers)
    compared = {k: {"value": v, "limit": lim}
                for k, (v, lim) in m.numbers.items()}
    for k, (v, lim) in m.numbers.items():
        print(f"{k} {v} limit {lim}", file=sys.stderr, flush=True)
    result = {"correct": ok,
              "attempted": sum(h.calls for h in ctx.halves.values()),
              "failed": m.numbers["failed"][0], "metrics": out,
              "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    if loaded_forbidden():
        return 3
    print(json.dumps(result), flush=True)
    return 0


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = resolve.cell(args.workload, ROOT)
    cards_or_exit(cell.chips)
    m = measure(cell, args.seed, args.seconds, bool(args.trace), t_start)
    if loaded_forbidden():
        return 3
    device = device_info(m.context, bool(args.trace))
    return finish(m, bool(args.trace), args.seed, device)
