#!/usr/bin/env python3
"""Where the time of the shares goes: the shares' workers against other
ways to run the same shares, on one GPU or on several.

    python3 tools/share_costs.py [--turns N] [--no-traces] [--only-cards]
                                 [--out DIR]

Device lists: the first card named twice and four times and, where there
are several cards, the first two and every card (what `compress(data)`
takes by default); `--only-cards` keeps the lists of distinct cards.
For each codec and list, after one untimed pass over the variants, in
turns (the variants in order, then backwards, N times), the host wall
of:
  - compress of the corpus of `chip_smoke.py` (10,192,446 bytes of
    Python stdlib source) in 256 KiB streams, on the first card alone
    and over the list: by the shares' workers with their host turns (the
    package's path); by the same tasks run in turn in the caller's
    thread (`in_one_thread`); by workers without host turns
    (`without_turns`); and by the workers copying onto the card through
    pinned memory without blocking (`pinned_copies`);
  - decompress of the one-card container (chameleon) or, for cheetah
    and lion, of phase (l)'s seeded input, which takes the device route,
    the same ways.
Every container and every round trip must equal the one-card ones.
Unless `--no-traces`, one traced compress for each codec and list: the
device time that the profiler sees, summed over the cards, against the
wall (the tables go to DIR/profile_shares_*.txt; a session that sees no
device time is reported as not measured). Last, the host cost of one
small op (an in-place add of a one-element tensor on the first card)
from 1, 2 and 4 threads at once, each on a CUDA stream of its own; and
the host wall of one `mesh.run_shares` call over 2 and 4 tasks of one
such op and one host read each, against the same tasks in one thread.
Prints the cards' names and power limits, a line for each measurement
and, last, all of it as one JSON object (also in DIR/share_costs.json).
Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

CODECS = ("chameleon", "cheetah", "lion")
OPS = 20000  # small ops a thread in the host-cost measurement
CALLS = 200  # calls of `mesh.run_shares` in the fixed-cost measurement


@contextlib.contextmanager
def in_one_thread():
    """The shares' tasks run in turn in the caller's thread, each share
    on its card's current stream, as before the shares had workers."""
    from density_tpu_torch.parallel import sharding
    run = sharding.run_shares
    sharding.run_shares = lambda devs, tasks: [fn() for _, fn in tasks]
    try:
        yield
    finally:
        sharding.run_shares = run


@contextlib.contextmanager
def without_turns():
    """Workers that take no turn at the host: every worker runs Python
    whenever the interpreter lets it."""
    from density_tpu_torch import hostsync
    turn = hostsync.turn
    hostsync.turn = contextlib.nullcontext
    try:
        yield
    finally:
        hostsync.turn = turn


@contextlib.contextmanager
def pinned_copies():
    """Every copy of a host array onto a card through pinned memory, on
    the current stream, without blocking the host."""
    import torch
    from density_tpu_torch.engine import layout
    from density_tpu_torch.parallel import sharding

    def to_card(a, device):
        host = torch.from_numpy(a)
        if torch.device(device).type != "cuda":
            return host.to(device)
        return host.pin_memory().to(device, non_blocking=True)
    saved = layout.to_card, sharding.to_card
    layout.to_card = sharding.to_card = to_card
    try:
        yield
    finally:
        layout.to_card, sharding.to_card = saved


VARIANTS = {"one card": None, "workers": (), "one thread": (in_one_thread,),
            "plain workers": (without_turns,),
            "pinned copies": (pinned_copies,)}


def device_lists(only_cards: bool = False) -> dict:
    import torch
    dev = torch.device("cuda", 0)
    lists = {} if only_cards else {"cuda:0 x2": [dev] * 2,
                                   "cuda:0 x4": [dev] * 4}
    n = torch.cuda.device_count()
    if n > 1:
        lists["2 cards"] = [torch.device("cuda", i) for i in range(2)]
    if n > 2:
        lists[f"{n} cards"] = [torch.device("cuda", i) for i in range(n)]
    return lists


def walls(codec: str, data: bytes, dec_blob: bytes, dec_data: bytes,
          devs: list, turns: int) -> dict:
    """Compress and decompress walls of each variant, in turns; every
    container and round trip checked."""
    import torch
    from density_tpu_torch import container
    one = [torch.device("cuda", 0)]
    want = container.compress(data, codec, cs.STREAM, device=one)
    out = {what: {"compress": [], "decompress": []} for what in VARIANTS}
    # one untimed pass first: the first call on a card, or on a worker's
    # stream, makes its context and its allocator's pool
    for i, what in enumerate(
            [*VARIANTS, *[*VARIANTS, *reversed(VARIANTS)] * turns]):
        with contextlib.ExitStack() as stack:
            for ctx in VARIANTS[what] or ():
                stack.enter_context(ctx())
            on = one if VARIANTS[what] is None else devs
            got = []
            ms = cs.wall_ms(lambda: got.append(
                container.compress(data, codec, cs.STREAM, device=on)))
            back = []
            dec_ms = cs.wall_ms(lambda: back.append(
                container.decompress(dec_blob, device=on)))
        if got[0] != want or back[0] != dec_data:
            raise AssertionError(f"{codec}, {what} on {devs}: differs from "
                                 "one card's")
        if i >= len(VARIANTS):
            out[what]["compress"].append(ms)
            out[what]["decompress"].append(dec_ms)
    return {what: {k: float(np.mean(v)) for k, v in r.items()}
            for what, r in out.items()}


def traced(codec: str, data: bytes, devs: list, name: str,
           out_dir: str) -> dict:
    """One traced compress: wall and the device time summed over cards."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from density_tpu_torch import container
    container.compress(data, codec, cs.STREAM, device=devs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        container.compress(data, codec, cs.STREAM, device=devs)
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        wall = (time.perf_counter() - t) * 1e3
    ka = prof.key_averages()
    busy = sum(e.self_device_time_total for e in ka
               if cs.device_work(e)) / 1e3
    with open(os.path.join(out_dir, f"profile_shares_{codec}_"
                           f"{name.replace(' ', '_').replace(':', '')}.txt"),
              "w") as f:
        f.write(f"wall {wall:.4f} ms, device time {busy:.4f} ms\n\n")
        f.write(ka.table(sort_by="self_cpu_time_total", row_limit=30))
    return dict(wall_ms=wall, device_ms=busy if busy > 0 else None)


def op_cost() -> dict:
    """Host microseconds of wall per small op from 1, 2 and 4 threads at
    once, each on a CUDA stream of its own on the first card."""
    import torch
    dev = torch.device("cuda", 0)
    x = torch.zeros(1, device=dev)
    per_op = {}
    for threads in (1, 2, 4):
        start = threading.Barrier(threads + 1)

        def run():
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                y = x.clone()
                start.wait()
                for _ in range(OPS):
                    y.add_(1)
                torch.cuda.current_stream().synchronize()
        workers = [threading.Thread(target=run) for _ in range(threads)]
        for w in workers:
            w.start()
        start.wait()
        t = time.perf_counter()
        for w in workers:
            w.join()
        per_op[threads] = (time.perf_counter() - t) / OPS * 1e6
    return per_op


def call_cost(calls: int = CALLS) -> dict:
    """Host microseconds of one `mesh.run_shares` call over 2 and 4 tasks
    that each make one small op and one host read on the first card: by
    the workers, and by the same tasks in the caller's thread."""
    import torch
    from density_tpu_torch import hostsync
    from density_tpu_torch.parallel import mesh
    dev = torch.device("cuda", 0)

    def task(x):
        x.add_(1)
        return hostsync.read(x)
    out = {}
    for k in (2, 4):
        devs = [dev] * k
        tasks = [(dev, lambda x=torch.zeros(1, device=dev): task(x))
                 for _ in range(k)]
        for what, run in (
                ("workers", lambda: mesh.run_shares(devs, tasks)),
                ("one thread", lambda: [fn() for _, fn in tasks])):
            run()
            t = time.perf_counter()
            for _ in range(calls):
                run()
            out[f"{what}, {k} tasks"] = ((time.perf_counter() - t) / calls
                                         * 1e6)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=2,
                    help="passes over the variants, each forwards and "
                         "backwards")
    ap.add_argument("--no-traces", action="store_true")
    ap.add_argument("--only-cards", action="store_true",
                    help="only the lists of distinct cards")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase (l)'s input")
    ap.add_argument("--out", default="share_costs_out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    from density_tpu_torch import container
    from density_tpu_torch.kernels import _build
    os.makedirs(args.out, exist_ok=True)
    cs.OUT_DIR = args.out
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    _build.build()
    data = cs.corpus_bytes()
    alphabet = cs.alphabet_input(args.seed)
    lists = device_lists(args.only_cards)
    if not lists:
        raise SystemExit("--only-cards needs two or more cards")
    report = {"cards": smi.splitlines(), "walls": {}, "traces": {}}
    for codec in CODECS:
        one = torch.device("cuda", 0)
        dec_data = data if codec == "chameleon" else alphabet
        dec_blob = container.compress(dec_data, codec, cs.STREAM, device=one)
        for name, devs in lists.items():
            r = walls(codec, data, dec_blob, dec_data, devs, args.turns)
            report["walls"][f"{codec} {name}"] = r
            base = r["one card"]
            print(f"{codec}, {name}, mean of {2 * args.turns} turns: " +
                  "; ".join(f"{what} compress {v['compress']:.3f} ms "
                            f"({v['compress'] / base['compress']:.3f}x), "
                            f"decompress {v['decompress']:.3f} ms "
                            f"({v['decompress'] / base['decompress']:.3f}x)"
                            for what, v in r.items()), flush=True)
            if not args.no_traces:
                for key, on in (("one card", [one]), (name, devs)):
                    if f"{codec} {key}" in report["traces"]:
                        continue
                    t = report["traces"][f"{codec} {key}"] = traced(
                        codec, data, on, key, args.out)
                    dm = t["device_ms"]
                    busy = ("not measured" if dm is None else
                            f"{dm:.3f} ms ({dm / t['wall_ms']:.3f} of "
                            f"the wall)")
                    print(f"{codec} compress traced, {key}: "
                          f"{t['wall_ms']:.3f} ms wall, device time {busy}",
                          flush=True)
    report["op_us"] = op_cost()
    print(f"host cost of one small op ({OPS} in-place adds a thread): "
          + ", ".join(f"{v:.2f} us on {k} thread(s)"
                      for k, v in report["op_us"].items()), flush=True)
    report["call_us"] = call_cost()
    print("host wall of one run_shares call of small tasks (one op and one "
          "host read each): " + ", ".join(
              f"{what} {v:.1f} us" for what, v in report["call_us"].items()),
          flush=True)
    with open(os.path.join(args.out, "share_costs.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
