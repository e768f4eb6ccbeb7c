#!/usr/bin/env python3
"""The control of the comparison that decides `correct`, on the card.

    python3 portbench/control.py --workload <name> --seconds <s> \
        --seeds <n> ... --control-seeds <n> ... \
        [--faults <name> ... --fault-seeds <n> ...] [--same-card-shares k]

runs, in one process, a short window of the cell at its own size and load
for each of `--seeds` with the program as it is (the sound readings),
for each of `--control-seeds` with the control in the program's place,
and for each of `--fault-seeds` with each of `--faults` (`faults.py`)
planted in the program, and prints each run's compared numbers and
`correct`. `--same-card-shares k` runs the cell on k shares of the first
card, which takes a sharded cell's path on one card. The benchmark's own
runs never run it.

The configuration states no precision; it states a guarantee: the
container is the density format for its codec at its stream size, byte
for byte, and the round trip is lossless. The control breaks the first
and keeps the second, the step that would tempt a faster program: it is
the program at half the configuration's stream size (more, shorter
streams), a lossless container that is not the stated format.
"""

import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench import faults, harness, resolve  # noqa: E402


def control_cell(cell: resolve.Cell) -> resolve.Cell:
    """The cell with the control in the program's place: the program at
    half the stated stream size. The check still holds it to the
    configuration as stated."""
    half = int(cell.config["stream_size"]) // 2
    config = dict(cell.config, stream_size=half)
    return resolve.Cell(name=cell.name, chips=cell.chips, config=config,
                        traffic=cell.traffic, end_to_end=cell.end_to_end,
                        per_layer=cell.per_layer)


def reading(cell: resolve.Cell, stated: resolve.Cell, seed: int,
            seconds: float, device=None) -> tuple[dict, bool]:
    """One short window of `cell` judged against `stated`'s
    configuration: ({number: (value, limit)}, correct)."""
    m = harness.measure(cell, seed, seconds, False, time.perf_counter(),
                        device)
    m.context.cell = stated
    harness.judge(m, seed)
    return m.numbers, harness.check.correct(m.numbers)


def main(argv) -> int:
    import argparse
    from density_tpu_torch.parallel import sharding
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[],
                   choices=sorted(faults.FAULTS))
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--same-card-shares", type=int, default=0)
    args = p.parse_args(argv)
    cell = resolve.cell(args.workload, harness.ROOT)
    harness.cards_or_exit(1 if args.same_card_shares else cell.chips)
    device = (["cuda:0"] * args.same_card_shares if args.same_card_shares
              else None)
    runs = ([("program", s, cell, None) for s in args.seeds]
            + [("control", s, control_cell(cell), None)
               for s in args.control_seeds]
            + [(f"fault {f}", s, cell, f) for f in args.faults
               for s in args.fault_seeds])
    for kind, seed, run_cell, fault in runs:
        if fault is None:
            numbers, ok = reading(run_cell, cell, seed, args.seconds, device)
        else:
            # the warm-up's own check of the round trip would meet some
            # faults first: leave it out, so the window and the check do
            warm = harness.warm
            harness.warm = lambda system, objs: None
            try:
                with faults.FAULTS[fault](sharding):
                    numbers, ok = reading(run_cell, cell, seed, args.seconds,
                                          device)
            finally:
                harness.warm = warm
        shown = " ".join(f"{k}={v}" for k, (v, _) in numbers.items())
        print(f"{args.workload} {kind} seed {seed} correct {ok} {shown}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
