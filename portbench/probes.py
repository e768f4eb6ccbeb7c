"""Measurements on the card that the per-layer readers share.

`run_probe` runs a kernel's warm calls inside the traced run's profiler
session, after the window, and `probe_ms` reads their device time from
that trace; `host_syncs` counts the syncs that PyTorch's CUDA sync debug
mode reports (copies to the host, `.item()`, stream synchronisation),
the share workers' included.
"""

from __future__ import annotations

import time
import warnings

# a probe's host span; its copy on the card's timeline is left out
PROBE_SPAN = "portbench.probe."
# idle time at both ends of a probe's span, so that no event of another
# call falls inside it however the host's and the card's clocks align
MARGIN_S = 0.005


def run_probe(tracer, name: str, fn, launches, iters: int = 20) -> int:
    """Runs `fn` once to warm it, then `iters` times back to back in the
    host span `PROBE_SPAN + name` of the traced session, and returns the
    launches that the program's counter (`launches()`) counted in them."""
    import torch
    fn()
    torch.cuda.synchronize()
    before = launches()
    with tracer.span(PROBE_SPAN + name):
        time.sleep(MARGIN_S)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(MARGIN_S)
    return launches() - before


def probe_ms(trace, name: str, names, iters: int, counted: int
             ) -> float | None:
    """Device milliseconds per call of the probe `name`: the summed
    durations of the device events (kernels, copies, memsets) in its
    span, over `iters`, so the host's time between launches is not
    counted. None, with a line saying why, where the trace shows that
    the profiler dropped events: fewer kernels named in `names` than the
    launch counter counted, or a count that `iters` calls cannot give."""
    lo, hi = trace.span(PROBE_SPAN + name)
    device = [(n, s, e) for n, s, e, _ in trace.device if lo <= s < hi]
    named = sum(1 for n, _, _ in device if any(k in n for k in names))
    if named < counted or named % iters or not named:
        print(f"note: {name}'s probe shows {named} kernel events over "
              f"{iters} calls, the launch counter {counted}: no reading",
              flush=True)
        return None
    return sum(e - s for _, s, e in device) / iters / 1e6


def host_syncs(calls) -> int:
    """The host syncs that the calls `calls` (a list of functions) make
    together, each already warm."""
    import torch
    torch.cuda.synchronize()
    seen = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" in str(message):
            seen.append(1)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for fn in calls:
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return len(seen)
