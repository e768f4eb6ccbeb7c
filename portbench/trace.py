"""The traced run: `torch.profiler` over the window, reduced to numbers.

The profiler records the host's ops (CPU activity) and the card's
events (kernels, copies, memsets: CUDA activity, through CUPTI) over the
whole window. The harness marks each half with a span of its own
(`HALF_SPAN` + the half's name), so a half's bounds are read from the
same clock as the card's events. From the events this module takes:

- busy time: the union of a card's events, clipped to an interval;
- idle share: 1 - busy / length, the mean over the cards a cell uses
  (a card with no event is idle throughout);
- kernel events: device events that are neither copies nor memsets;
- overlap: the time in which two or more cards are busy at once;
- the breakdown: device time by op name, and each idle gap of a card
  named by the host op open at its middle (the innermost one, where
  they nest; "no op open" where only the harness's span of the request
  is, which is Python or native code of the port), summed by name.
"""

from __future__ import annotations

import heapq
from contextlib import nullcontext

import numpy as np

HALF_SPAN = "portbench.half."
REQUEST_SPAN = "portbench."
COPY_PREFIXES = ("Memcpy", "Memset")
MAX_NAME = 160


class Tracer:
    """The profiler over the window; `span(name)` marks a region on the
    host (a no-op when not tracing)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def span(self, name: str):
        if not self.enabled:
            return nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def events(self) -> list:
        """(name, start_ns, end_ns, device or None) of every event; the
        device is the card's index for a device event, None on the host."""
        from torch.autograd import DeviceType
        out = []
        for e in self.prof.profiler.kineto_results.events():
            dev = (None if e.device_type() == DeviceType.CPU
                   else int(e.device_index()))
            if dev is not None and (e.is_user_annotation()
                                    or e.name().startswith(REQUEST_SPAN)):
                continue  # a host span drawn on the card's timeline
            start = int(e.start_ns())
            out.append((e.name(), start, start + int(e.duration_ns()), dev))
        return out


def merged(starts: np.ndarray, ends: np.ndarray):
    """The union of intervals, as sorted disjoint (starts, ends)."""
    if starts.size == 0:
        return starts, ends
    idx = np.argsort(starts, kind="stable")
    s, e = starts[idx], ends[idx]
    reach = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, s.size - 1)
    return s[first], reach[last]


def clipped_sum(starts, ends, lo: int, hi: int) -> int:
    """Total length of disjoint intervals inside [lo, hi)."""
    return int(np.clip(np.minimum(ends, hi) - np.maximum(starts, lo), 0,
                       None).sum())


class Trace:
    """The reduced trace of one window over the cards `cards`."""

    def __init__(self, events: list, cards: list[int]):
        self.cards = list(cards)
        self.halves = {}
        host, device = [], []
        for ev in events:
            name, start, end, dev = ev
            if dev is None:
                if name.startswith(HALF_SPAN):
                    self.halves[name[len(HALF_SPAN):]] = (start, end)
                host.append(ev)
            else:
                device.append(ev)
        self.host = host
        self.device = device
        self.busy = {}
        for c in self.cards:
            mine = [(s, e) for _, s, e, d in device if d == c]
            arr = np.asarray(mine, np.int64).reshape(-1, 2)
            self.busy[c] = merged(arr[:, 0], arr[:, 1])

    def bounds(self, half: str):
        return self.halves[half]

    def span(self, name: str):
        """(start, end) of the host span `name`."""
        return next((s, e) for n, s, e, _ in self.host if n == name)

    def window(self):
        """(start, end) of the traced window: both halves."""
        spans = list(self.halves.values())
        return min(s for s, _ in spans), max(e for _, e in spans)

    def busy_s(self, card: int, lo: int, hi: int) -> float:
        s, e = self.busy[card]
        return clipped_sum(s, e, lo, hi) / 1e9

    def idle_pct(self, half: str) -> float:
        """The share of the half in which a card runs nothing, the mean
        over the cards."""
        lo, hi = self.bounds(half)
        length = (hi - lo) / 1e9
        return 100.0 * float(np.mean(
            [1.0 - self.busy_s(c, lo, hi) / length for c in self.cards]))

    def kernel_events(self, half: str) -> int:
        lo, hi = self.bounds(half)
        return sum(1 for name, s, _, _ in self.device
                   if lo <= s < hi and not name.startswith(COPY_PREFIXES))

    def kernels_named(self, names, lo: int, hi: int) -> int:
        """Kernel events in [lo, hi) whose name holds one of `names`."""
        return sum(1 for name, s, _, _ in self.device
                   if lo <= s < hi and any(n in name for n in names))

    def overlap_pct(self, half: str) -> float:
        """The share of the half in which two or more cards are busy."""
        lo, hi = self.bounds(half)
        marks = []
        for c in self.cards:
            s, e = self.busy[c]
            marks += [(int(x), 1) for x in s] + [(int(x), -1) for x in e]
        marks.sort()
        both, depth, prev = 0, 0, lo
        for t, step in marks:
            t = min(max(t, lo), hi)
            if depth >= 2:
                both += t - prev
            prev = t
            depth += step
        if depth >= 2:
            both += hi - prev
        return 100.0 * both / (hi - lo)

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds]: device time by op name over the window."""
        lo, hi = self.window()
        total: dict = {}
        for name, s, e, _ in self.device:
            if lo <= s < hi:
                total[name] = total.get(name, 0) + (min(e, hi) - s)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:MAX_NAME], t / 1e9] for n, t in ranked]

    def idle_gaps(self, top: int = 10) -> list:
        """[name, seconds]: the cards' idle time in the window, each gap
        named by the half it lies in and the innermost host op open at
        its middle, summed by name."""
        lo, hi = self.window()
        gaps = []
        for c in self.cards:
            s, e = self.busy[c]
            # busy intervals outside the window (a probe's) leave no gap
            starts = np.clip(np.concatenate([[lo], e]), lo, hi)
            ends = np.clip(np.concatenate([s, [hi]]), lo, hi)
            keep = ends > starts
            gaps += list(zip(starts[keep].tolist(), ends[keep].tolist()))
        gaps.sort(key=lambda g: g[0] + g[1])
        host = sorted((s, e, n) for n, s, e, _ in self.host
                      if not n.startswith(HALF_SPAN))
        halves = sorted((s, e, n) for n, (s, e) in self.halves.items())
        total: dict = {}
        open_ops: list = []  # max-heap on start: (-start, end, name)
        i = 0
        for a, b in gaps:
            mid = (a + b) // 2
            while i < len(host) and host[i][0] <= mid:
                heapq.heappush(open_ops, (-host[i][0], host[i][1],
                                          host[i][2]))
                i += 1
            while open_ops and open_ops[0][1] < mid:
                heapq.heappop(open_ops)
            op = open_ops[0][2] if open_ops else "no span"
            if op.startswith(REQUEST_SPAN):
                op = "no op open"  # Python or native code of the port
            half = next((n for s, e, n in halves if s <= mid < e), "between")
            key = f"{half}: {op}"[:MAX_NAME]
            total[key] = total.get(key, 0) + (b - a)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[n, t / 1e9] for n, t in ranked]
