"""The measured window: a closed loop in two contiguous halves.

One writer sends a request, waits for its result and sends the next.
The first half compresses the objects in the seeded order, cycling over
it; the second decompresses the containers the first half made, in
order, cycling over them. Each half issues requests until its length
has passed and ends when the last one returns, so a half's rate is taken
over all its work and all its time. A request that raises counts as
failed and takes its latency all the same.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Half:
    name: str
    seconds: float = 0.0       # from the first request to the last return
    calls: int = 0
    nbytes: int = 0            # original bytes compressed, or returned
    latencies: list = field(default_factory=list)
    errors: list = field(default_factory=list)

    @property
    def failed(self) -> int:
        return len(self.errors)

    def gbps(self) -> float:
        return self.nbytes / self.seconds / 1e9

    def p95_ms(self) -> float:
        return float(np.percentile(self.latencies, 95)) * 1e3


class Reservoir:
    """A uniform sample of k items of a stream, drawn from the seed."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def _loop(half: Half, seconds: float, request, tracer) -> None:
    t0 = time.perf_counter()
    with tracer.span("portbench.half." + half.name):
        while time.perf_counter() - t0 < seconds:
            start = time.perf_counter()
            try:
                with tracer.span("portbench." + half.name):
                    request(half.calls)
            except Exception as e:  # noqa: BLE001 - a failed request
                half.errors.append(f"{type(e).__name__}: {e}"[:300])
            half.latencies.append(time.perf_counter() - start)
            half.calls += 1
    half.seconds = time.perf_counter() - t0


def run(system, objects: list, order: list, seconds: float, outputs_kept: int,
        rng: np.random.Generator, tracer):
    """Runs both halves. Returns (compress half, decompress half,
    containers, sampled outputs): containers[i] = (object index, container
    or None) of compress request i; the outputs a seeded sample of
    (object index, returned bytes) of the decompress requests."""
    comp, decomp = Half("compress"), Half("decompress")
    containers = []

    def compress(i: int) -> None:
        obj = order[i % len(order)]
        containers.append((obj, None))
        containers[-1] = (obj, system.compress(objects[obj]))
        comp.nbytes += len(objects[obj])

    _loop(comp, seconds / 2, compress, tracer)
    made = [(obj, blob) for obj, blob in containers if blob is not None]
    kept = Reservoir(outputs_kept, rng)

    def decompress(i: int) -> None:
        obj, blob = made[i % len(made)]
        out = system.decompress(blob)
        decomp.nbytes += len(out)
        kept.offer((obj, out))

    if made:
        _loop(decomp, seconds / 2, decompress, tracer)
    return comp, decomp, containers, kept.items
