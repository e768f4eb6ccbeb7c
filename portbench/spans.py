"""The program's own spans in a traced run, per call of a half.

The port marks its layer boundaries with profiler ranges named
`density.<layer>.<what>` (`density_tpu_torch/tracing.py`), recorded by
the traced run's profiler session on the clock of the card's events.
The readers here keep the spans that start inside a half's bounds and
give, per call of the half (`ctx.halves[half].calls`):

- a layer's self time: each span's duration less the part of it that
  its child spans (the program's, not the ops) cover, summed by layer;
- counts of spans by name.

The trace's host events carry no thread id, so the nesting is read as
one thread's. Over one card every share's task runs in the caller's
thread; over several, the workers' spans interleave, and the readers
give nothing. A tree whose program emits no spans gives nothing too.
"""

from __future__ import annotations

PREFIX = "density."
REQUEST = "portbench."  # the harness's span of one request


def in_bounds(host: list, lo: int, hi: int) -> list:
    """(name without the prefix, start, end) of the program's spans that
    start in [lo, hi), in order of start."""
    return sorted(((n[len(PREFIX):], s, e) for n, s, e, _ in host
                   if n.startswith(PREFIX) and lo <= s < hi),
                  key=lambda x: (x[1], -x[2]))


def self_times(spans: list) -> list:
    """(name, self ns) of each span of `spans` (`in_bounds`' form): its
    duration less the part its children cover, read from the nesting
    of the intervals on one thread."""
    covered = [0] * len(spans)
    stack = []
    for i, (_, s, e) in enumerate(spans):
        while stack and spans[stack[-1]][2] <= s:
            stack.pop()
        if stack:
            p = stack[-1]
            covered[p] += min(e, spans[p][2]) - s
        stack.append(i)
    return [(n, e - s - c) for (n, s, e), c in zip(spans, covered)]


def by_layer(spans: list) -> dict:
    """Self ns by layer, the first part of each span's name."""
    out: dict = {}
    for name, t in self_times(spans):
        layer = name.split(".")[0]
        out[layer] = out.get(layer, 0) + t
    return out


def half_spans(ctx, half: str) -> list | None:
    """The program's spans of `half`, or None (with a line saying why
    where the cause is not only an untraced run)."""
    if ctx.trace is None or not ctx.halves[half].calls:
        return None
    if len(ctx.cards) > 1:
        ctx.log(f"note: {len(ctx.cards)} cards: the trace's host events "
                "carry no thread id, so the workers' spans cannot be "
                "nested; no span metric")
        return None
    lo, hi = ctx.trace.bounds(half)
    spans = in_bounds(ctx.trace.host, lo, hi)
    if not spans:
        ctx.log(f"note: no {PREFIX}* span in the {half} half: the program "
                "emits none")
        return None
    return spans


def layer_ms(ctx, half: str, layer: str) -> float | None:
    """Milliseconds of self time of `layer` per call of `half`."""
    spans = half_spans(ctx, half)
    if spans is None:
        return None
    return by_layer(spans).get(layer, 0) / ctx.halves[half].calls / 1e6


def count(ctx, half: str, prefixes: tuple) -> float | None:
    """Spans per call of `half` whose name starts with one of
    `prefixes`."""
    spans = half_spans(ctx, half)
    if spans is None:
        return None
    return sum(n.startswith(prefixes) for n, _, _ in spans) / \
        ctx.halves[half].calls


def root_share(ctx, half: str) -> float | None:
    """The share of the harness's request spans of `half` that the
    program's `container.*` spans cover."""
    spans = half_spans(ctx, half)
    if spans is None:
        return None
    lo, hi = ctx.trace.bounds(half)
    requests = sum(e - s for n, s, e, _ in ctx.trace.host
                   if n == REQUEST + half and lo <= s < hi)
    roots = sum(e - s for n, s, e in spans if n.startswith("container."))
    return roots / requests if requests else None


def summary(ctx, half: str) -> str | None:
    """A line on the spans of `half`: the share of the request spans the
    roots cover, the layers' self times against the roots, and each
    layer's milliseconds per call."""
    spans = half_spans(ctx, half)
    if spans is None:
        return None
    layers = by_layer(spans)
    roots = sum(e - s for n, s, e in spans if n.startswith("container."))
    calls = ctx.halves[half].calls
    return (f"{half}: the container spans cover "
            f"{100 * root_share(ctx, half):.2f}% of the request spans; the "
            f"layers' self times sum to "
            f"{100 * sum(layers.values()) / roots:.3f}% of them; ms a call: "
            + ", ".join(f"{k} {v / calls / 1e6:.4f}"
                        for k, v in sorted(layers.items())))
