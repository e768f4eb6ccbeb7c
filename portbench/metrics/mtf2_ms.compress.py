"""Host milliseconds per compress call in cheetah's MTF-2 dictionary
scans, from the program's spans in the traced run: the self time of its
`density.engine.mtf2` spans (the scan of each copy-free plan and of each
masked plan of the fixed point). None where the program emits no such
span."""

from portbench import spans


def read(ctx):
    half = spans.half_spans(ctx, "compress")
    if half is None:
        return None
    got = [t for n, t in spans.self_times(half) if n == "engine.mtf2"]
    if not got:
        return None
    return sum(got) / ctx.halves["compress"].calls / 1e6
