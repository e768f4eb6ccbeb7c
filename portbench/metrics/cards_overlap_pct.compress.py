"""The share of the compress half in which two or more cards have device
events at once, from the profiler's trace; nothing on one card."""


def read(ctx):
    if not ctx.trace or len(ctx.cards) < 2:
        return None
    return ctx.trace.overlap_pct("compress")
