"""Device kernel events (copies and memsets left out) per compress call,
from the profiler's trace of the compress half."""


def read(ctx):
    calls = ctx.halves["compress"].calls
    if not ctx.trace or not calls:
        return None
    return ctx.trace.kernel_events("compress") / calls
