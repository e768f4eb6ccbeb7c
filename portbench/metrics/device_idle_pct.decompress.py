"""The share of the decompress half in which a card runs no kernel, copy
or memset, from the profiler's device events; the mean over the cards."""


def read(ctx):
    return ctx.trace.idle_pct("decompress") if ctx.trace else None
