"""The share of the compress half in which a card runs no kernel, copy or
memset, from the profiler's device events; the mean over the cards."""


def read(ctx):
    return ctx.trace.idle_pct("compress") if ctx.trace else None
