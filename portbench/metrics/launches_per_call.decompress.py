"""Device kernel events (copies and memsets left out) per decompress
call, from the profiler's trace of the decompress half; nothing where the
half ran no kernel (a container decoded on the host pool)."""


def read(ctx):
    calls = ctx.halves["decompress"].calls
    if not ctx.trace or not calls:
        return None
    n = ctx.trace.kernel_events("decompress")
    return n / calls if n else None
