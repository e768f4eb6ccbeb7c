"""Host syncs per compress call, as PyTorch's CUDA sync debug mode
reports them (the share workers' included), over one compress of each
distinct object after the window."""

from portbench import probes


def read(ctx):
    if not ctx.cards:
        return None
    calls = [lambda obj=obj: ctx.system.compress(obj) for obj in ctx.objects]
    return probes.host_syncs(calls) / len(calls)
