"""Host milliseconds per compress call in the container layer, from the
program's spans in the traced run: the self time of its
`density.container.compress` spans, the call's root (the input's copy
and slicing, the header, the final join). Also logs, for both halves,
the share of the harness's request spans that the roots cover and the
layers' self times against the roots."""

from portbench import spans


def read(ctx):
    for half in ("compress", "decompress"):
        line = spans.summary(ctx, half)
        if line is not None:
            ctx.log(line)
    return spans.layer_ms(ctx, "compress", "container")
