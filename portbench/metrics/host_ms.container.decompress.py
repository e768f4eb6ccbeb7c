"""Host milliseconds per decompress call in the container layer, from
the program's spans in the traced run: the self time of its
`density.container.decompress` spans, the call's root (the header's
parse, the streams' slicing, the final join)."""

from portbench import spans


def read(ctx):
    return spans.layer_ms(ctx, "decompress", "container")
