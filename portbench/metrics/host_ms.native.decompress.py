"""Host milliseconds per decompress call in the native layer, from the
program's spans in the traced run: the self time of its
`density.native.*` spans, the block scan of every stream with its
length checks (`native.scan`) and the native runtime's decodes
(`native.decode`: the pool route, and a stream redone after the device
decode)."""

from portbench import spans


def read(ctx):
    return spans.layer_ms(ctx, "decompress", "native")
