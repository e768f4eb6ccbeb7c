"""Host milliseconds per decompress call in the engine and codecs layer,
from the program's spans in the traced run: the self time of its
`density.engine.*` spans, the device decode of each share
(`engine.decode`, with cheetah's and lion's resolve rounds,
`engine.resolve_round`), less the waits inside them."""

from portbench import spans


def read(ctx):
    return spans.layer_ms(ctx, "decompress", "engine")
