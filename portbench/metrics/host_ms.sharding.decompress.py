"""Host milliseconds per decompress call in the sharding layer, from the
program's spans in the traced run: the self time of its
`density.sharding.*` spans, staging the streams' words on the card
(`sharding.stage`), reading the decoded words back (`sharding.fetch`),
joining them into the streams' bytes (`sharding.join`) and running the
shares' tasks (`sharding.share`), less the waits, the engine and the
native runtime inside them."""

from portbench import spans


def read(ctx):
    return spans.layer_ms(ctx, "decompress", "sharding")
