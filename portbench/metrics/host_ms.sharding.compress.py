"""Host milliseconds per compress call in the sharding layer, from the
program's spans in the traced run: the self time of its
`density.sharding.*` spans, staging each batch's input on the card
(`sharding.stage`), reading its words back and cutting them into
streams (`sharding.fetch`) and running the shares' tasks
(`sharding.share`), less the waits and the engine inside them."""

from portbench import spans


def read(ctx):
    return spans.layer_ms(ctx, "compress", "sharding")
