"""Host milliseconds per compress call in which the program waits for the
card, from its spans in the traced run: the self time of its
`density.wait.*` spans (`hostsync.read`, `to_card`, `masked`, and a
worker's stream synchronised after a fault)."""

from portbench import spans


def read(ctx):
    return spans.layer_ms(ctx, "compress", "wait")
