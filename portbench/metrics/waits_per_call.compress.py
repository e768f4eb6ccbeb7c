"""Waits for the card per compress call, counted from the program's
spans in the traced run: its `density.wait.*` spans, each a host read of
the card, a blocking copy onto it or a boolean mask's count
(`hostsync`)."""

from portbench import spans


def read(ctx):
    return spans.count(ctx, "compress", ("wait.",))
