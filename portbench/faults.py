"""Faults planted under the timed path, to see the check fail.

Each fault takes the program's `parallel/sharding` module and returns a
context manager under which the program has the fault: the container
compress and decompress that the window drives go through the patched
function. The CPU tests plant them at a small size; `control.py
--faults` reads them on the card at a cell's own size. The benchmark's
own runs plant none.
"""

from __future__ import annotations

from contextlib import contextmanager


def flip(data: bytes, at: int = 10) -> bytes:
    b = bytearray(data)
    b[at % len(b)] ^= 0x5A
    return bytes(b)


@contextmanager
def patched(owner, name: str, new):
    old = getattr(owner, name)
    setattr(owner, name, new)
    try:
        yield
    finally:
        setattr(owner, name, old)


def half_left_out(sharding):
    """A batch's second half of streams left out, the first half's bytes
    in their place."""
    orig = sharding._encode_batch_to_parts

    def broken(*args):
        parts = orig(*args)
        h = len(parts) // 2
        return parts[:len(parts) - h] + parts[:h]
    return patched(sharding, "_encode_batch_to_parts", broken)


def token_altered(sharding):
    """One byte of each batch's first stream altered where the encode
    produces it."""
    orig = sharding._encode_batch_to_parts
    return patched(sharding, "_encode_batch_to_parts",
                   lambda *a: [flip(p) if i == 0 else p
                               for i, p in enumerate(orig(*a))])


def answer_altered(sharding):
    """One byte of the first decoded stream altered where the decode
    produces it."""
    orig = sharding._join
    return patched(sharding, "_join", lambda *a, **k: [
        flip(p) if i == 0 else p for i, p in enumerate(orig(*a, **k))])


def state_unchanged(sharding):
    """The decode hands back the bytes of its previous call."""
    orig, last = sharding.decompress, []

    def stale(data, device=None):
        out = last[0] if last else orig(data, device)
        last[:] = [out]
        return out
    return patched(sharding, "decompress", stale)


def exchange_left_out(sharding):
    """The shares of every device but the first not gathered."""
    orig = sharding.run_shares
    return patched(sharding, "run_shares", lambda devs, tasks: [
        r if i == 0 else [] for i, r in enumerate(orig(devs, tasks))])


FAULTS = {f.__name__: f for f in (half_left_out, token_altered,
                                  answer_altered, state_unchanged,
                                  exchange_left_out)}
