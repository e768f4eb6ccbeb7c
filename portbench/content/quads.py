"""Little-endian 32-bit quads drawn uniformly from a set of `values`
distinct values, the set itself drawn from the rng; without `values`,
any 32-bit value, which is uniform random bytes (incompressible: the
codecs' copy mode). A size that is not a multiple of 4 ends in the
first bytes of one more quad."""

from __future__ import annotations

import numpy as np


def make(spec: dict, sizes: list[int], rng) -> list[bytes]:
    values = spec.get("values")
    pool = (None if values is None else
            rng.integers(0, 1 << 32, int(values), dtype=np.uint64))
    out = []
    for n in sizes:
        count = -(-n // 4)
        if pool is None:
            quads = rng.integers(0, 1 << 32, count, dtype=np.uint64)
        else:
            quads = pool[rng.integers(0, len(pool), count)]
        out.append(quads.astype("<u4").tobytes()[:n])
    return out
