"""Published H100 peaks and the least time a kernel's work could take.

NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM3 bandwidth and 67
TFLOP/s of 32-bit arithmetic outside the tensor cores, at the full power
limit of 700 W (a card set below it runs slower under load, so a share
is printed with the card's `power.limit`). A kernel's bound is the larger
of its bytes over the bandwidth and its operations over the arithmetic
rate, with each input read once and each output written once, counted
from the shapes, whatever the kernel reads again.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """(least milliseconds, "bytes" or "operations": which bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sort_bound(S: int, N: int, n_arrays: int) -> tuple[float, str]:
    """A sort of S rows of N int32 elements carrying `n_arrays` arrays
    (the key among them): each read and written once; about N log2 N
    compares a row."""
    return bound_ms(2 * n_arrays * S * N * 4, S * N * math.log2(N))


def unpack_bound(S: int, NB: int, q: int, payload_bytes: int
                 ) -> tuple[float, str]:
    """Token extraction of S streams of NB blocks of q quads: the
    compressed payload read once at its size in bytes (however the
    program lays it out in memory), the block offsets (int32) and copy
    flags (bool) read, and the flags, w0 and w1 lattices (int32 each)
    written."""
    return bound_ms(payload_bytes + S * NB * 5 + 3 * S * NB * q * 4, 0)
