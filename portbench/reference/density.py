"""The plain reference: the density encoders and the DTPU v1 framing.

A frozen copy, in plain Python, of the reference encode loops of the
density library (codec.rs:34-80 with chameleon.rs:88-135,
cheetah.rs:68-149 and lion.rs:50-352, protection_state.rs:9-47), one
quad at a time, and of the container header. It imports nothing of the
program under test, so the benchmark can hold the program's containers
to it. About 0.13 s per 256 KiB stream for chameleon and 0.27 s for lion
in CPython.
"""

from __future__ import annotations

import struct

HASH_MULTIPLIER = 0x9D6EF916
HASH_BITS = 16
PLAIN = 0

# codec -> (flag bits, signature bytes written, block bytes)
GEOMETRY = {"chameleon": (1, 8, 256), "cheetah": (2, 8, 128),
            "lion": (3, 6, 64)}
CODEC_IDS = {"chameleon": 0, "cheetah": 1, "lion": 2}
HEADER = struct.Struct("<4sBBHQII")  # magic, version, codec, 0, n, size, S


def hash_u16(quad: int) -> int:
    return ((quad * HASH_MULTIPLIER) & 0xFFFFFFFF) >> (32 - HASH_BITS)


class _Protection:
    """The copy-mode FSM (protection_state.rs:9-47)."""

    def __init__(self):
        self.penalty = 0
        self.penalty_start = 1
        self.previous_incompressible = False
        self.counter = 0

    def revert_to_copy(self) -> bool:
        if (self.counter & 0xF) == 0 and self.penalty_start > 1:
            self.penalty_start >>= 1
        self.counter += 1
        return self.penalty > 0

    def decay(self):
        self.penalty -= 1
        if self.penalty == 0:
            self.penalty_start += 1

    def update(self, incompressible: bool):
        if incompressible:
            if self.previous_incompressible:
                self.penalty = self.penalty_start
            self.previous_incompressible = True
        else:
            self.previous_incompressible = False


class _Chameleon:
    def __init__(self):
        self.chunk = [0] * (1 << HASH_BITS)

    def quad(self, quad, out):
        h = hash_u16(quad)
        if self.chunk[h] != quad:
            self.chunk[h] = quad
            out.extend(quad.to_bytes(4, "little"))
            return PLAIN
        out.extend(h.to_bytes(2, "little"))
        return 1


class _Cheetah:
    def __init__(self):
        self.last_hash = 0
        self.a = [0] * (1 << HASH_BITS)
        self.b = [0] * (1 << HASH_BITS)
        self.prediction = [0] * (1 << HASH_BITS)

    def quad(self, quad, out):
        h = hash_u16(quad)
        ctx, self.last_hash = self.last_hash, h
        if self.prediction[ctx] == quad:
            return 3
        self.prediction[ctx] = quad
        if self.a[h] == quad:
            out.extend(h.to_bytes(2, "little"))
            return 1
        if self.b[h] == quad:
            flag = 2
            out.extend(h.to_bytes(2, "little"))
        else:
            flag = PLAIN
            out.extend(quad.to_bytes(4, "little"))
        self.b[h] = self.a[h]
        self.a[h] = quad
        return flag


class _Lion:
    def __init__(self):
        self.last_hash = 0
        self.a = [0] * (1 << HASH_BITS)
        self.b = [0] * (1 << HASH_BITS)
        self.queue = [[0] * 5 for _ in range(1 << HASH_BITS)]

    def quad(self, quad, out):
        h = hash_u16(quad)
        q = self.queue[self.last_hash]
        self.last_hash = h
        if quad in q:
            depth = q.index(quad)
            flag = 1 + depth
        else:
            depth = 5
            if self.a[h] == quad:
                flag = 6
                out.extend(h.to_bytes(2, "little"))
            else:
                if self.b[h] == quad:
                    flag = 7
                    out.extend(h.to_bytes(2, "little"))
                else:
                    flag = PLAIN
                    out.extend(quad.to_bytes(4, "little"))
                self.b[h] = self.a[h]
                self.a[h] = quad
        if depth:  # a hit at depth d moves to the front; a miss shifts all
            for k in range(min(depth, 4), 0, -1):
                q[k] = q[k - 1]
            q[0] = quad
        return flag


_STATE = {"chameleon": _Chameleon, "cheetah": _Cheetah, "lion": _Lion}


def encode_stream(data: bytes, codec: str) -> bytes:
    """One bare density stream of `codec`, fresh state."""
    bits, sig_bytes, block = GEOMETRY[codec]
    state = _STATE[codec]()
    prot = _Protection()
    out = bytearray()
    for start in range(0, len(data), block):
        chunk = data[start:start + block]
        if prot.revert_to_copy():
            out.extend(chunk)
            prot.decay()
            continue
        mark = len(out)
        out.extend(bytes(sig_bytes))
        sig = shift = 0
        full = len(chunk) // 4
        for i in range(full):
            sig |= state.quad(int.from_bytes(chunk[4 * i:4 * i + 4],
                                             "little"), out) << shift
            shift += bits
        out.extend(chunk[4 * full:])  # ragged tail: raw, no flag
        out[mark:mark + sig_bytes] = sig.to_bytes(8, "little")[:sig_bytes]
        prot.update(len(out) - mark >= block)
    return bytes(out)


def stream_bounds(n: int, stream_size: int) -> list[tuple[int, int]]:
    """[start, end) of each stream of an n-byte input."""
    count = max(1, -(-n // stream_size)) if n else 0
    return [(s * stream_size, min(n, (s + 1) * stream_size))
            for s in range(count)]


def header(codec: str, n: int, stream_size: int, lengths) -> bytes:
    """The DTPU v1 header of a container of the given stream lengths."""
    return HEADER.pack(b"DTPU", 1, CODEC_IDS[codec], 0, n, stream_size,
                       len(lengths)) + b"".join(
        struct.pack("<I", length) for length in lengths)


def compress(data: bytes, codec: str, stream_size: int) -> bytes:
    """The whole reference container of `data`."""
    parts = [encode_stream(data[a:b], codec)
             for a, b in stream_bounds(len(data), stream_size)]
    return header(codec, len(data), stream_size,
                  [len(p) for p in parts]) + b"".join(parts)
