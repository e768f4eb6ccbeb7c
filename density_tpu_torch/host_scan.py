"""Host-side chameleon block scanner and scalar encoder (numpy/Python).

The decode path needs each block's input offset and copy bit before the
device can extract tokens, and those come from a sequential walk of the
block chain that replays the protection FSM. This is the chameleon
branch of the JAX package's pure-Python scanner (`native/fallback.py`,
itself the twin of `scan_stream` in its C++ runtime and of the
reference decoder's block walk, codec.rs:82-126). A full block --
one with room for the largest encoded block after it -- is sized from
its signature's popcount in O(1); only the final block walks its tokens.

`encode_scalar` is the chameleon scalar encoder (reference encode
loop codec.rs:34-80 with chameleon.rs:88-100): the exact fallback for a
stream whose fixed point has not converged.
"""

from __future__ import annotations

import numpy as np

from density_tpu_torch.constants import CHAMELEON, HASH_BITS, hash_u16
from density_tpu_torch.errors import DecodeError

BLOCK = CHAMELEON.block_size
SIG = CHAMELEON.sig_bytes
Q = CHAMELEON.quads_per_block
FULL = SIG + BLOCK  # the largest encoded block: every token plain


class Protection:
    """Blowup FSM (reference: protection_state.rs:9-47)."""

    __slots__ = ("copy_penalty", "copy_penalty_start",
                 "previous_incompressible", "counter")

    def __init__(self):
        self.copy_penalty = 0
        self.copy_penalty_start = 1
        self.previous_incompressible = False
        self.counter = 0

    def revert_to_copy(self):
        if (self.counter & 0xF) == 0 and self.copy_penalty_start > 1:
            self.copy_penalty_start >>= 1
        self.counter += 1
        return self.copy_penalty > 0

    def decay(self):
        self.copy_penalty -= 1
        if self.copy_penalty == 0:
            self.copy_penalty_start += 1

    def update(self, incompressible: bool):
        if incompressible:
            if self.previous_incompressible:
                self.copy_penalty = self.copy_penalty_start
            self.previous_incompressible = True
        else:
            self.previous_incompressible = False


def scan_with_counts(data: bytes):
    """Walk the block chain of a chameleon stream. Returns (in_offsets,
    out_offsets, is_copy, n_pred, n_tok), as the JAX package's
    `native.scan_with_counts("chameleon", data)` does."""
    prot = Protection()
    n = len(data)
    ip = op = 0
    in_offs: list[int] = []
    out_offs: list[int] = []
    copies: list[int] = []
    n_tok = 0
    while n - ip > 0:
        in_offs.append(ip)
        out_offs.append(op)
        if prot.revert_to_copy():
            copies.append(1)
            rem = n - ip
            if rem > BLOCK:
                ip += BLOCK
                op += BLOCK
                prot.decay()
                continue
            ip += rem
            op += rem
            break
        copies.append(0)
        mark = ip
        if n - ip < SIG:
            raise DecodeError("malformed chameleon stream (truncated sig)")
        sig = int.from_bytes(data[ip:ip + SIG], "little")
        ip += SIG
        if n - mark >= FULL:
            # no token can reach the stream end: 4 bytes per plain (flag
            # 0) token, 2 per map token
            n_map = sig.bit_count()
            ip += 4 * (Q - n_map) + 2 * n_map
            op += 4 * Q
            n_tok += Q
            prot.update(ip - mark >= BLOCK)
            continue
        ended = False
        for _ in range(Q):
            flag = sig & 1
            sig >>= 1
            tok = 2 if flag else 4
            n_tok += 1
            if tok == 4:  # plain: ragged-tail semantics (codec.rs:58-62)
                rem = n - ip
                if rem == 0:
                    ended = True
                    break
                if rem <= 3:
                    ip += rem
                    op += rem
                    ended = True
                    break
            elif n - ip < 2:
                raise DecodeError(
                    "malformed chameleon stream (truncated payload)")
            ip += tok
            op += 4
            if ip > n:
                raise DecodeError("malformed chameleon stream (overran input)")
        if ended:
            break
        prot.update(ip - mark >= BLOCK)
    return (np.asarray(in_offs, np.int64), np.asarray(out_offs, np.int64),
            np.asarray(copies, np.uint8), 0, n_tok)


def scan_many(streams, max_blocks: int):
    """Batched scan: (in_offsets, out_offsets, is_copy) as (n, max_blocks)
    arrays, block counts, predicted-token and token counts."""
    n = len(streams)
    bio = np.zeros((n, max_blocks), np.int64)
    boo = np.zeros((n, max_blocks), np.int64)
    bcp = np.zeros((n, max_blocks), np.uint8)
    nb = np.zeros(n, np.int64)
    pred = np.zeros(n, np.int64)
    tot = np.zeros(n, np.int64)
    for i, s in enumerate(streams):
        io, oo, cp, p, t = scan_with_counts(s)
        k = len(io)
        if k > max_blocks:
            raise DecodeError("stream exceeds block capacity")
        bio[i, :k] = io
        boo[i, :k] = oo
        bcp[i, :k] = cp
        nb[i] = k
        pred[i] = p
        tot[i] = t
    return bio, boo, bcp, nb, pred, tot


def decoded_length(data: bytes, in_off, out_off, is_copy) -> int:
    """Decoded length of a stream from its scan (the final block's
    output size comes from walking its tokens)."""
    last_in = len(data) - int(in_off[-1])
    if is_copy[-1]:
        last_out = min(last_in, BLOCK)
    else:
        block = data[int(in_off[-1]):]
        sig = int.from_bytes(block[:SIG].ljust(SIG, b"\x00"), "little")
        pos, last_out = SIG, 0
        for _ in range(Q):
            flag = sig & 1
            sig >>= 1
            if flag == 0:
                rem = len(block) - pos
                if rem == 0:
                    break
                if rem <= 3:
                    last_out += rem
                    break
                pos += 4
            else:
                pos += 2
            last_out += 4
    return int(out_off[-1]) + last_out


def encode_scalar(data: bytes) -> bytes:
    """Chameleon reference encoder, one quad at a time."""
    out = bytearray()
    prot = Protection()
    chunk_map = [0] * (1 << HASH_BITS)
    for start in range(0, len(data), BLOCK):
        block = data[start:start + BLOCK]
        if prot.revert_to_copy():
            out += block
            prot.decay()
            continue
        mark = len(out)
        out += bytes(SIG)
        sig = 0
        full = len(block) // 4
        for i in range(full):
            quad = int.from_bytes(block[4 * i:4 * i + 4], "little")
            h = hash_u16(quad)
            if chunk_map[h] != quad:
                out += block[4 * i:4 * i + 4]  # plain: flag bit 0
                chunk_map[h] = quad
            else:
                sig |= 1 << i  # map
                out += h.to_bytes(2, "little")
        out += block[4 * full:]  # ragged tail: raw bytes, no flag bit
        out[mark:mark + SIG] = sig.to_bytes(SIG, "little")
        prot.update(len(out) - mark >= BLOCK)
    return bytes(out)
