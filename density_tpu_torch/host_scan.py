"""Host-side block scanner and scalar codecs (numpy/Python).

The decode path needs each block's input offset and copy bit before the
device can extract tokens, and those come from a sequential walk of the
block chain that replays the protection FSM. `scan_with_counts` is the
port's copy of the JAX package's pure-Python scanner
(`native/fallback.py`, itself the twin of `scan_stream` in its C++
runtime and of the reference decoder's block walk, codec.rs:82-126),
for the three codecs' traits. A full block -- one with room for the
largest encoded block after it -- is sized without the ragged checks;
only the final block walks its tokens with them.

`encode_scalar` and `decode_scalar` are the reference encode and decode
loops (codec.rs:34-126 with chameleon.rs:88-135, cheetah.rs:68-149 and
lion.rs:50-352), a copy of the JAX package's scalar oracle
(`codecs/scalar.py`). They serve `api.py`'s "scalar" backend and stand
in for the native runtime (`native/`) where it cannot be built.
"""

from __future__ import annotations

import numpy as np

from density_tpu_torch.constants import (
    CHEETAH_MAP_A_FLAG, CHEETAH_MAP_B_FLAG, CHEETAH_PREDICTED_FLAG, HASH_BITS,
    LION_MAP_A_FLAG, LION_MAP_B_FLAG, LION_PREDICTED_A_FLAG, PLAIN_FLAG,
    SPECS, hash_u16)
from density_tpu_torch.errors import DecodeError


def _payload_bytes(codec: str, flag: int) -> int:
    """Bytes a token of `flag` stores: 4 for a plain quad, 2 for a map
    (a u16 hash), 0 for a predicted quad."""
    if flag == PLAIN_FLAG:
        return 4
    if codec == "chameleon":
        return 2
    if codec == "cheetah":
        return 0 if flag == CHEETAH_PREDICTED_FLAG else 2
    return 2 if flag >= LION_MAP_A_FLAG else 0


# codec -> payload bytes by flag
PAYLOAD = {c: [_payload_bytes(c, f) for f in range(1 << SPECS[c].flag_bits)]
           for c in SPECS}


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


def scan_with_counts(data: bytes, codec: str = "chameleon"):
    """Walk the block chain of a stream. Returns (in_offsets,
    out_offsets, is_copy, n_pred, n_tok), as the JAX package's
    `native.scan_with_counts(codec, data)` does."""
    spec = SPECS[codec]
    block, sig_bytes, q = spec.block_size, spec.sig_bytes, spec.quads_per_block
    flag_bits, payload = spec.flag_bits, PAYLOAD[codec]
    mask = (1 << flag_bits) - 1
    prot = Protection()
    n = len(data)
    ip = op = 0
    in_offs: list[int] = []
    out_offs: list[int] = []
    copies: list[int] = []
    n_pred = n_tok = 0
    while n - ip > 0:
        in_offs.append(ip)
        out_offs.append(op)
        if prot.revert_to_copy():
            copies.append(1)
            rem = n - ip
            if rem > block:
                ip += block
                op += block
                prot.decay()
                continue
            ip += rem
            op += rem
            break
        copies.append(0)
        mark = ip
        if n - ip < sig_bytes:
            raise DecodeError(f"malformed {codec} stream (truncated sig)")
        # 8 bytes, or lion's 6 (lion.rs:339-351 reads 6 significant
        # bytes either way)
        sig = int.from_bytes(data[ip:ip + sig_bytes], "little")
        ip += sig_bytes
        toks = [payload[(sig >> (flag_bits * i)) & mask] for i in range(q)]
        if n - mark >= sig_bytes + block:
            # no token can reach the stream end
            ip += sum(toks)
            op += 4 * q
            n_tok += q
            n_pred += toks.count(0)
            prot.update(ip - mark >= block)
            continue
        ended = False
        for tok in toks:
            n_tok += 1
            if tok == 0:
                n_pred += 1
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
            elif tok == 2 and n - ip < 2:
                raise DecodeError(
                    f"malformed {codec} stream (truncated payload)")
            ip += tok
            op += 4
            if ip > n:
                raise DecodeError(f"malformed {codec} stream (overran input)")
        if ended:
            break
        prot.update(ip - mark >= block)
    return (np.asarray(in_offs, np.int64), np.asarray(out_offs, np.int64),
            np.asarray(copies, np.uint8), n_pred, n_tok)


def scan_many(streams, max_blocks: int, codec: str = "chameleon"):
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
        io, oo, cp, p, t = scan_with_counts(s, codec)
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


def decoded_length(data: bytes, in_off, out_off, is_copy,
                   codec: str = "chameleon") -> int:
    """Decoded length of a stream from its scan (the final block's
    output size comes from walking its tokens)."""
    spec = SPECS[codec]
    last_in = len(data) - int(in_off[-1])
    if is_copy[-1]:
        return int(out_off[-1]) + min(last_in, spec.block_size)
    block = data[int(in_off[-1]):]
    sig = int.from_bytes(block[:spec.sig_bytes], "little")
    mask = (1 << spec.flag_bits) - 1
    pos, last_out = spec.sig_bytes, 0
    for _ in range(spec.quads_per_block):
        tok = PAYLOAD[codec][sig & mask]
        sig >>= spec.flag_bits
        if tok == 4:
            rem = len(block) - pos
            if rem == 0:
                break
            if rem <= 3:
                last_out += rem
                break
        pos += tok
        last_out += 4
    return int(out_off[-1]) + last_out


# ---------------------------------------------------------------------------
# Scalar codecs: the reference loops, one quad at a time
# ---------------------------------------------------------------------------

class _Sig:
    """Write-side signature accumulator (reference: write_signature.rs)."""

    def __init__(self) -> None:
        self.pos = 0
        self.value = 0
        self.shift = 0

    def init(self, pos: int) -> None:
        self.pos = pos
        self.value = 0
        self.shift = 0

    def push(self, flag: int, nbits: int) -> None:
        self.value |= flag << self.shift
        self.shift += nbits


class _ScalarCodec:
    """The block loop of every codec (reference: codec.rs:34-126)."""

    name = ""

    def __init__(self) -> None:
        self.spec = SPECS[self.name]

    def encode_quad(self, quad: int, out: bytearray, sig: _Sig) -> None:
        raise NotImplementedError

    def decode_quad_by_flag(self, flag: int, inp: bytes,
                            pos: int) -> tuple[int, int]:
        """Returns (quad, new_pos) and updates the state."""
        raise NotImplementedError

    def write_signature(self, out: bytearray, sig: _Sig) -> None:
        out[sig.pos:sig.pos + 8] = sig.value.to_bytes(8, "little")

    def read_signature(self, inp: bytes, pos: int) -> tuple[int, int]:
        return int.from_bytes(inp[pos:pos + 8], "little"), pos + 8

    def encode(self, data: bytes) -> bytes:
        spec = self.spec
        out = bytearray()
        sig = _Sig()
        prot = Protection()
        for start in range(0, len(data), spec.block_size):
            block = data[start:start + spec.block_size]
            if prot.revert_to_copy():
                out.extend(block)
                prot.decay()
                continue
            mark = len(out)
            sig.init(len(out))
            out.extend(b"\x00" * spec.sig_bytes)
            full = len(block) // 4
            for i in range(full):
                self.encode_quad(int.from_bytes(block[4 * i:4 * i + 4],
                                                "little"), out, sig)
            # ragged tail: raw bytes, no signature bits (codec.rs:58-62)
            out.extend(block[4 * full:])
            self.write_signature(out, sig)
            prot.update(len(out) - mark >= spec.block_size)
        return bytes(out)

    def _tokens(self, data: bytes, pos: int, sig: list, out: bytearray,
                count: int) -> int:
        mask = (1 << self.spec.flag_bits) - 1
        for _ in range(count):
            flag = sig[0] & mask
            sig[0] >>= self.spec.flag_bits
            quad, pos = self.decode_quad_by_flag(flag, data, pos)
            out.extend(quad.to_bytes(4, "little"))
        return pos

    def decode(self, data: bytes) -> bytes:
        spec = self.spec
        out = bytearray()
        prot = Protection()
        pos = 0
        n = len(data)
        units = spec.block_size // spec.decode_unit
        per_unit = spec.decode_unit // 4
        mask = (1 << spec.flag_bits) - 1
        # full blocks: every token fits before the stream end (codec.rs:88-100)
        while n - pos >= spec.sig_bytes + spec.block_size:
            if prot.revert_to_copy():
                out.extend(data[pos:pos + spec.block_size])
                pos += spec.block_size
                prot.decay()
                continue
            mark = pos
            sigval, pos = self.read_signature(data, pos)
            pos = self._tokens(data, pos, [sigval], out,
                               spec.quads_per_block)
            prot.update(pos - mark >= spec.block_size)
        # tail blocks: decode units, the last one quad by quad with the
        # ragged-tail rule (codec.rs:102-123)
        while n - pos > 0:
            if prot.revert_to_copy():
                if n - pos > spec.block_size:
                    out.extend(data[pos:pos + spec.block_size])
                    pos += spec.block_size
                else:
                    out.extend(data[pos:])
                    return bytes(out)
                prot.decay()
                continue
            mark = pos
            sigval, pos = self.read_signature(data, pos)
            sig = [sigval]
            for _ in range(units):
                if n - pos >= spec.decode_unit:
                    pos = self._tokens(data, pos, sig, out, per_unit)
                    continue
                for _ in range(per_unit):
                    flag = sig[0] & mask
                    sig[0] >>= spec.flag_bits
                    if flag == PLAIN_FLAG and n - pos <= 3:
                        out.extend(data[pos:])
                        return bytes(out)
                    quad, pos = self.decode_quad_by_flag(flag, data, pos)
                    out.extend(quad.to_bytes(4, "little"))
            prot.update(pos - mark >= spec.block_size)
        return bytes(out)


class _Chameleon(_ScalarCodec):
    """One 2^16-entry dictionary, 1-bit flags (chameleon.rs:34-151)."""

    name = "chameleon"

    def __init__(self) -> None:
        super().__init__()
        self.chunk_map = [0] * (1 << HASH_BITS)

    def encode_quad(self, quad, out, sig):
        h = hash_u16(quad)
        if self.chunk_map[h] != quad:
            sig.push(PLAIN_FLAG, 1)
            out.extend(quad.to_bytes(4, "little"))
            self.chunk_map[h] = quad
        else:
            sig.push(1, 1)
            out.extend(h.to_bytes(2, "little"))

    def decode_quad_by_flag(self, flag, inp, pos):
        if flag == PLAIN_FLAG:
            quad = int.from_bytes(inp[pos:pos + 4], "little")
            self.chunk_map[hash_u16(quad)] = quad
            return quad, pos + 4
        return self.chunk_map[int.from_bytes(inp[pos:pos + 2], "little")], \
            pos + 2


class _Cheetah(_ScalarCodec):
    """MRU-swapped dual dictionary and one prediction slot keyed by the
    previous quad's hash (cheetah.rs:42-203)."""

    name = "cheetah"

    def __init__(self) -> None:
        super().__init__()
        self.last_hash = 0
        self.chunk_a = [0] * (1 << HASH_BITS)
        self.chunk_b = [0] * (1 << HASH_BITS)
        self.prediction = [0] * (1 << HASH_BITS)

    def encode_quad(self, quad, out, sig):
        h = hash_u16(quad)
        if self.prediction[self.last_hash] != quad:
            if self.chunk_a[h] != quad:
                if self.chunk_b[h] != quad:
                    sig.push(PLAIN_FLAG, 2)
                    out.extend(quad.to_bytes(4, "little"))
                else:
                    sig.push(CHEETAH_MAP_B_FLAG, 2)
                    out.extend(h.to_bytes(2, "little"))
                self.chunk_b[h] = self.chunk_a[h]
                self.chunk_a[h] = quad
            else:
                sig.push(CHEETAH_MAP_A_FLAG, 2)
                out.extend(h.to_bytes(2, "little"))
            self.prediction[self.last_hash] = quad
        else:
            sig.push(CHEETAH_PREDICTED_FLAG, 2)
        self.last_hash = h

    def decode_quad_by_flag(self, flag, inp, pos):
        if flag == PLAIN_FLAG:
            quad = int.from_bytes(inp[pos:pos + 4], "little")
            pos += 4
            h = hash_u16(quad)
            self.chunk_b[h] = self.chunk_a[h]
            self.chunk_a[h] = quad
            self.prediction[self.last_hash] = quad
        elif flag == CHEETAH_MAP_A_FLAG:
            h = int.from_bytes(inp[pos:pos + 2], "little")
            pos += 2
            quad = self.chunk_a[h]
            self.prediction[self.last_hash] = quad
        elif flag == CHEETAH_MAP_B_FLAG:
            h = int.from_bytes(inp[pos:pos + 2], "little")
            pos += 2
            quad = self.chunk_b[h]
            self.chunk_b[h] = self.chunk_a[h]
            self.chunk_a[h] = quad
            self.prediction[self.last_hash] = quad
        else:  # predicted
            quad = self.prediction[self.last_hash]
            h = hash_u16(quad)
        self.last_hash = h
        return quad, pos


class _Lion(_ScalarCodec):
    """Dual dictionary and a 5-deep prediction queue, 3-bit flags,
    6-byte signatures (lion.rs:59-352)."""

    name = "lion"

    def __init__(self) -> None:
        super().__init__()
        self.last_hash = 0
        self.chunk_a = [0] * (1 << HASH_BITS)
        self.chunk_b = [0] * (1 << HASH_BITS)
        self.pred = [[0] * 5 for _ in range(1 << HASH_BITS)]

    def write_signature(self, out, sig):
        # only 6 of the 8 bytes are written (lion.rs:334-336)
        out[sig.pos:sig.pos + 6] = sig.value.to_bytes(8, "little")[:6]

    def read_signature(self, inp, pos):
        # 6 significant bytes either way (lion.rs:339-351)
        return int.from_bytes(inp[pos:pos + 6], "little"), pos + 6

    def _promote(self, ctx: int, depth: int, quad: int) -> None:
        """A hit at `depth` moves to the front, shifting 0..depth-1 down;
        a miss (depth 5) shifts the whole queue (lion.rs:50-57)."""
        q = self.pred[ctx]
        for k in range(min(depth, 4), 0, -1):
            q[k] = q[k - 1]
        q[0] = quad

    def encode_quad(self, quad, out, sig):
        h = hash_u16(quad)
        q = self.pred[self.last_hash]
        if quad in q:
            depth = q.index(quad)
            sig.push(LION_PREDICTED_A_FLAG + depth, 3)
            if depth:
                self._promote(self.last_hash, depth, quad)
        elif self.chunk_a[h] == quad:
            sig.push(LION_MAP_A_FLAG, 3)
            out.extend(h.to_bytes(2, "little"))
            self._promote(self.last_hash, 5, quad)
        else:
            if self.chunk_b[h] == quad:
                sig.push(LION_MAP_B_FLAG, 3)
                out.extend(h.to_bytes(2, "little"))
            else:
                sig.push(PLAIN_FLAG, 3)
                out.extend(quad.to_bytes(4, "little"))
            self.chunk_b[h] = self.chunk_a[h]
            self.chunk_a[h] = quad
            self._promote(self.last_hash, 5, quad)
        self.last_hash = h

    def decode_quad_by_flag(self, flag, inp, pos):
        ctx = self.last_hash
        if flag in (PLAIN_FLAG, LION_MAP_A_FLAG, LION_MAP_B_FLAG):
            if flag == PLAIN_FLAG:
                quad = int.from_bytes(inp[pos:pos + 4], "little")
                pos += 4
                h = hash_u16(quad)
            else:
                h = int.from_bytes(inp[pos:pos + 2], "little")
                pos += 2
                quad = (self.chunk_a if flag == LION_MAP_A_FLAG
                        else self.chunk_b)[h]
            if flag != LION_MAP_A_FLAG:
                self.chunk_b[h] = self.chunk_a[h]
                self.chunk_a[h] = quad
            self._promote(ctx, 5, quad)
        else:
            depth = flag - LION_PREDICTED_A_FLAG  # 0..4
            quad = self.pred[ctx][depth]
            h = hash_u16(quad)
            if depth:
                self._promote(ctx, depth, quad)
        self.last_hash = h
        return quad, pos


_SCALAR = {"chameleon": _Chameleon, "cheetah": _Cheetah, "lion": _Lion}


def encode_scalar(data: bytes, codec: str = "chameleon") -> bytes:
    """The reference encoder of `codec`, one quad at a time."""
    return _SCALAR[codec]().encode(bytes(data))


def decode_scalar(data: bytes, codec: str = "chameleon") -> bytes:
    """The reference decoder of `codec`, one quad at a time."""
    return _SCALAR[codec]().decode(bytes(data))
