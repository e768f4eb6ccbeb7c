"""Container compression/decompression on one device.

Counterpart of the JAX package's `parallel/sharding.py` for chameleon on
one device. Streams form the leading (batch) axis of every tensor; the
full streams run as one batch and the ragged final stream as its own
batch at a capacity bucketed to its length. Encode and decode both run
on the device; the host stages bytes, scans block offsets before decode
(checking each stream's decoded length against the one it was given)
and, after it, reads the words and unpack's malformed-block flag in one
copy and stamps the ragged-tail bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from density_tpu_torch import host_scan
from density_tpu_torch.codecs import chameleon
from density_tpu_torch.constants import CHAMELEON as SPEC
from density_tpu_torch.container import (
    build_header, parse_header, split_streams)
from density_tpu_torch.engine import layout, unlayout
from density_tpu_torch.errors import DecodeError
from density_tpu_torch.kernels import unpack
from density_tpu_torch.parallel.mesh import resolve_device

BLOCK = SPEC.block_size


def _stage_streams_u8(buf: np.ndarray, n: int, s_pad: int, cap_bytes: int,
                      stream_size: int) -> np.ndarray:
    """(s_pad, cap_bytes) u8, zero-padded: full streams by one reshape,
    the ragged final stream copied alone."""
    padded = np.zeros((s_pad, cap_bytes), dtype=np.uint8)
    full = n // stream_size
    if full:
        padded[:full, :stream_size] = buf[:full * stream_size].reshape(
            full, stream_size)
    rem = n - full * stream_size
    if rem:
        padded[full, :rem] = buf[full * stream_size:]
    return padded


def stage_encode(buf: np.ndarray, n: int, s_real: int, cap_bytes: int,
                 stream_size: int, dev):
    """Device inputs of one encode batch: (quads, nbytes)."""
    padded = _stage_streams_u8(buf, n, s_real, cap_bytes, stream_size)
    nbytes = np.clip(n - np.arange(s_real, dtype=np.int64) * stream_size,
                     0, stream_size).astype(np.int32)
    return (layout.stage_quads(padded, dev),
            torch.from_numpy(nbytes).to(dev))


def _encode_batch_to_parts(buf, offset, n, s_real, cap_bytes, stream_size,
                           dev):
    """Encode s_real streams of buf[offset:offset + n] (stream_size bytes
    each, the last possibly short); returns the compressed streams."""
    quads, nbytes = stage_encode(buf[offset:offset + n], n, s_real,
                                 cap_bytes, stream_size, dev)
    out, totals, converged = layout.run_encode(chameleon.PIPELINE, quads,
                                               nbytes)
    if not converged:  # pathological streams: exact scalar fallback
        return [host_scan.encode_scalar(
            buf[offset + s * stream_size:
                min(offset + (s + 1) * stream_size, offset + n)].tobytes())
            for s in range(s_real)]
    totals = totals.cpu().numpy()
    max_words = (int(totals.max()) + 1) // 2
    # u16 values in int32 -> int16 (two's complement) -> u16 on the host
    out_np = out[:, :max_words].to(torch.int16).cpu().numpy().view("<u2")
    return [out_np[s, :(int(totals[s]) + 1) // 2].tobytes()[:int(totals[s])]
            for s in range(s_real)]


def compress(data: bytes, codec: str, stream_size: int, device=None) -> bytes:
    dev = resolve_device(device)
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    n = buf.size
    if n == 0:
        return build_header(codec, 0, stream_size, [])
    s_real = split_streams(n, stream_size)
    s_full = n // stream_size
    tail = n - s_full * stream_size
    parts = []
    if s_full:
        parts += _encode_batch_to_parts(
            buf, 0, s_full * stream_size, s_full,
            layout.bucket_bytes(stream_size, BLOCK), stream_size, dev)
    if tail:
        cap_tail = layout.bucket_bytes(tail, BLOCK)
        parts += _encode_batch_to_parts(buf, s_full * stream_size, tail, 1,
                                        cap_tail, cap_tail, dev)
    if len(parts) != s_real:
        raise AssertionError("stream count mismatch")
    return build_header(codec, n, stream_size,
                        [len(p) for p in parts]) + b"".join(parts)


# ---------------------------------------------------------------------------
# Decompression
# ---------------------------------------------------------------------------

def _stage_decode(streams, out_lens, dev):
    """Scan every stream on the host, check each against its decoded
    length, and stage the device inputs: (words, woff, is_copy, nb_real,
    out_len) and the host copy flags. A stream of decoded length 0 is
    neither scanned nor staged, as the reference's pool skips it; every
    other stream must decode to exactly its length, else DecodeError is
    raised before anything reaches the device. The capacities follow
    the data (the longest compressed stream, the longest decoded one,
    its quads padded as encode pads them), not the container's stream
    size, so a small input costs a small decode."""
    S = len(streams)
    Q = SPEC.quads_per_block
    for stream, out_len in zip(streams, out_lens):
        # the densest token (a map) turns 2 stored bytes into 4
        if out_len > 2 * len(stream):
            raise DecodeError("stream too short for its decoded length")
    live = [s for s in range(S) if out_lens[s] > 0]
    cap_words = (max(len(streams[s]) for s in live) + 1) // 2
    nb_cap = layout.pad_quads(-(-int(max(out_lens)) // BLOCK) * Q) // Q
    words = np.zeros((S, cap_words), dtype=np.int32)
    woff = np.zeros((S, nb_cap), dtype=np.int32)
    copyf = np.zeros((S, nb_cap), dtype=bool)
    nb_real = np.zeros(S, dtype=np.int32)
    bio, boo, bcp, nbs, _, _ = host_scan.scan_many(
        [streams[s] for s in live], nb_cap)
    for j, s in enumerate(live):
        nb = int(nbs[j])
        got = host_scan.decoded_length(streams[s], bio[j, :nb], boo[j, :nb],
                                       bcp[j, :nb])
        if got != out_lens[s]:
            raise DecodeError(f"stream {s} decodes to {got} bytes, its "
                              f"length is {int(out_lens[s])}")
        nb_real[s] = nb
        woff[s, :nb] = bio[j, :nb] // 2
        copyf[s, :nb] = bcp[j, :nb].astype(bool)
        raw = np.frombuffer(streams[s], dtype=np.uint8)
        u16 = np.zeros(2 * cap_words, np.uint8)
        u16[:raw.size] = raw
        words[s] = u16.view("<u2")
    args = tuple(torch.from_numpy(a).to(dev) for a in (
        words, woff, copyf, nb_real, np.asarray(out_lens, np.int32)))
    return args, copyf, nb_real


def decode_batch(words, woff, is_copy, nb_real, out_len):
    """Device decode of staged streams: (S, NB * 128) int32 halfwords and
    the one-element malformed-block flag, both left on the device (no
    host sync)."""
    return unlayout.decode_chameleon_batch(words, woff, is_copy, nb_real,
                                           out_len)


def _finish(out_words, bad, streams, out_lens, copyf, nb_real) -> list[bytes]:
    """Device halfwords -> per-stream bytes, ragged tails stamped from the
    compressed streams' last bytes (they are stored raw). The halfwords
    and the malformed-block flag come back in one host copy; a set flag
    raises DecodeError before any bytes are returned."""
    S = out_words.shape[0]
    max_words = (int(max(out_lens, default=0)) + 1) // 2
    host = torch.empty(S * max_words + 1, dtype=torch.int16,
                       device=out_words.device)
    # u16 values in int32 -> int16 (two's complement) -> u16 on the host
    host[:-1].view(S, max_words).copy_(out_words[:, :max_words])
    host[-1:].copy_(bad.reshape(1))
    host = host.cpu().numpy()
    if host[-1]:
        raise unpack.malformed()
    out_np = host[:-1].view("<u2").reshape(S, max_words)
    parts = []
    for s, stream in enumerate(streams):
        ol = int(out_lens[s])
        if ol == 0:
            parts.append(b"")
            continue
        chunk = bytearray(out_np[s, :(ol + 1) // 2].tobytes()[:ol])
        ragged = ol % 4
        if ragged and not copyf[s, nb_real[s] - 1]:
            chunk[-ragged:] = stream[-ragged:]
        parts.append(bytes(chunk))
    return parts


def decode_prep(data: bytes, device=None):
    """Header parse, host block scan and staging of the device inputs.
    Returns (device_args, streams, host_meta)."""
    dev = resolve_device(device)
    codec, original_len, stream_size, lengths, off = parse_header(data)
    if codec != "chameleon":
        raise DecodeError(f"codec {codec!r} is not ported to the GPU yet")
    if int(lengths.sum()) != len(data) - off:
        raise DecodeError("stream table does not match payload size")
    s_real = len(lengths)
    out_lens = np.clip(
        original_len - np.arange(s_real, dtype=np.int64) * stream_size,
        0, stream_size)
    offsets = off + np.concatenate([[0], np.cumsum(lengths)])
    streams = [data[offsets[s]:offsets[s + 1]] for s in range(s_real)]
    args, copyf, nb_real = _stage_decode(streams, out_lens, dev)
    return args, streams, (original_len, out_lens, copyf, nb_real)


def decompress(data: bytes, device=None) -> bytes:
    _, original_len, _, _, _ = parse_header(data)
    if original_len == 0:
        return b""
    args, streams, (original_len, out_lens, copyf, nb_real) = decode_prep(
        data, device)
    parts = _finish(*decode_batch(*args), streams, out_lens, copyf,
                    nb_real)
    out = b"".join(parts)
    if len(out) != original_len:
        raise DecodeError(f"decoded {len(out)} bytes, expected {original_len}")
    return out


def decode_streams(streams, out_lens=None, device=None) -> list[bytes]:
    """Decode bare chameleon streams; out_lens (the decoded sizes) come
    from the block scan when not given."""
    dev = resolve_device(device)
    if out_lens is None:
        out_lens = []
        for s in streams:
            if not s:
                out_lens.append(0)
                continue
            io, oo, cp, _, _ = host_scan.scan_with_counts(s)
            out_lens.append(host_scan.decoded_length(s, io, oo, cp))
    if not any(out_lens):
        return [b""] * len(streams)
    args, copyf, nb_real = _stage_decode(streams, out_lens, dev)
    return _finish(*decode_batch(*args), streams, out_lens, copyf,
                   nb_real)
