"""Container compression and decompression over devices and processes.

Counterpart of the JAX package's `parallel/sharding.py`. Streams form
the leading (batch) axis of every tensor. In a `torch.distributed` run
each process takes a contiguous part of the streams (`mesh.shares` over
the processes), and splits its part again into contiguous shares, one
for each of its devices (`mesh.resolve_devices`). Every share runs on its
own device; over several devices the shares run at once, each a task of
`mesh.run_shares` (a worker thread and a CUDA stream of its own) that
stages its streams, runs them and reads their results back, handing the
host to another worker while it waits for its card (`hostsync`). Nothing
crosses devices or processes inside the encode or the decode. Only the
compressed or decoded bytes are gathered, in stream order
(`all_gather_object` over the gloo group), so every process returns the
whole container, or the whole data. A container does not depend on the
number of devices or processes.

Encode runs each codec's `PIPELINE` on the device: a share's full
streams as one batch; the ragged final stream as its own batch on the
first device of the process that owns it, at a capacity bucketed to its
length, a task of its own. A batch whose fixed point does not converge
is encoded by the native runtime instead.

Decode scans every stream on the host (`native.scan_many`, which also
counts the predicted tokens) in every process, checks each stream's
decoded length against the one it was given, and then takes one of two
routes for the whole container, as the JAX package's explicit-device
route does: a cheetah or lion container whose predicted share is above
`PREDICTED_DEVICE_CUTOFF` decodes on the native runtime's thread pool
(where there is one); every other container decodes on the devices,
each share's words and flags read back in one copy by its task and
joined by the caller in stream order, the ragged-tail bytes stamped on
the host, and a cheetah or lion
stream whose context fixpoint did not converge decoded again by the
native runtime. The route is chosen from the whole container, so every
share and every process takes the same one; the JAX package's
multi-process decode always takes the device (`jax.process_count() ==
1` gates its pool), and the bytes are the same either way.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from density_tpu_torch import host_scan, native
from density_tpu_torch.codecs import chameleon, cheetah, lion
from density_tpu_torch.constants import SPECS
from density_tpu_torch.container import (
    build_header, parse_header, split_streams)
from density_tpu_torch.engine import layout, unlayout
from density_tpu_torch.errors import DecodeError, EncodeError
from density_tpu_torch.hostsync import read, to_card, waiting
from density_tpu_torch.kernels import unpack
from density_tpu_torch.parallel.mesh import (
    process_count, process_index, resolve_devices, run_shares, shares)
from density_tpu_torch.tracing import span, traced

CODECS = {"chameleon": chameleon, "cheetah": cheetah, "lion": lion}

# Above this predicted-token share a cheetah or lion container decodes on
# the host pool (the JAX package's cutoff, `sharding.py:316`, which comes
# from TPU measurements: there the context fixpoint converged up to
# about 4% (cheetah) and 1.3% (lion) predicted tokens and diverged near
# 10%). Kept until H100 figures say otherwise.
PREDICTED_DEVICE_CUTOFF = 0.02

# The most output bytes a stream's byte can give: chameleon's densest
# token (a map) turns 2 stored bytes into 4; a block of predicted quads
# stores its signature alone (cheetah 8 bytes for 128, lion 6 for 64).
MAX_EXPANSION = {"chameleon": 2, "cheetah": 16, "lion": 64 / 6}


def codec_module(codec: str, error: type = EncodeError):
    """The device codec module of `codec`; raises `error` for an unknown
    codec."""
    if codec not in CODECS:
        raise error(f"unknown codec {codec!r}")
    return CODECS[codec]


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


@traced("sharding.stage")
def stage_encode(buf: np.ndarray, n: int, s_real: int, cap_bytes: int,
                 stream_size: int, dev):
    """Device inputs of one encode batch: (quads, nbytes)."""
    padded = _stage_streams_u8(buf, n, s_real, cap_bytes, stream_size)
    nbytes = np.clip(n - np.arange(s_real, dtype=np.int64) * stream_size,
                     0, stream_size).astype(np.int32)
    return layout.stage_quads(padded, dev), to_card(nbytes, dev)


def _encode_batch_to_parts(codec, buf, offset, n, s_real, cap_bytes,
                           stream_size, dev):
    """Encode s_real streams of buf[offset:offset + n] (stream_size bytes
    each, the last possibly short); returns the compressed streams."""
    quads, nbytes = stage_encode(buf[offset:offset + n], n, s_real,
                                 cap_bytes, stream_size, dev)
    out, totals, converged = layout.run_encode(codec_module(codec).PIPELINE,
                                               quads, nbytes)
    if not converged:  # pathological streams: the exact host encoder
        with span("native.encode"), waiting():
            return native.encode_many(codec, [
                buf[offset + s * stream_size:
                    min(offset + (s + 1) * stream_size, offset + n)].tobytes()
                for s in range(s_real)])
    with span("sharding.fetch"):
        totals = read(totals)
        max_words = (int(totals.max()) + 1) // 2
        # u16 values in int32 -> int16 (two's complement) -> u16 on the host
        out_np = read(out[:, :max_words].to(torch.int16)).view("<u2")
        return [out_np[s, :(int(totals[s]) + 1) // 2].tobytes()
                [:int(totals[s])] for s in range(s_real)]


def _part(S: int) -> tuple[int, int]:
    """This process's contiguous part [lo, hi) of S streams."""
    return shares(S, process_count())[process_index()]


def _gather(work, error: type) -> list:
    """Runs `work()` (this process's list of parts) and returns every
    process's lists joined in rank (so stream) order. Every rank reaches
    the gather, also one whose work raised, so a fault in one rank's part
    raises on every rank (`error` on the others) and none waits for it."""
    if process_count() == 1:
        return work()
    import torch.distributed as dist
    try:
        mine, fault = work(), None
    except Exception as e:  # noqa: BLE001 - re-raised after the gather
        mine, fault = None, e
    every = [None] * process_count()
    dist.all_gather_object(
        every, (mine, None if fault is None else f"{type(fault).__name__}: "
                                                   f"{fault}"))
    if fault is not None:
        raise fault
    for rank, (_, what) in enumerate(every):
        if what is not None:
            raise error(f"rank {rank} failed: {what}")
    return [p for parts, _ in every for p in parts]


@traced("container.compress")
def compress(data: bytes, codec: str, stream_size: int, device=None) -> bytes:
    codec_module(codec)
    devs = resolve_devices(device)
    block = SPECS[codec].block_size
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    n = buf.size
    if n == 0:
        return build_header(codec, 0, stream_size, [])
    s_real = split_streams(n, stream_size)
    s_full = n // stream_size
    lo, hi = _part(s_real)

    def encode_part():
        cap = layout.bucket_bytes(stream_size, block)
        tasks = [(dev, partial(
            _encode_batch_to_parts, codec, buf, (lo + a) * stream_size,
            (b - a) * stream_size, b - a, cap, stream_size, dev))
            for (a, b), dev in zip(
                shares(max(0, min(hi, s_full) - lo), len(devs)), devs)
            if b > a]
        if s_full < s_real and lo <= s_full < hi:  # the ragged final stream
            tail = n - s_full * stream_size
            cap_tail = layout.bucket_bytes(tail, block)
            tasks.append((devs[0], partial(
                _encode_batch_to_parts, codec, buf, s_full * stream_size,
                tail, 1, cap_tail, cap_tail, devs[0])))
        return [p for parts in run_shares(devs, tasks) for p in parts]
    parts = _gather(encode_part, EncodeError)
    if len(parts) != s_real:
        raise AssertionError("stream count mismatch")
    return build_header(codec, n, stream_size,
                        [len(p) for p in parts]) + b"".join(parts)


# ---------------------------------------------------------------------------
# Decompression
# ---------------------------------------------------------------------------

@traced("native.scan")
def _scan(codec, streams, out_lens):
    """Scan every stream on the host and check each against its decoded
    length. A stream of decoded length 0 is neither scanned nor checked,
    as the reference's pool skips it; every other stream must decode to
    exactly its length, else DecodeError. The block capacity follows the
    longest decoded stream, its quads padded as encode pads them, so a
    small input costs a small decode. Returns (in_offsets, is_copy,
    block counts) per stream and the predicted-token share."""
    spec = SPECS[codec]
    S = len(streams)
    for stream, out_len in zip(streams, out_lens):
        if out_len > MAX_EXPANSION[codec] * len(stream):
            raise DecodeError("stream too short for its decoded length")
    live = [s for s in range(S) if out_lens[s] > 0]
    nb_cap = layout.pad_quads(
        -(-int(max(out_lens, default=0)) // spec.block_size)
        * spec.quads_per_block
    ) // spec.quads_per_block
    bio, boo, bcp, nbs, pred, tot = native.scan_many(
        codec, [streams[s] for s in live], nb_cap)
    woff = np.zeros((S, nb_cap), np.int32)
    copyf = np.zeros((S, nb_cap), bool)
    nb_real = np.zeros(S, np.int32)
    for j, s in enumerate(live):
        nb = int(nbs[j])
        got = host_scan.decoded_length(streams[s], bio[j, :nb], boo[j, :nb],
                                       bcp[j, :nb], codec)
        if got != out_lens[s]:
            raise DecodeError(f"stream {s} decodes to {got} bytes, its "
                              f"length is {int(out_lens[s])}")
        nb_real[s] = nb
        woff[s, :nb] = bio[j, :nb] // 2
        copyf[s, :nb] = bcp[j, :nb].astype(bool)
    pred_frac = float(pred.sum()) / max(1, int(tot.sum()))
    return woff, copyf, nb_real, pred_frac


@traced("sharding.stage")
def _stage(streams, out_lens, woff, copyf, nb_real, dev):
    """Device inputs of the decode: (words, woff, is_copy, nb_real,
    out_len), the words (S, W) u16 values in int32."""
    S = len(streams)
    cap_words = (max((len(streams[s]) for s in range(S) if out_lens[s] > 0),
                     default=0) + 1) // 2
    words = np.zeros((S, cap_words), dtype=np.int32)
    for s in range(S):
        if out_lens[s] > 0:
            raw = np.frombuffer(streams[s], dtype=np.uint8)
            u16 = np.zeros(2 * cap_words, np.uint8)
            u16[:raw.size] = raw
            words[s] = u16.view("<u2")
    return tuple(to_card(a, dev) for a in (
        words, woff, copyf, nb_real, np.asarray(out_lens, np.int32)))


@traced("engine.decode")
def decode_batch(words, woff, is_copy, nb_real, out_len,
                 codec: str = "chameleon"):
    """Device decode of staged streams: (S, NB * BLOCK / 2) int32
    halfwords; chameleon's one-element malformed-block flag (unpack's);
    cheetah's and lion's (S,) flags of the streams whose context fixpoint
    did not converge. All stay on the device; a flag a codec does not
    make is None. The chameleon decode makes no host sync; the others'
    fixpoint makes one a round."""
    if codec == "chameleon":
        return (*unlayout.decode_chameleon_batch(words, woff, is_copy,
                                                 nb_real, out_len), None)
    out, ok, _ = codec_module(codec, DecodeError).decode_batch(
        words, woff, is_copy, nb_real, out_len)
    return out, None, ~ok


@traced("sharding.fetch")
def _fetch(out_words, bad, redo, max_words: int):
    """One share's halfwords and flags in one host copy: (u16 (S,
    max_words) halfwords, malformed flag, (S,) redo flags)."""
    S = out_words.shape[0]
    flags = [f.reshape(-1) for f in (bad, redo) if f is not None]
    n_flag = sum(f.numel() for f in flags)
    host = torch.empty(S * max_words + n_flag, dtype=torch.int16,
                       device=out_words.device)
    # u16 values in int32 -> int16 (two's complement) -> u16 on the host
    host[:S * max_words].view(S, max_words).copy_(out_words[:, :max_words])
    if flags:
        host[S * max_words:].copy_(torch.cat(flags))
    host = read(host)
    tail = host[S * max_words:]
    again = (tail[-S:] != 0) if redo is not None else np.zeros(S, bool)
    return (host[:S * max_words].view("<u2").reshape(S, max_words),
            bad is not None and bool(tail[0]), again)


def _finish(out_words, bad, redo, streams, out_lens, copyf, nb_real,
            codec: str = "chameleon") -> list[bytes]:
    """Device halfwords -> per-stream bytes: `out_words`, `bad` and
    `redo` are one share's (`decode_batch`'s results), or lists of the
    shares' in stream order, each fetched (`_fetch`) and then joined
    (`_join`)."""
    if isinstance(out_words, torch.Tensor):
        out_words, bad, redo = [out_words], [bad], [redo]
    max_words = (int(max(out_lens, default=0)) + 1) // 2
    return _join([_fetch(w, b, r, max_words)
                  for w, b, r in zip(out_words, bad, redo)],
                 streams, out_lens, copyf, nb_real, codec)


@traced("sharding.join")
def _join(fetched, streams, out_lens, copyf, nb_real,
          codec: str = "chameleon") -> list[bytes]:
    """The shares' fetched halfwords and flags (`_fetch`'s, in stream
    order) -> per-stream bytes. A set malformed flag raises DecodeError
    before any bytes are returned, and a stream flagged for redo is
    decoded by the native runtime instead. A ragged tail is stamped from
    its stream's last bytes (stored raw) unless its last block is a copy
    block, which holds them already."""
    if any(f[1] for f in fetched):
        raise unpack.malformed()
    out_np = np.concatenate([f[0] for f in fetched])
    again = np.concatenate([f[2] for f in fetched])
    parts = []
    for s, stream in enumerate(streams):
        ol = int(out_lens[s])
        if ol == 0:
            parts.append(b"")
            continue
        if again[s]:
            with span("native.decode"):
                parts.append(native.decode(codec, stream,
                                           decoded_size_hint=ol))
            continue
        chunk = bytearray(out_np[s, :(ol + 1) // 2].tobytes()[:ol])
        ragged = ol % 4
        if ragged and not copyf[s, nb_real[s] - 1]:
            chunk[-ragged:] = stream[-ragged:]
        parts.append(bytes(chunk))
    return parts


def _streams(data: bytes):
    """Header parse: (codec, original_len, streams, decoded lengths). A
    header of no streams but a nonzero length raises as the reference's
    length check does."""
    codec, original_len, stream_size, lengths, off = parse_header(data)
    if int(lengths.sum()) != len(data) - off:
        raise DecodeError("stream table does not match payload size")
    if not len(lengths) and original_len:
        raise DecodeError(f"decoded 0 bytes, expected {original_len}")
    s_real = len(lengths)
    out_lens = np.clip(
        original_len - np.arange(s_real, dtype=np.int64) * stream_size,
        0, stream_size)
    offsets = off + np.concatenate([[0], np.cumsum(lengths)])
    streams = [data[offsets[s]:offsets[s + 1]] for s in range(s_real)]
    return codec, original_len, streams, out_lens


def _stage_shares(streams, out_lens, woff, copyf, nb_real, lo, hi, devs):
    """The device inputs of streams [lo, hi) split into one share per
    device: [(a, b, device_args)], device_args None for a share whose
    streams all decode to 0 bytes; empty shares left out."""
    staged = []
    for (a, b), dev in zip(shares(hi - lo, len(devs)), devs):
        a, b = lo + a, lo + b
        if b > a:
            staged.append((a, b, _stage(streams[a:b], out_lens[a:b],
                                        woff[a:b], copyf[a:b], nb_real[a:b],
                                        dev)
                           if any(out_lens[a:b]) else None))
    return staged


def _decode_share(codec, streams, out_lens, woff, copyf, nb_real, a, b,
                  dev, max_words: int):
    """One share's task: stage streams [a, b) on `dev`, decode them there
    (`decode_batch`, the cheetah and lion rounds included) and fetch the
    halfwords and flags (`_fetch`)."""
    args = _stage(streams[a:b], out_lens[a:b], woff[a:b], copyf[a:b],
                  nb_real[a:b], dev)
    return _fetch(*decode_batch(*args, codec), max_words)


def _decode_shares(codec, streams, out_lens, woff, copyf, nb_real, lo, hi,
                   devs):
    """Decode streams [lo, hi) in one share a device, each share a task
    of `run_shares` (a share whose streams all decode to 0 bytes has
    none), and join the bytes in stream order."""
    max_words = (int(max(out_lens[lo:hi], default=0)) + 1) // 2
    split = [(lo + a, lo + b, dev, any(out_lens[lo + a:lo + b]))
             for (a, b), dev in zip(shares(hi - lo, len(devs)), devs)]
    live = [(a, b, dev) for a, b, dev, has in split if has]
    fetched = run_shares(devs, [(dev, partial(
        _decode_share, codec, streams, out_lens, woff, copyf, nb_real, a, b,
        dev, max_words)) for a, b, dev in live])
    got = iter(_join(
        fetched, [streams[s] for a, b, _ in live for s in range(a, b)],
        np.concatenate([out_lens[a:b] for a, b, _ in live]),
        np.concatenate([copyf[a:b] for a, b, _ in live]),
        np.concatenate([nb_real[a:b] for a, b, _ in live]),
        codec) if live else [])
    return [next(got) if has else b""
            for a, b, _, has in split for _ in range(a, b)]


def decode_prep(data: bytes, device=None):
    """Header parse, host block scan and staging of this process's
    streams. Returns (device_args, streams, host_meta), host_meta =
    (codec, original_len, out_lens, copyf, nb_real, predicted share).
    With one device, device_args are the inputs of `decode_batch` on
    it; with None or a list of devices, a list of (lo, hi, inputs) of
    the shares, inputs None where every stream decodes to 0 bytes."""
    one = device is not None and not isinstance(device, (list, tuple))
    devs = resolve_devices(device)
    codec, original_len, streams, out_lens = _streams(data)
    codec_module(codec, DecodeError)
    woff, copyf, nb_real, pred_frac = _scan(codec, streams, out_lens)
    lo, hi = _part(len(streams))
    if one:
        args = _stage(streams[lo:hi], out_lens[lo:hi], woff[lo:hi],
                      copyf[lo:hi], nb_real[lo:hi], devs[0])
    else:
        args = _stage_shares(streams, out_lens, woff, copyf, nb_real, lo,
                             hi, devs)
    return args, streams, (codec, original_len, out_lens, copyf, nb_real,
                           pred_frac)


def route(codec: str, pred_frac: float) -> str:
    """"pool" (the native runtime's thread pool) or "device": the JAX
    package's explicit-device route."""
    if (codec != "chameleon" and pred_frac > PREDICTED_DEVICE_CUTOFF
            and native.is_available()):
        return "pool"
    return "device"


@traced("container.decompress")
def decompress(data: bytes, device=None) -> bytes:
    codec, original_len, streams, out_lens = _streams(data)
    if original_len == 0:
        return b""
    devs = resolve_devices(device)
    codec_module(codec, DecodeError)
    woff, copyf, nb_real, pred_frac = _scan(codec, streams, out_lens)
    lo, hi = _part(len(streams))

    def decode_part():
        if route(codec, pred_frac) == "pool":
            live = [s for s in range(lo, hi) if out_lens[s] > 0]
            with span("native.decode"):
                return native.decode_many(codec, [streams[s] for s in live],
                                          [int(out_lens[s]) for s in live])
        return _decode_shares(codec, streams, out_lens, woff, copyf,
                              nb_real, lo, hi, devs)
    out = b"".join(_gather(decode_part, DecodeError))
    if len(out) != original_len:
        raise DecodeError(f"decoded {len(out)} bytes, expected {original_len}")
    return out


def decode_streams(streams, out_lens=None, device=None,
                   codec: str = "chameleon") -> list[bytes]:
    """Decode bare streams on the device, or in shares over a list of
    devices (this process's streams alone: no gather); out_lens (the
    decoded sizes) come from the block scan when not given."""
    devs = resolve_devices(device)
    codec_module(codec, DecodeError)
    if out_lens is None:
        out_lens = []
        for s in streams:
            if not s:
                out_lens.append(0)
                continue
            io, oo, cp = native.scan(codec, s)
            out_lens.append(host_scan.decoded_length(s, io, oo, cp, codec))
    if not any(out_lens):
        return [b""] * len(streams)
    out_lens = np.asarray(out_lens, np.int64)
    woff, copyf, nb_real, _ = _scan(codec, streams, out_lens)
    return _decode_shares(codec, streams, out_lens, woff, copyf, nb_real, 0,
                          len(streams), devs)
