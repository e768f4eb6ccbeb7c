"""The port's decode checks each stream against its decoded length, as the
JAX package's default decompress route does, and carries unpack's
malformed-block flag to the host with the decoded words.

Containers are made by the JAX package from seeded text, then their
header's `original_len` (bytes 8-15) is rewritten. The port
(`device="cpu"`) must raise DecodeError exactly where the reference's
default route raises (its host pool, `density_tpu/parallel/sharding.py`
`decompress`), and return the same bytes where it returns. Every
comparison is exact.
"""

import numpy as np
import pytest
import torch

from density_tpu import container as jcontainer
from density_tpu import native
from density_tpu.errors import DecodeError as JDecodeError
from density_tpu.parallel import sharding as jsharding
from density_tpu_torch import container as pcontainer
from density_tpu_torch import native as pnative
from density_tpu_torch.errors import DecodeError
from density_tpu_torch.kernels import unpack
from density_tpu_torch.parallel import sharding

torch.set_num_threads(1)

N_BYTES = 5000
# (stream size, header length): lengths that cut or overrun the last
# stream, and lengths that end on a stream boundary, so that a trailing
# stream holds bytes but has decoded length 0
HEADER_LENS = (
    [(1000, n) for n in (5000, 4999, 4997, 4995, 5001, 5003, 4000, 3000,
                         3003)]
    + [(1001, n) for n in (5000, 4999, 4997, 4995, 5001, 5003, 4000, 3003,
                           3000)])


def _text(n=N_BYTES):
    rng = np.random.default_rng(41)
    words = [b"the quick brown fox ", b"jumps over ", b"lazy dog ",
             b"density ", b"chameleon\n"]
    return b"".join(words[i] for i in rng.integers(0, 5, n // 4 + 1))[:n]


def _with_len(blob, original_len):
    return blob[:8] + original_len.to_bytes(8, "little") + blob[16:]


def _pool_route(blob):
    """The reference's default route, its host pool: every stream of
    nonzero decoded length decoded within that length, then the total
    checked. Called directly when the native library did not build in
    this process (the pool then runs its pure-Python fallback), since
    `decompress` would then take the device route."""
    codec, original_len, stream_size, lengths, off = (
        jcontainer.parse_header(blob))
    if original_len == 0:
        return b""
    ends = off + np.cumsum(lengths)
    streams = [blob[e - n:e] for e, n in zip(ends, lengths)]
    out_lens = np.clip(original_len - np.arange(len(lengths)) * stream_size,
                       0, stream_size)
    out = jsharding._decode_host_parallel(codec, streams, out_lens,
                                          len(streams))
    if len(out) != original_len:
        raise JDecodeError(f"decoded {len(out)} bytes, expected "
                           f"{original_len}")
    return out


def _reference(blob):
    """("ok", bytes) or ("raise", None) from the reference's default
    route."""
    route = jcontainer.decompress if native.is_available() else _pool_route
    try:
        return "ok", route(blob)
    except JDecodeError:
        return "raise", None


@pytest.mark.parametrize("stream_size,original_len", HEADER_LENS)
def test_header_length_checked_as_the_reference(stream_size, original_len):
    data = _text()
    blob = _with_len(jcontainer.compress(data, "chameleon",
                                         stream_size=stream_size),
                     original_len)
    want, ref_out = _reference(blob)
    if want == "ok":
        assert pcontainer.decompress(blob, device="cpu") == ref_out
    else:
        with pytest.raises(DecodeError):
            pcontainer.decompress(blob, device="cpu")


def test_boundary_lengths_decode_and_cut_ones_raise():
    """The table's expectations, independent of the reference: a length
    on a stream boundary returns that prefix; one that cuts a stream
    raises."""
    data = _text()
    blob = jcontainer.compress(data, "chameleon", stream_size=1000)
    assert pcontainer.decompress(_with_len(blob, 4000), device="cpu") == (
        data[:4000])
    for n in (4999, 4000 - 1, 5001):
        with pytest.raises(DecodeError):
            pcontainer.decompress(_with_len(blob, n), device="cpu")


def _streams(stream_size=1000):
    data = _text()
    blob = jcontainer.compress(data, "chameleon", stream_size=stream_size)
    _, _, _, lengths, off = jcontainer.parse_header(blob)
    ends = off + np.cumsum(lengths)
    streams = [blob[e - n:e] for e, n in zip(ends, lengths)]
    chunks = [data[i:i + stream_size]
              for i in range(0, len(data), stream_size)]
    return streams, chunks


@pytest.mark.parametrize("which,delta", [
    (1, -1), (1, -3), (1, 1), (1, 3), (4, -2), (4, 4), (0, -1000 + 3)])
def test_decode_streams_rejects_wrong_lengths(which, delta):
    streams, chunks = _streams()
    out_lens = [len(c) for c in chunks]
    assert sharding.decode_streams(streams, out_lens, device="cpu") == chunks
    out_lens[which] += delta
    with pytest.raises(DecodeError):
        sharding.decode_streams(streams, out_lens, device="cpu")


def test_decode_streams_skips_zero_lengths():
    """A stream of decoded length 0 is neither scanned nor decoded, as
    the reference's pool skips it: even a malformed one."""
    streams, chunks = _streams()
    out_lens = [len(c) for c in chunks]
    out_lens[2] = 0
    streams[2] = b"\x01"  # not a chameleon stream
    got = sharding.decode_streams(streams, out_lens, device="cpu")
    assert got == chunks[:2] + [b""] + chunks[3:]


def test_malformed_flag_raises_in_finish(monkeypatch):
    """A block offset past the words (no valid stream makes one, so the
    scan is rewritten) reaches unpack, whose flag comes back with the
    words and raises DecodeError in `_finish`."""
    data = _text(3 * 65536 + 11)
    blob = pcontainer.compress(data, "chameleon", 65536, device="cpu")
    scan = pnative.scan_many

    def bad_scan(codec, streams, max_blocks):
        bio, *rest = scan(codec, streams, max_blocks)
        bio[1, 3] = 2 * (max(len(s) for s in streams) + 100)
        return (bio, *rest)

    finished = []
    finish = sharding._finish

    def spy(*args):
        finished.append(int(args[1][0]))
        return finish(*args)

    monkeypatch.setattr(pnative, "scan_many", bad_scan)
    monkeypatch.setattr(sharding, "_finish", spy)
    with pytest.raises(DecodeError, match="malformed"):
        pcontainer.decompress(blob, device="cpu")
    assert finished == [1]


def test_unpack_flagged_zeroes_bad_blocks():
    """unpack_flagged returns the flag instead of raising: the malformed
    block's outputs are zeros and every other block equals unpack's."""
    data = _text(65536 + 7)
    blob = pcontainer.compress(data, "chameleon", 65536, device="cpu")
    (words, woff, is_copy, nb_real, _), _, _ = sharding.decode_prep(
        blob, device="cpu")
    live = torch.arange(woff.shape[1])[None, :] < nb_real[:, None]
    woff = torch.where(live, woff, -1)
    kw = dict(q=64, sig_words=4, flag_bits=1)
    good = unpack.unpack(words, woff, is_copy, **kw)
    *got, bad = unpack.unpack_flagged(words, woff, is_copy, **kw)
    assert bad.shape == (1,) and int(bad[0]) == 0
    for g, w in zip(got, good):
        assert torch.equal(g, w)
    woff[0, 2] = words.shape[1] - 1  # its signature runs past the words
    *got, bad = unpack.unpack_flagged(words, woff, is_copy, **kw)
    assert int(bad[0]) == 1
    for g, w in zip(got, good):
        assert not g[0, 128:192].any()
        assert torch.equal(g[:, :128], w[:, :128])
        assert torch.equal(g[:, 192:], w[:, 192:])
    with pytest.raises(DecodeError):
        unpack.unpack(words, woff, is_copy, **kw)
