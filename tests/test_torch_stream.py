"""The port's chunked sessions (`density_tpu_torch.stream`) against the
JAX package's (`density_tpu.stream`), on the CPU: the cases of
`test_stream.py`, each session's bytes equal to the JAX package's
session and to the one-shot encoder, the held-byte count read from the
runtime, the poisoned decoder until `reset()`, and the context manager.
"""

import ctypes
import random

import pytest

from density_tpu import native as jnative
from density_tpu import stream as jstream
import density_tpu_torch
from density_tpu_torch import native as pnative
from density_tpu_torch import stream as pstream
from density_tpu_torch.errors import DecodeError, EncodeError

CODECS = ["chameleon", "cheetah", "lion"]


def _chunks(data, sizes):
    out, p = [], 0
    it = iter(sizes)
    while p < len(data):
        n = next(it)
        out.append(data[p:p + n])
        p += n
    return out


def _sizes(seed, choices):
    rng = random.Random(seed)
    while True:
        yield rng.choice(choices)


def _encode(mod, codec, chunks):
    with mod.StreamEncoder(codec) as enc:
        return b"".join(enc.update(c) for c in chunks) + enc.finish()


def _decode(mod, codec, chunks):
    with mod.StreamDecoder(codec) as dec:
        return b"".join(dec.update(c) for c in chunks) + dec.finish()


@pytest.mark.parametrize("codec", CODECS)
def test_stream_encode_matches_jax(codec):
    rng = random.Random(4)
    text = (b"streaming state carried across chunk boundaries! " * 300)
    data = text + rng.randbytes(2000) + text[:777]
    chunks = _chunks(data, _sizes(4, [1, 3, 17, 100, 256, 1000, 4096]))
    got = _encode(pstream, codec, chunks)
    assert got == _encode(jstream, codec, chunks)
    assert got == pnative.encode(codec, data) == jnative.encode(codec, data)


@pytest.mark.parametrize("codec", CODECS)
def test_stream_decode_matches_jax(codec):
    rng = random.Random(9)
    text = (b"chunked decoding with carried dictionaries. " * 400)
    data = text + rng.randbytes(1500) + text[:333]
    chunks = _chunks(pnative.encode(codec, data),
                     _sizes(9, [1, 7, 64, 300, 2048]))
    assert _decode(pstream, codec, chunks) == data
    assert _decode(jstream, codec, chunks) == data


@pytest.mark.parametrize("codec", CODECS)
def test_held_bytes_match_jax(codec):
    """The held count comes from the runtime after every update, the
    same as the JAX package's session, and finish() empties it."""
    data = b"held byte accounting " * 150
    enc = pnative.encode(codec, data)
    for mod_p, mod_j, src in ((pstream.StreamEncoder, jstream.StreamEncoder,
                               data),
                              (pstream.StreamDecoder, jstream.StreamDecoder,
                               enc)):
        with mod_p(codec) as p, mod_j(codec) as j:
            for c in _chunks(src, _sizes(1, [5, 33, 250])):
                assert p.update(c) == j.update(c)
                assert p._held == j._held
            assert p.finish() == j.finish()
            assert p._held == 0


@pytest.mark.parametrize("codec", CODECS)
def test_stream_reset_is_clear_state(codec):
    data = b"state to be cleared between runs " * 100
    with pstream.StreamEncoder(codec) as enc:
        first = enc.update(data) + enc.finish()
        with pytest.raises(EncodeError):
            enc.update(b"more")
        enc.reset()
        second = enc.update(data) + enc.finish()
    assert first == second == jnative.encode(codec, data)


@pytest.mark.parametrize("codec", CODECS)
def test_stream_decode_poisoned_until_reset(codec):
    """A failed decode may have advanced the dictionaries: every later
    call fails until reset()."""
    data = b"poison contract regression " * 200
    enc = pnative.encode(codec, data)
    with pstream.StreamDecoder(codec) as dec:
        lib = dec._lib
        tiny = ctypes.create_string_buffer(1)
        w = lib.dtpu_stream_decode(dec._st, enc, len(enc), tiny, 1, 1)
        assert w == ctypes.c_size_t(-1).value
        with pytest.raises(DecodeError, match="poisoned"):
            dec.finish(enc)
        dec.reset()
        assert dec.finish(enc) == data
        with pytest.raises(DecodeError):
            dec.update(b"")


@pytest.mark.parametrize("codec", CODECS)
def test_stream_roundtrip_incompressible(codec):
    rng = random.Random(77)
    data = rng.randbytes(5000) + b"compressible tail " * 50
    chunks = [data[:1234], data[1234:]]
    got = _encode(pstream, codec, chunks)
    assert got == _encode(jstream, codec, chunks) == jnative.encode(codec,
                                                                    data)
    assert _decode(pstream, codec, [got[:999], got[999:]]) == data


def test_exports_and_errors(monkeypatch):
    assert density_tpu_torch.StreamEncoder is pstream.StreamEncoder
    assert density_tpu_torch.StreamDecoder is pstream.StreamDecoder
    with pytest.raises(EncodeError):
        pstream.StreamEncoder("zstd")
    enc = pstream.StreamEncoder("chameleon")
    enc.close()
    enc.close()  # closing twice is harmless
    monkeypatch.setenv("DENSITY_TPU_NO_NATIVE", "1")
    with pytest.raises(RuntimeError, match="DENSITY_TPU_NO_NATIVE"):
        pstream.StreamDecoder("lion")
