"""The port's host buffers (`density_tpu_torch.io.buffer`) and LZ4
bindings (`native.lz4_*`) against the JAX package's, on the CPU."""

import numpy as np
import pytest

import density_tpu_torch
from density_tpu import native as jnative
from density_tpu.constants import SPECS as JSPECS
from density_tpu.io import buffer as jbuf
from density_tpu_torch import native as pnative
from density_tpu_torch.io import buffer as pbuf


def _ops(mod):
    """One script of calls on each buffer class; returns what each call
    gave (or the exception's type)."""
    out = []

    def rec(fn, *a):
        try:
            r = fn(*a)
            out.append(bytes(r) if isinstance(r, memoryview) else r)
        except IndexError as e:
            out.append(type(e))

    b = mod.Buffer(10)
    for call in ((b.is_empty,), (b.push, b"abcd"), (b.push, b"efghijkl"),
                 (b.remaining_space,), (len, b), (b.view,), (b.reset,),
                 (b.is_empty,), (b.push, b"xy"), (b.view,)):
        rec(*call)
    out.append(b.capacity)
    r = mod.ReadBuffer(bytes(range(1, 20)))
    for call in ((r.read_u16_le,), (r.read_u32_le,), (r.read_u64_le,),
                 (r.remaining,), (r.rewind, 3), (r.read, 4), (r.read, 9),
                 (r.read, 1)):
        rec(*call)
    out.append(r.index)
    w = mod.WriteBuffer(32)
    for call in ((w.push, b"head"), (w.skip, 4), (w.push, b"body"),
                 (w.write_at, 4, b"SIG!"), (w.rewind, 2), (w.push, b"YZ"),
                 (w.getvalue,)):
        rec(*call)
    out.append(w.index)
    return out


def test_buffers_match_jax():
    assert _ops(pbuf) == _ops(jbuf)


@pytest.mark.parametrize("data", [
    b"", b"a", b"abcabcabcabcabcabc" * 100,
    np.random.default_rng(1).integers(0, 256, 70000,
                                      dtype=np.uint8).tobytes(),
    (b"lz4 block with matches and literals " * 3000)[:100001]],
    ids=["empty", "one", "repeats", "random", "text"])
def test_lz4_matches_jax(data):
    enc = pnative.lz4_compress(data)
    assert enc == jnative.lz4_compress(data)
    assert pnative.lz4_decompress(enc, len(data)) == data
    assert jnative.lz4_decompress(enc, len(data)) == data


def test_lz4_raises_on_malformed_block():
    with pytest.raises(RuntimeError, match="malformed"):
        pnative.lz4_decompress(b"\xf0\xff\xff\xff", 100)


def test_lz4_needs_the_runtime(monkeypatch):
    monkeypatch.setenv("DENSITY_TPU_NO_NATIVE", "1")
    with pytest.raises(RuntimeError, match="DENSITY_TPU_NO_NATIVE"):
        pnative.lz4_compress(b"abc")


def test_top_level_exports_match_jax():
    assert set(density_tpu_torch.SPECS) == set(JSPECS)
    for name, spec in density_tpu_torch.SPECS.items():
        assert isinstance(spec, density_tpu_torch.CodecSpec)
        assert (spec.flag_bits, spec.sig_bytes, spec.block_size) == (
            JSPECS[name].flag_bits, JSPECS[name].sig_bytes,
            JSPECS[name].block_size)
