"""The port's small-stream slice against the JAX package on the CPU: the
choice of pack kernel, the planner's sort option, containers of 16 KiB
and 32 KiB streams (4096 and 8192 quads) and the one-shot
`encode_raw`/`decode_raw`.

Both packages get the same input bytes, made from a numpy seed; every
comparison is exact. The JAX side runs its XLA paths (Pallas kernels in
interpret mode where a test names them); the port runs each kernel's
plain PyTorch version.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from density_tpu import api as japi
from density_tpu import container as jcontainer
from density_tpu.codecs import chameleon as jcham
from density_tpu.codecs.scalar import ScalarChameleon
from density_tpu_torch import api as papi
from density_tpu_torch import container as pcontainer
from density_tpu_torch import host_scan
from density_tpu_torch.codecs import chameleon as pcham
from density_tpu_torch.engine import layout
from density_tpu_torch.errors import DecodeError, EncodeError
from density_tpu_torch.kernels import bitonic, pack, packroute

REPO = Path(__file__).resolve().parent.parent

# The test workers share the machine's cores with each other and with
# XLA; torch's own thread pool on top of them only oversubscribes it.
torch.set_num_threads(1)


def _text(rng, n):
    words = [b"the quick brown fox ", b"jumps over ", b"lazy dog ",
             b"density ", b"chameleon\n"]
    return b"".join(words[i] for i in rng.integers(0, 5, n // 4 + 1))[:n]


def _random(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _mixed(rng, n):
    return b"".join(_text(rng, 3000) + _random(rng, 3000)
                    for _ in range(n // 6000 + 1))[:n]


def _vocab_quads(rng, shape):
    vocab = rng.integers(1, 1 << 32, 61, dtype=np.uint64).astype(np.uint32)
    return vocab[rng.integers(0, 61, shape)]


# ---------------------------------------------------------------- dispatch

@pytest.mark.parametrize("mode,n_q,want", [
    ("route", 4096, "pack"), ("route", 8192, "pack"),
    ("route", 16384, "packroute"), ("onehot", 16384, "pack"),
    ("onehot", 4096, "pack")])
def test_fused_picks_the_pack_kernel(monkeypatch, mode, n_q, want):
    """packroute where n_q is a multiple of 16384 in mode "route", pack
    otherwise (the JAX package's `layout.py:243-244`)."""
    monkeypatch.setattr(layout, "PACK_MODE", mode)
    calls = []
    for name, mod in (("pack", pack), ("packroute", packroute)):
        def spy(*a, _name=name, _fn=mod.pack, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, "pack", spy)
    rng = np.random.default_rng(n_q)
    quads = torch.from_numpy(_vocab_quads(rng, (2, n_q)).view(np.int32))
    nbytes = torch.tensor([4 * n_q, 4 * n_q - 3], dtype=torch.int32)
    out, totals, ok, _ = layout.fused(pcham.PIPELINE, quads, nbytes)
    assert calls == [want]
    assert out.shape == (2, packroute.out_width(n_q, 64, 4))
    assert bool(ok.all())


def test_pack_mode_is_read_at_import():
    code = ("from density_tpu_torch.engine import layout\n"
            "print(layout.PACK_MODE, layout.pack_module(16384).__name__)\n")
    env = dict(os.environ, DENSITY_TPU_PACK="onehot", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["onehot", "density_tpu_torch.kernels.pack"]


def test_onehot_mode_container_equals_default(monkeypatch):
    data = _mixed(np.random.default_rng(3), 2 * 65536 + 5)
    want = pcontainer.compress(data, "chameleon", 65536, device="cpu")
    monkeypatch.setattr(layout, "PACK_MODE", "onehot")
    assert pcontainer.compress(data, "chameleon", 65536, device="cpu") == want


def _check_plan(got, want):
    names = ("flags", "pw", "w0", "w1", "real", "bits")
    for name, g, w in zip(names, got, want):
        w = np.broadcast_to(np.asarray(w), g.shape)
        np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype),
                                      err_msg=name)


def test_plan_fast_bitonic_option_matches_pallas(monkeypatch):
    """Under DENSITY_TPU_SORT=bitonic both sorts of the planner go
    through the bitonic module; the plan equals the default one and the
    JAX planner's on its Pallas bitonic kernel (interpret mode)."""
    rng = np.random.default_rng(21)
    q = _vocab_quads(rng, (2, 4096))
    nbytes = np.array([16384, 16381], np.int32)
    tq, tn = torch.from_numpy(q.view(np.int32)), torch.from_numpy(nbytes)
    default = pcham.plan_fast(tq, tn)
    monkeypatch.setenv("DENSITY_TPU_SORT", "bitonic")
    calls = []

    def spy(*a, _fn=bitonic.sort, **kw):
        calls.append(a[0].shape)
        return _fn(*a, **kw)
    monkeypatch.setattr(bitonic, "sort", spy)
    got = pcham.plan_fast(tq, tn)
    assert len(calls) == 2
    _check_plan(got, default)
    want = jcham.plan_fast_pallas(jnp.asarray(q), jnp.asarray(nbytes),
                                  interpret=True)
    _check_plan(got, want)


def test_plan_fast_bitonic_option_two_key_branch(monkeypatch):
    """Above 2^16 quads the planner's 2-key sort takes the option too."""
    rng = np.random.default_rng(22)
    q = _vocab_quads(rng, (1, 1 << 17))
    tq = torch.from_numpy(q.view(np.int32))
    tn = torch.tensor([(1 << 19) - 1], dtype=torch.int32)
    default = pcham.plan_fast(tq, tn)
    monkeypatch.setenv("DENSITY_TPU_SORT", "bitonic")
    assert pcham._sort_mod() is bitonic
    for g, w in zip(pcham.plan_fast(tq, tn), default):
        assert torch.equal(g, w)


# ---------------------------------------------------------------- containers

# name -> (maker, streams of stream_size, tail bytes); 1,598 bytes is the
# tail of the chip corpus at both stream sizes
CASES = {
    "text": (_text, 3, 1598),
    "random_copy_blocks": (_random, 3, 1598),
    "mixed": (_mixed, 3, 5001),
    "ragged": (_text, 3, 3),
}


@functools.lru_cache(maxsize=None)
def _case(name, stream):
    maker, full, tail = CASES[name]
    n = full * stream + tail
    data = maker(np.random.default_rng(len(name) * 1000 + stream), n)
    jblob = jcontainer.compress(data, "chameleon", stream_size=stream)
    pblob = pcontainer.compress(data, "chameleon", stream_size=stream,
                                device="cpu")
    return data, jblob, pblob


@pytest.mark.parametrize("stream", [16384, 32768])
@pytest.mark.parametrize("name", list(CASES))
def test_small_stream_container_equals_jax(name, stream):
    data, jblob, pblob = _case(name, stream)
    assert pblob == jblob
    assert pcontainer.decompress(pblob, device="cpu") == data


@pytest.mark.parametrize("stream", [16384, 32768])
@pytest.mark.parametrize("name", list(CASES))
def test_small_stream_each_decodes_the_other(name, stream):
    data, jblob, pblob = _case(name, stream)
    assert pcontainer.decompress(jblob, device="cpu") == data
    assert jcontainer.decompress(pblob) == data


def test_copy_blocks_of_small_streams_take_the_masked_assembly(monkeypatch):
    """Random 16 KiB streams fail the no-copy certificate, and their
    copy blocks are assembled by `assemble_masked` at n_q = 4096, as the
    JAX package assembles them with XLA."""
    shapes = []

    def spy(pipe, quads, *a, _fn=layout.assemble_masked):
        shapes.append(quads.shape[1])
        return _fn(pipe, quads, *a)
    monkeypatch.setattr(layout, "assemble_masked", spy)
    data, jblob, _ = _case("random_copy_blocks", 16384)
    assert pcontainer.compress(data, "chameleon", 16384,
                               device="cpu") == jblob
    assert shapes and set(shapes) == {4096}


def test_small_stream_decode_capacity():
    """A 32 KiB stream decodes at 8192 quads and the 1,598-byte tail at
    4096, not 16384; the tail's ragged bytes are stamped back."""
    from density_tpu_torch.parallel import sharding
    data, _, pblob = _case("text", 32768)
    (_, woff, _, _, _), _, _ = sharding.decode_prep(pblob, device="cpu")
    assert woff.shape[1] * 64 == 8192
    tail = pblob[-len(pcham.encode(data[-1598:], device="cpu")):]
    (_, woff, _, _, _), _, _ = sharding.decode_prep(
        pcontainer.compress(data[-1598:], "chameleon", 32768, device="cpu"),
        device="cpu")
    assert woff.shape[1] * 64 == 4096
    assert pcham.decode(tail, device="cpu") == data[-1598:]


# ---------------------------------------------------------------- api

SIZES = [0, 1, 255, 256, 257, 1000, 16384, 32771]


@pytest.mark.parametrize("n", SIZES)
def test_encode_raw_matches_jax(n):
    data = _mixed(np.random.default_rng(n), n)
    got = papi.encode_raw(data, device="cpu")
    assert got == japi.encode_raw(data, backend="jax")
    assert got == japi.encode_raw(data, backend="scalar")
    assert papi.encode_raw(data, backend="scalar") == got
    assert papi.decode_raw(got, device="cpu") == data
    assert papi.decode_raw(got, backend="scalar") == data
    assert japi.decode_raw(got, backend="jax") == data


@pytest.mark.parametrize("mode", ["text", "random", "mixed"])
def test_decode_scalar_matches_scalar_oracle(mode):
    """The port's scalar decoder against the JAX package's oracle, on
    reference streams with copy blocks and ragged ends."""
    rng = np.random.default_rng(len(mode))
    data = {"text": _text, "random": _random, "mixed": _mixed}[mode](
        rng, 20003)
    enc = ScalarChameleon().encode(data)
    assert host_scan.decode_scalar(enc) == ScalarChameleon().decode(enc)
    assert host_scan.decode_scalar(enc) == data


def test_unknown_codec_and_backend_raise():
    with pytest.raises(EncodeError, match="unknown codec"):
        papi.encode_raw(b"abcd", "zstd")
    with pytest.raises(EncodeError, match="unknown backend"):
        papi.encode_raw(b"abcd", backend="jax")
    with pytest.raises(DecodeError, match="unknown backend"):
        papi.decode_raw(b"abcd", backend="jax")


@pytest.mark.parametrize("codec", ["chameleon", "cheetah", "lion"])
def test_safe_encode_buffer_size_matches_jax(codec):
    for n in (0, 1, 63, 64, 255, 256, 257, 32771, 1 << 20):
        assert papi.safe_encode_buffer_size(codec, n) == (
            japi.safe_encode_buffer_size(codec, n))
