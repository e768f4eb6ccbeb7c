"""The port's cheetah containers on the CPU, as a whole: byte-equal to
the JAX package's and each package decoding the other's, the decode
route (host pool above the predicted cutoff, device below), the
per-codec decoded-length bound, the native fallback of an encode whose
fixed point does not converge, and `encode_raw`/`decode_raw` against
the scalar and native backends. Every comparison is exact; inputs come
from numpy seeds.
"""

import numpy as np
import pytest
import torch

from density_tpu import container as jcontainer
from density_tpu import native as jnative
from density_tpu_torch import api as papi
from density_tpu_torch import container as pcontainer
from density_tpu_torch import native as pnative
from density_tpu_torch.codecs import cheetah as pche
from density_tpu_torch.engine import layout
from density_tpu_torch.errors import DecodeError
from density_tpu_torch.parallel import sharding
from tests.test_torch_cheetah import _alphabet, _mixed, _text

torch.set_num_threads(1)



@pytest.mark.parametrize("stream_size,n,maker", [
    (4096, 3 * 4096 + 1001, _text), (16384, 2 * 16384 + 3, _mixed),
    (32768, 32768 + 9002, _text)])
def test_containers_match_jax(stream_size, n, maker):
    data = maker(np.random.default_rng(n), n)
    pblob = pcontainer.compress(data, "cheetah", stream_size, device="cpu")
    jblob = jcontainer.compress(data, "cheetah", stream_size)
    assert pblob == jblob
    assert jcontainer.decompress(pblob) == data
    assert pcontainer.decompress(jblob, device="cpu") == data


def _route_spies(monkeypatch):
    seen = []
    pool, dev = pnative.decode_many, sharding.decode_batch

    def spy_pool(*a, **k):
        seen.append("pool")
        return pool(*a, **k)

    def spy_dev(*a, **k):
        seen.append("device")
        return dev(*a, **k)

    monkeypatch.setattr(pnative, "decode_many", spy_pool)
    monkeypatch.setattr(sharding, "decode_batch", spy_dev)
    return seen


def test_route_by_predicted_share(monkeypatch):
    """Above PREDICTED_DEVICE_CUTOFF the container decodes on the host
    pool, below it on the device (a 16384-quad stream: packroute), and
    both give the input's bytes."""
    rng = np.random.default_rng(7)
    low = _alphabet(rng, 2 * 16384) + b"xy"
    high = _text(rng, 2 * 65536 + 5)
    seen = _route_spies(monkeypatch)
    for data, want in ((low, "device"), (high, "pool")):
        blob = pcontainer.compress(data, "cheetah", 65536, device="cpu")
        args, _, meta = sharding.decode_prep(blob, device="cpu")
        assert sharding.route("cheetah", meta[-1]) == want
        assert (meta[-1] > sharding.PREDICTED_DEVICE_CUTOFF) == (
            want == "pool")
        seen.clear()
        assert pcontainer.decompress(blob, device="cpu") == data
        assert seen == [want]
        # the other route gives the same bytes
        if want == "pool":
            assert b"".join(sharding.decode_streams(
                sharding._streams(blob)[2], None, "cpu", "cheetah")) == data
        else:
            monkeypatch.setattr(sharding, "PREDICTED_DEVICE_CUTOFF", -1.0)
            assert pcontainer.decompress(blob, device="cpu") == data
            assert seen[-1] == "pool"
            monkeypatch.setattr(sharding, "PREDICTED_DEVICE_CUTOFF", 0.02)


@pytest.mark.parametrize("data", [bytes(16384), b"abcdefgh" * 2048 + b"z"],
                         ids=["zeros", "period8"])
def test_highly_predicted_stream_decodes(data):
    """A predicted token stores 0 bytes for 4: a stream can decode to 16
    times its length, past chameleon's bound of 2, on both routes."""
    enc = jnative.encode("cheetah", data)
    assert len(data) > 8 * len(enc)
    assert sharding.decode_streams([enc], [len(data)], "cpu",
                                   "cheetah") == [data]
    assert pche.decode(enc, device="cpu") == data
    blob = pcontainer.compress(data, "cheetah", 1 << 20, device="cpu")
    assert pcontainer.decompress(blob, device="cpu") == data
    with pytest.raises(DecodeError, match="too short"):
        sharding.decode_streams([enc], [16 * len(enc) + 1], "cpu", "cheetah")


def test_unconverged_encode_falls_back_to_native(monkeypatch):
    """A batch whose fixed point does not converge is encoded by the
    native runtime, with the reference's bytes."""
    data = _mixed(np.random.default_rng(8), 40000)
    monkeypatch.setattr(layout, "MAX_FIXED_POINT_ITERS", 1)
    calls = []
    many = pnative.encode_many
    monkeypatch.setattr(pnative, "encode_many",
                        lambda *a: calls.append(1) or many(*a))
    blob = pcontainer.compress(data, "cheetah", 16384, device="cpu")
    assert calls
    _, _, _, lengths, off = pcontainer.parse_header(blob)
    ends = off + np.cumsum(lengths)
    assert [blob[e - n:e] for e, n in zip(ends, lengths)] == [
        jnative.encode("cheetah", data[i:i + 16384])
        for i in range(0, len(data), 16384)]


@pytest.mark.parametrize("n", [0, 1, 127, 128, 131, 4096, 20001])
def test_encode_raw_decode_raw(n):
    rng = np.random.default_rng(n)
    data = _mixed(rng, n)
    enc = papi.encode_raw(data, "cheetah", device="cpu")
    assert enc == papi.encode_raw(data, "cheetah", backend="scalar")
    assert enc == papi.encode_raw(data, "cheetah", backend="native")
    for backend in ("torch", "scalar", "native"):
        assert papi.decode_raw(enc, "cheetah", backend=backend,
                               device="cpu") == data
