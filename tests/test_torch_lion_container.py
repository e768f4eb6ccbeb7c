"""The port's lion containers on the CPU, as a whole: byte-equal to the
JAX package's and each package decoding the other's, the reference
cases of `test_cheetah_lion_jax.py` against the native encoder, the
decode route (host pool above the predicted cutoff, device below), a
highly predicted stream on both routes, the native fallback of an
encode whose fixed point does not converge, and
`encode_raw`/`decode_raw` against the scalar and native backends. Every
comparison is exact; inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch

from density_tpu import container as jcontainer
from density_tpu import native as jnative
from density_tpu_torch import api as papi
from density_tpu_torch import container as pcontainer
from density_tpu_torch import native as pnative
from density_tpu_torch.codecs import lion as plion
from density_tpu_torch.engine import layout
from density_tpu_torch.errors import DecodeError
from density_tpu_torch.parallel import sharding
from tests.test_cheetah_lion_jax import _cases
from tests.test_torch_cheetah import _alphabet, _mixed, _stdlib_text, _text
from tests.test_torch_cheetah_container import _route_spies

torch.set_num_threads(1)


def _parts(blob):
    _, _, _, lengths, off = pcontainer.parse_header(blob)
    ends = off + np.cumsum(lengths)
    return [blob[e - n:e] for e, n in zip(ends, lengths)]


# Three stream sizes (whole quads, ragged quads) and tails that the JAX
# package stages at one capacity, 4096 bytes, so its XLA encode compiles
# once for the three (about 40 s here for each new shape).
@pytest.mark.parametrize("stream_size,n", [
    (4096, 3 * 4096 + 3601), (4000, 2 * 4000 + 3999),
    (3998, 4 * 3998 + 3700)])
def test_containers_match_jax(stream_size, n):
    data = _text(np.random.default_rng(n), n)
    pblob = pcontainer.compress(data, "lion", stream_size, device="cpu")
    jblob = jcontainer.compress(data, "lion", stream_size)
    assert pblob == jblob
    assert jcontainer.decompress(pblob) == data
    assert pcontainer.decompress(jblob, device="cpu") == data


@pytest.mark.parametrize("case", list(_cases()))
def test_reference_cases_match_native(case):
    """The JAX package's lion cases (cycle12 fills the 5-deep queue):
    the port's one-shot encode equals the native encoder's bytes, and the
    port decodes them back on the device path."""
    data = _cases()[case]
    enc = plion.encode(data, device="cpu")
    assert enc == jnative.encode("lion", data)
    assert plion.decode(enc, device="cpu") == data


def test_route_by_predicted_share(monkeypatch):
    """Above PREDICTED_DEVICE_CUTOFF the container decodes on the host
    pool, below it on the device (16384-quad streams: packroute), and
    both routes give the input's bytes."""
    rng = np.random.default_rng(7)
    low = _alphabet(rng, 2 * 16384) + b"xy"
    high = _text(rng, 2 * 65536 + 5)
    seen = _route_spies(monkeypatch)
    for data, want in ((low, "device"), (high, "pool")):
        blob = pcontainer.compress(data, "lion", 65536, device="cpu")
        _, _, meta = sharding.decode_prep(blob, device="cpu")
        assert sharding.route("lion", meta[-1]) == want
        assert (meta[-1] > sharding.PREDICTED_DEVICE_CUTOFF) == (
            want == "pool")
        seen.clear()
        assert pcontainer.decompress(blob, device="cpu") == data
        assert seen == [want]
        if want == "pool":  # the device route gives the same bytes
            assert b"".join(sharding.decode_streams(
                sharding._streams(blob)[2], None, "cpu", "lion")) == data
        else:
            monkeypatch.setattr(sharding, "PREDICTED_DEVICE_CUTOFF", -1.0)
            assert pcontainer.decompress(blob, device="cpu") == data
            assert seen[-1] == "pool"
            monkeypatch.setattr(sharding, "PREDICTED_DEVICE_CUTOFF", 0.02)


def test_highly_predicted_stream_decodes():
    """A block of predicted quads stores its 6-byte signature for 64
    bytes: bytes(16384) decodes to more than 10 times its stream, on
    both routes; one byte past lion's bound raises."""
    data = bytes(16384)
    enc = jnative.encode("lion", data)
    assert len(data) > 10 * len(enc)
    assert sharding.decode_streams([enc], [len(data)], "cpu",
                                   "lion") == [data]
    assert plion.decode(enc, device="cpu") == data
    blob = pcontainer.compress(data, "lion", 1 << 20, device="cpu")
    assert pcontainer.decompress(blob, device="cpu") == data
    with pytest.raises(DecodeError, match="too short"):
        sharding.decode_streams([enc], [int(64 / 6 * len(enc)) + 1], "cpu",
                                "lion")


def test_unconverged_decode_is_redone_by_native(monkeypatch):
    """Text needs more fixpoint rounds than the cap: the device decode
    flags those streams and the native runtime decodes each of them
    again."""
    data = _text(np.random.default_rng(9), 3 * 4096 + 5)
    streams = _parts(pcontainer.compress(data, "lion", 4096, device="cpu"))
    lens = [len(data[i:i + 4096]) for i in range(0, len(data), 4096)]
    woff, copyf, nb_real, _ = sharding._scan("lion", streams, lens)
    _, ok, rounds = plion.decode_batch(*sharding._stage(
        streams, lens, woff, copyf, nb_real, "cpu"))
    assert rounds == plion.MAX_ROUNDS and 0 < int((~ok).sum())
    calls = []
    dec = pnative.decode
    monkeypatch.setattr(pnative, "decode",
                        lambda *a, **k: calls.append(1) or dec(*a, **k))
    assert b"".join(sharding.decode_streams(streams, None, "cpu",
                                            "lion")) == data
    assert len(calls) == int((~ok).sum())


def test_unconverged_encode_falls_back_to_native(monkeypatch):
    """A batch whose fixed point does not converge is encoded by the
    native runtime, with the reference's bytes."""
    data = _mixed(np.random.default_rng(8), 40000)
    monkeypatch.setattr(layout, "MAX_FIXED_POINT_ITERS", 1)
    calls = []
    many = pnative.encode_many
    monkeypatch.setattr(pnative, "encode_many",
                        lambda *a: calls.append(1) or many(*a))
    blob = pcontainer.compress(data, "lion", 16384, device="cpu")
    assert calls
    assert _parts(blob) == [jnative.encode("lion", data[i:i + 16384])
                            for i in range(0, len(data), 16384)]


@pytest.mark.parametrize("n", [0, 1, 63, 64, 67, 4096, 20001])
def test_encode_raw_decode_raw(n):
    rng = np.random.default_rng(n)
    data = _mixed(rng, n)
    enc = papi.encode_raw(data, "lion", device="cpu")
    assert enc == papi.encode_raw(data, "lion", backend="scalar")
    assert enc == papi.encode_raw(data, "lion", backend="native")
    for backend in ("torch", "scalar", "native"):
        assert papi.decode_raw(enc, "lion", backend=backend,
                               device="cpu") == data


def test_lion_needs_a_card_unless_cpu_is_asked(monkeypatch):
    """Backend "torch" and the container run on the card by default:
    with no CUDA device they raise instead of quietly running on the
    host."""
    enc = jnative.encode("lion", b"abcdefgh" * 100)
    blob = pcontainer.compress(b"abcdefgh" * 100, "lion", 4096, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        papi.encode_raw(b"abcdefgh" * 100, "lion")
    with pytest.raises(RuntimeError, match="CUDA"):
        papi.decode_raw(enc, "lion")
    with pytest.raises(RuntimeError, match="CUDA"):
        pcontainer.compress(b"abcdefgh" * 100, "lion")
    with pytest.raises(RuntimeError, match="CUDA"):
        pcontainer.decompress(blob)


def test_fixed_point_past_eight_plans_stays_on_the_device(monkeypatch):
    """The copy-block fixed point of this text stream needs 9 plans, one
    past the JAX package's cap of 8: the port's encode converges on the
    device path, with the native encoder's bytes, and never calls it."""
    data = _stdlib_text(65536)
    plans = []
    masked = layout.plan_masked
    monkeypatch.setattr(layout, "plan_masked",
                        lambda *a: plans.append(1) or masked(*a))
    monkeypatch.setattr(pnative, "encode_many", None)  # must not be called
    blob = pcontainer.compress(data, "lion", 65536, device="cpu")
    assert len(plans) == 8 < layout.MAX_FIXED_POINT_ITERS
    assert _parts(blob) == [jnative.encode("lion", data)]
