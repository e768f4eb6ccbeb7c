"""The port's `stats` against the JAX package's, on the CPU.

`stream_stats` (the host walk of a compressed stream) and
`encode_stats` (the device planner's copy-block fixed point and its
reductions) give the JAX package's numbers for the three codecs, on the
input of `test_components.py::test_encode_stats_device_matches_wire_walk`,
an incompressible input (copy blocks), an empty input and a lion text
whose fixed point needs 9 plans: the JAX package stops at 8 and walks
the native encoder's bytes instead, the port plans a ninth time on the
device, and the numbers are the same. Every input stages at one
capacity (10240 bytes), so the JAX planner compiles once a codec.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from density_tpu import native as jnative
from density_tpu import stats as jstats
from density_tpu.engine import layout as jlayout
from density_tpu_torch import native as pnative
from density_tpu_torch import stats as pstats
from density_tpu_torch.engine import layout
from density_tpu_torch.errors import EncodeError
from tests.test_torch_cheetah import _stdlib_text

torch.set_num_threads(1)

CODECS = ("chameleon", "cheetah", "lion")


def _input(name: str) -> bytes:
    if name == "components":
        rng = random.Random(7)
        return (b"device stats parity " * 300) + rng.randbytes(4000) + b"tl"
    if name == "incompressible":
        return np.random.default_rng(3).integers(
            0, 256, 10000, dtype=np.uint8).tobytes()
    if name == "lion9":
        return _stdlib_text(10240)
    return b""


INPUTS = ("components", "incompressible", "empty", "lion9")


def _fields(st):
    return dataclasses.asdict(st)


@pytest.mark.parametrize("name", INPUTS)
@pytest.mark.parametrize("codec", CODECS)
def test_stream_stats_match_jax(codec, name):
    data = _input(name)
    enc = pnative.encode(codec, data)
    assert enc == jnative.encode(codec, data)
    got = pstats.stream_stats(codec, data, enc)
    assert _fields(got) == _fields(jstats.stream_stats(codec, data, enc))
    assert got.compressed_bytes == len(enc)
    assert got.ratio == (len(data) / len(enc) if enc else 0.0)
    if name == "incompressible":
        assert got.copy_blocks > 0


@pytest.mark.parametrize("name", INPUTS)
@pytest.mark.parametrize("codec", CODECS)
def test_encode_stats_match_jax(codec, name):
    data = _input(name)
    got = pstats.encode_stats(codec, data, device="cpu")
    assert _fields(got) == _fields(jstats.encode_stats(codec, data))
    enc = pnative.encode(codec, data)
    assert _fields(got) == _fields(pstats.stream_stats(codec, data, enc))


def test_encode_stats_plans_past_the_jax_cap(monkeypatch):
    """The lion text's fixed point needs 9 plans, one past the JAX
    package's cap: the port's stays on the device planner (the native
    encoder is never called) and gives the numbers of the wire walk."""
    data = _input("lion9")
    plans = []
    masked = layout.plan_masked
    monkeypatch.setattr(layout, "plan_masked",
                        lambda *a: plans.append(1) or masked(*a))
    monkeypatch.setattr(pnative, "encode", None)  # must not be called
    got = pstats.encode_stats("lion", data, device="cpu")
    assert 1 + len(plans) == 9 > jlayout.MAX_FIXED_POINT_ITERS
    assert got.copy_blocks > 0
    assert _fields(got) == _fields(jstats.stream_stats(
        "lion", data, jnative.encode("lion", data)))


def test_unknown_codec_raises():
    with pytest.raises(EncodeError):
        pstats.encode_stats("zstd", b"abc", device="cpu")
    with pytest.raises(EncodeError):
        pstats.stream_stats("zstd", b"abc", b"")
