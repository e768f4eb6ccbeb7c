"""Cheetah through the port's normal path at the benchmark's stream size
(`portbench/configs/cheetah-256k.json`: 262,144-byte streams, 65,536
quads a stream) on the CPU, held to the benchmark's plain reference
(`portbench/reference/density.py`): the container byte for byte, and the
round trip. Stdlib text, as the benchmark's `bulk` mix makes it, of two
full streams and a ragged tail; and the same text with random bytes in
its first stream, so the fixed point runs masked plans at that size."""

import numpy as np
import pytest

from density_tpu_torch import container
from portbench import resolve
from portbench.reference import density

STREAM = 262144


def _data(which: str) -> bytes:
    text = resolve.module("content", "stdlib_text", resolve.HERE.parent)
    rng = np.random.default_rng(20261017)
    data = text.text_object(text.stdlib_sources(), 2 * STREAM + 40_003, rng)
    if which == "mixed":
        noise = rng.integers(0, 256, 30_000, dtype=np.uint8).tobytes()
        data = data[:100_000] + noise + data[130_000:]
    return data


@pytest.mark.parametrize("which", ["text", "mixed"])
def test_cheetah_at_the_cell_stream_size_equals_the_reference(which):
    data = _data(which)
    blob = container.compress(data, "cheetah", STREAM, device="cpu")
    assert blob == density.compress(data, "cheetah", STREAM)
    assert container.decompress(blob, device="cpu") == data
