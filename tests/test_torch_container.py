"""The port's chameleon container (density_tpu_torch.compress/decompress)
against the JAX package's, end to end on the CPU.

Both packages get the same input bytes, made from a numpy seed. The
containers must be byte-identical, and each package must decode the
other's. Every comparison is exact. The JAX side runs its XLA paths on
the CPU mesh; the port runs each kernel's plain PyTorch version.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from density_tpu import container as jcontainer
from density_tpu.codecs import chameleon as jcham
from density_tpu_torch import container as pcontainer
from density_tpu_torch.codecs import chameleon as pcham
from density_tpu_torch.errors import DecodeError
from density_tpu_torch.kernels import bigsort, packroute, unpack
from tests.test_golden import GOLDEN, TEST_DATA

REPO = Path(__file__).resolve().parent.parent
STREAM = 65536  # 16384 quads: the smallest shape that takes packroute

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


# name -> (maker, length); the length's residue mod 4 gives the ragged
# tail, and a tail stream of 40000 bytes is a non-power-of-two shape.
# The tails mostly share the JAX package's capacity buckets (each new
# one is an XLA compile on its side).
CASES = {
    "text_4streams_r1": (_text, 3 * STREAM + 60001),
    "text_r3": (_text, 2 * STREAM + 60003),
    "random_copy_blocks_r2": (_random, STREAM + 60002),
    "mixed_r1": (_mixed, 2 * STREAM + 50001),
    "non_pow2_tail": (_text, STREAM + 40000),
    "zeros": (lambda rng, n: bytes(n), STREAM + 60000),
    "tiny_golden": (lambda rng, n: TEST_DATA, 125),
    "tiny_3": (_text, 3),
    "one_quad": (_text, 4),
    "one_block_r2": (_mixed, 258),
    "empty": (lambda rng, n: b"", 0),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(data, JAX container, port container) of a case, made once."""
    maker, n = CASES[name]
    data = maker(np.random.default_rng(len(name) * 1000 + n), n)
    assert len(data) == n
    jblob = jcontainer.compress(data, "chameleon", stream_size=STREAM)
    pblob = pcontainer.compress(data, "chameleon", stream_size=STREAM,
                                device="cpu")
    return data, jblob, pblob


@pytest.mark.parametrize("name", list(CASES))
def test_container_bytes_equal_jax(name):
    data, jblob, pblob = _case(name)
    assert pblob == jblob
    assert pcontainer.decompress(pblob, device="cpu") == data


@pytest.mark.parametrize("name", list(CASES))
def test_each_decodes_the_other(name):
    data, jblob, pblob = _case(name)
    assert pcontainer.decompress(jblob, device="cpu") == data
    assert jcontainer.decompress(pblob) == data


def test_copy_blocks_reach_the_device_paths():
    """The random case really has copy blocks, and the port's plain
    kernels (not the CUDA ones) served it."""
    from density_tpu_torch.parallel import sharding
    _, _, pblob = _case("random_copy_blocks_r2")
    (_, _, is_copy, _, _), _, _ = sharding.decode_prep(pblob, device="cpu")
    assert bool(is_copy.any())
    assert bigsort.launches == packroute.launches == unpack.launches == 0


@pytest.mark.parametrize("stream_size", [STREAM, 50001])
def test_stream_sizes_match_jax(stream_size):
    """Full streams of 16384 quads, and an odd stream size that gives
    every stream a ragged tail."""
    rng = np.random.default_rng(stream_size)
    data = _mixed(rng, 2 * stream_size + 3)
    pblob = pcontainer.compress(data, "chameleon", stream_size=stream_size,
                                device="cpu")
    assert pblob == jcontainer.compress(data, "chameleon",
                                        stream_size=stream_size)
    assert pcontainer.decompress(pblob, device="cpu") == data


def test_golden_vector():
    assert pcham.encode(TEST_DATA, device="cpu") == GOLDEN["chameleon"]
    assert pcham.decode(GOLDEN["chameleon"], device="cpu") == TEST_DATA
    assert jcham.encode(TEST_DATA) == GOLDEN["chameleon"]


def test_bad_containers_raise():
    _, _, pblob = _case("text_r3")
    inflated = pblob[:8] + (10**7).to_bytes(8, "little") + pblob[16:]
    for bad in (b"", b"XXXX" + pblob[4:], pblob[:30], pblob[:-5], inflated):
        with pytest.raises(DecodeError):
            pcontainer.decompress(bad, device="cpu")


def test_entry_points_need_a_card_unless_cpu_asked(monkeypatch):
    """With no CUDA device the entry points raise instead of quietly
    running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pcontainer.compress(b"abcdefgh")
    with pytest.raises(RuntimeError, match="CUDA"):
        pcontainer.decompress(_case("tiny_3")[2])
    with pytest.raises(RuntimeError, match="CUDA"):
        pcham.encode(TEST_DATA)


def test_package_imports_no_jax():
    """Every module of the port imports, and a compress/decompress runs,
    without JAX or the JAX package entering the process."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import density_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "blob = p.compress(b'abc' * 1000, device='cpu')\n"
        "assert p.decompress(blob, device='cpu') == b'abc' * 1000\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib', 'density_tpu.'))\n"
        "             or m == 'density_tpu')\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
