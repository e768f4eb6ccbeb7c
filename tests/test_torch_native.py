"""The port's native host runtime (density_tpu_torch.native) and its
pure-Python twin (host_scan) against the JAX package's runtime, on the
three codecs, on the CPU.

The port keeps its own copy of the C++ source and builds it under
`density_tpu_torch/build/`; every entry point (encode, decode, scan,
scan_many, encode_many, decode_many) must give the JAX package's
`density_tpu.native` results exactly, and with DENSITY_TPU_NO_NATIVE=1
the port's Python twin must give the same. Inputs are made from numpy
seeds; every comparison is exact.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from density_tpu import native as jnative
from density_tpu.codecs.scalar import SCALAR_CODECS
from density_tpu.native import fallback as jfallback
from density_tpu_torch import api as papi
from density_tpu_torch import host_scan, native
from density_tpu_torch.errors import DecodeError
from density_tpu_torch.native import build

REPO = Path(__file__).resolve().parent.parent
CODECS = ["chameleon", "cheetah", "lion"]


def _text(rng, n):
    words = [b"the quick brown fox ", b"jumps over ", b"lazy dog ",
             b"density ", b"cheetah\n", b"\x00\x00\x00\x00"]
    return b"".join(words[i] for i in rng.integers(0, 6, n // 4 + 1))[:n]


def _inputs():
    """Golden, block-boundary, ragged, random (copy blocks) and mixed
    inputs."""
    rng = np.random.default_rng(17)
    text = _text(rng, 30001)
    rand = rng.integers(0, 256, 9000, dtype=np.uint8).tobytes()
    return {
        "empty": b"", "one": b"t", "golden": b"test" * 31 + b"t",
        "b63": text[:63], "b64": text[:64], "b129": text[:129],
        "b255": text[:255], "b257": text[:257], "text": text,
        "random": rand,
        "mixed": rand[:3001] + text[:5003] + rand[3001:7002] + b"xy",
        "zeros": bytes(4099),
    }


INPUTS = _inputs()


@pytest.fixture(scope="module")
def lib_ready():
    if not native.is_available():
        pytest.fail(f"the port's runtime did not build: {native._load_error}")


def test_library_builds_under_the_port(lib_ready):
    """The library is built from the port's own source into the port's
    build directory, named by the source's digest; nothing is written
    next to either package's source."""
    path = build.lib_path()
    assert path.exists()
    assert path.parent == REPO / "density_tpu_torch" / "build"
    assert build.SRC == (REPO / "density_tpu_torch" / "native"
                         / "libdensity.cpp")
    assert not list((REPO / "density_tpu_torch" / "native").glob("*.so"))


def test_source_is_the_jax_runtime():
    """The port's copy differs from the JAX package's file only in
    comments: the code, line comments stripped, is the same."""
    def code(p):
        lines = (line.split("//", 1)[0].rstrip()
                 for line in p.read_text().splitlines())
        return [line for line in lines if line]
    assert code(build.SRC) == code(
        REPO / "density_tpu" / "native" / "libdensity.cpp")


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_encode_decode_scan_match(lib_ready, codec, name):
    data = INPUTS[name]
    enc = native.encode(codec, data)
    assert enc == jnative.encode(codec, data)
    assert native.decode(codec, enc) == data
    assert native.decode(codec, enc, decoded_size_hint=len(data)) == data
    if enc:
        for got, want in zip(native.scan(codec, enc),
                             jnative.scan(codec, enc)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("codec", CODECS)
def test_many_match(lib_ready, codec):
    chunks = [INPUTS[k] for k in sorted(INPUTS)]
    encs = native.encode_many(codec, chunks)
    assert encs == jnative.encode_many(codec, chunks)
    caps = [len(c) for c in chunks]
    assert native.decode_many(codec, encs, caps) == chunks
    live = [e for e in encs if e]
    got = native.scan_many(codec, live, 1000)
    want = jnative.scan_many(codec, live, 1000)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(DecodeError):  # a stream past its bound
        native.decode_many(codec, encs, [c - 1 if c else 0 for c in caps])
    with pytest.raises(DecodeError):  # more blocks than the capacity
        native.scan_many(codec, live, 2)


@pytest.mark.parametrize("codec", CODECS)
def test_disabled_runtime_routes_to_python(codec, monkeypatch):
    """DENSITY_TPU_NO_NATIVE=1 (read at every call) routes every entry
    point to host_scan, with the JAX runtime's results."""
    chunks = [INPUTS[k] for k in ("golden", "b257", "mixed", "zeros")]
    want_enc = [jnative.encode(codec, c) for c in chunks]
    want_scan = jnative.scan_many(codec, want_enc, 400)
    monkeypatch.setenv("DENSITY_TPU_NO_NATIVE", "1")
    assert not native.is_available()
    assert [native.encode(codec, c) for c in chunks] == want_enc
    assert native.encode_many(codec, chunks) == want_enc
    assert [native.decode(codec, e) for e in want_enc] == chunks
    assert native.decode_many(codec, want_enc,
                              [len(c) for c in chunks]) == chunks
    for g, w in zip(native.scan_many(codec, want_enc, 400), want_scan):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(native.scan(codec, want_enc[2]),
                    jnative.scan(codec, want_enc[2])):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("name", ["golden", "b129", "b257", "random",
                                  "mixed", "zeros"])
def test_host_scan_matches_fallback(codec, name):
    """The port's Python scanner and scalar codecs against the JAX
    package's twins (`native/fallback.py`, `codecs/scalar.py`)."""
    data = INPUTS[name]
    enc = SCALAR_CODECS[codec]().encode(data)
    assert host_scan.encode_scalar(data, codec) == enc
    assert host_scan.decode_scalar(enc, codec) == data
    got = host_scan.scan_with_counts(enc, codec)
    want = jfallback.scan_with_counts(codec, enc)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3:] == tuple(want[3:])
    io, oo, cp = got[:3]
    assert host_scan.decoded_length(enc, io, oo, cp, codec) == len(data)


@pytest.mark.parametrize("codec", CODECS)
def test_api_native_and_scalar_backends(lib_ready, codec):
    for name in ("one", "golden", "b257", "mixed"):
        data = INPUTS[name]
        enc = papi.encode_raw(data, codec, backend="native")
        assert enc == jnative.encode(codec, data)
        assert papi.encode_raw(data, codec, backend="scalar") == enc
        assert papi.decode_raw(enc, codec, backend="native") == data
        assert papi.decode_raw(enc, codec, len(data),
                               backend="native") == data
        assert papi.decode_raw(enc, codec, backend="scalar") == data


def test_concurrent_builds_leave_one_library(tmp_path):
    """Processes that build at the same time each write a temporary file
    and rename it into place: every one loads a whole library."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from density_tpu_torch.native import build\n"
        "build.BUILD_DIR = Path(sys.argv[1])\n"
        "import ctypes\n"
        "lib = ctypes.CDLL(str(build.build()))\n"
        "print(lib.cheetah_safe_encode_buffer_size(128))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0]
    assert outs == ["136"] * 3
    assert [p.name for p in tmp_path.iterdir()] == [build.lib_path().name]
