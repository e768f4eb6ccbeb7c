"""The port's public surface held to the JAX package on malformed and edge
inputs, on the CPU.

The JAX package's robustness suites, ported to the port's entry points:
the golden vectors through every raw backend (`tests/test_golden.py`),
the protection FSM's wire agreement on adversarial inputs and the
truncated and corrupt streams (`tests/test_fuzz.py`). Then a differential
suite: seeded mutations of containers, and edge inputs of compress and
decompress, each given to both packages, which must agree on the outcome
(`DecodeError`, `EncodeError`, the header's `struct.error`, or bytes) and
on the bytes.

The yardstick of a decompress is the JAX package's default route
(`density_tpu.container.decompress`, its host pool), as in
`tests/test_torch_decode_checks.py`. The JAX package's compress is run
only where it raises before it encodes; elsewhere its container is
`build_header` over `native.encode` of each stream, which
`tests/test_torch_container.py` holds equal to its device containers,
so no XLA compile runs here. The port runs with `device="cpu"`, each
kernel's plain version. The mutations and inputs are `chip_smoke.py`'s,
which phase (x) runs again on the card.
"""

import contextlib
import struct

import numpy as np
import pytest
import torch

import chip_smoke
from density_tpu import container as jcontainer
from density_tpu import native as jnative
from density_tpu.errors import DensityError as JDensityError
from density_tpu_torch import api as papi
from density_tpu_torch import container as pcontainer
from density_tpu_torch import native as pnative
from density_tpu_torch.constants import SPECS
from density_tpu_torch.engine.protection import replay_fsm
from density_tpu_torch.errors import DecodeError
from density_tpu_torch.parallel import sharding
from tests.test_fuzz import _adversarial_inputs
from tests.test_golden import GOLDEN, TEST_DATA
from tests.test_torch_decode_checks import _pool_route

torch.set_num_threads(1)

CODECS = ("chameleon", "cheetah", "lion")
CODEC_IDS = {"chameleon": 0, "cheetah": 1, "lion": 2}
SS = chip_smoke.FAULT_STREAM


def _jax_outcome(fn, *args):
    """The JAX package's outcome, named as `chip_smoke.outcome` names the
    port's."""
    try:
        return "ok", fn(*args)
    except (JDensityError, struct.error) as e:
        return type(e).__name__, None


def _jax_decompress(blob):
    """The reference's default route: its host pool (called directly when
    the native library did not build in this process, since `decompress`
    would then take its device route)."""
    route = jcontainer.decompress if jnative.is_available() else _pool_route
    return _jax_outcome(route, blob)


def _jax_compress(data, codec, stream_size):
    """The JAX package's container without an XLA compile: its own
    `compress` where that raises before it encodes (an unknown codec, a
    stream size <= 0) or encodes nothing (empty input), else
    `build_header` over `native.encode` of each stream."""
    data = bytes(data)
    if codec not in SPECS or not data or stream_size <= 0:
        return _jax_outcome(jcontainer.compress, data, codec, stream_size)

    def build():
        parts = [jnative.encode(codec, data[i:i + stream_size])
                 for i in range(0, len(data), stream_size)]
        return jcontainer.build_header(codec, len(data), stream_size,
                                       [len(p) for p in parts]) + (
            b"".join(parts))
    return _jax_outcome(build)


def _port_decompress(blob, device_route=False):
    """The port's outcome on the CPU, by its own route or, with
    `device_route`, always on the device route (the cutoff raised)."""
    with chip_smoke.device_route() if device_route else (
            contextlib.nullcontext()):
        return chip_smoke.outcome(pcontainer.decompress, blob, device="cpu")


# ----------------------------------------------------------- golden vectors

@pytest.mark.parametrize("backend", papi.BACKENDS)
@pytest.mark.parametrize("codec", CODECS)
def test_golden_vectors(codec, backend):
    enc = papi.encode_raw(TEST_DATA, codec, backend=backend, device="cpu")
    assert enc == GOLDEN[codec], f"{list(enc)} != {list(GOLDEN[codec])}"
    assert papi.decode_raw(GOLDEN[codec], codec, len(TEST_DATA),
                           backend=backend, device="cpu") == TEST_DATA


def test_smoke_vectors_are_the_references():
    """Phase (x) on the card runs these same cases."""
    assert chip_smoke.GOLDEN == GOLDEN
    assert chip_smoke.TEST_DATA == TEST_DATA
    assert chip_smoke.adversarial_inputs() == _adversarial_inputs()


# ------------------------------------------------------ FSM wire agreement

ADVERSARIAL = _adversarial_inputs()
# lion's two: the shortest case and the one where the penalty grows and
# the halving sets in (all seven run on the card, phase x)
FSM_CASES = [(c, k) for c in ("chameleon", "cheetah") for k in ADVERSARIAL]
FSM_CASES += [("lion", "interleave4"), ("lion", "long_random")]


@pytest.mark.parametrize("codec,case", FSM_CASES)
def test_fsm_replay_matches_wire(codec, case):
    """The port's device encode (no stream left to the native encoder)
    gives the native oracle's bytes, and the port's FSM replay, fed the
    decode-side bits (`consumed >= block`) of its own stream, gives the
    stream's copy flags, copies among them."""
    data = ADVERSARIAL[case]
    with chip_smoke.device_encodes_only(f"{codec} {case}"):
        enc = papi.encode_raw(data, codec, device="cpu")
    assert enc == jnative.encode(codec, data)
    in_off, _, is_copy = jnative.scan(codec, enc)
    consumed = np.diff(np.append(in_off, len(enc)))
    replay = replay_fsm(consumed >= SPECS[codec].block_size)
    assert (replay == is_copy.astype(bool)).all(), (
        f"first diff at block "
        f"{int(np.argmax(replay != is_copy.astype(bool)))}")
    assert is_copy.any()


# -------------------------------------------- truncated and corrupt streams

@pytest.mark.parametrize("codec", CODECS)
def test_truncated_stream_raises(codec):
    data = b"a compressible message, " * 600
    blob = pcontainer.compress(data, codec, stream_size=1 << 14,
                               device="cpu")
    for cut in [len(blob) - 1, len(blob) // 2, 20]:
        with pytest.raises(DecodeError):
            pcontainer.decompress(blob[:cut], device="cpu")


@pytest.mark.parametrize("codec", CODECS)
def test_corrupt_header_raises(codec):
    data = b"another compressible message! " * 400
    blob = pcontainer.compress(data, codec, stream_size=1 << 14,
                               device="cpu")
    for pos, value in ((0, blob[0] ^ 0xFF), (4, 0xEE), (5, 0xEE)):
        bad = bytearray(blob)
        bad[pos] = value  # magic, version, codec id
        with pytest.raises(DecodeError):
            pcontainer.decompress(bytes(bad), device="cpu")


@pytest.mark.parametrize("codec", CODECS)
def test_truncated_raw_stream_raises(codec):
    """The port's scanner, native and pure Python, rejects a cut stream
    rather than walk past its end."""
    from density_tpu_torch import host_scan
    enc = pnative.encode(codec, b"abcd" * 600)
    with pytest.raises(DecodeError):
        pnative.scan(codec, enc[:len(enc) // 2])
    with pytest.raises(DecodeError):
        host_scan.scan_with_counts(enc[:len(enc) // 2], codec)


# --------------------------------------------------- zero-stream headers

@pytest.mark.parametrize("original_len", [5000, 0])
@pytest.mark.parametrize("codec", CODECS)
def test_zero_stream_header(codec, original_len):
    """A header of no streams: DecodeError ("decoded 0 bytes, expected N")
    from decompress and decode_prep where its length is not 0, as the
    reference's length check raises; b"" where it is."""
    blob = chip_smoke.zero_stream_headers(CODEC_IDS[codec], original_len,
                                          1000)[0][1]
    assert blob == _header(codec, original_len, 1000, [])
    assert _port_decompress(blob) == _jax_decompress(blob)
    if original_len:
        message = f"decoded 0 bytes, expected {original_len}"
        for device in ("cpu", ["cpu", "cpu"]):
            with pytest.raises(DecodeError, match=message):
                sharding.decode_prep(blob, device=device)
        with pytest.raises(DecodeError, match=message):
            pcontainer.decompress(blob, device="cpu")
    else:
        assert pcontainer.decompress(blob, device="cpu") == b""
        args, streams, _ = sharding.decode_prep(blob, device="cpu")
        assert streams == [] and all(a.shape[0] == 0 for a in args)


# ------------------------------------ container mutations, differential

@pytest.fixture(scope="module")
def fault_blobs():
    """(codec, seed) -> (input, the JAX package's container), made once."""
    out = {}
    for codec in CODECS:
        for seed in range(chip_smoke.FAULT_SEEDS):
            data = chip_smoke.fault_input(seed)
            want, blob = _jax_compress(data, codec, SS)
            assert want == "ok"
            out[codec, seed] = data, blob
    return out


@pytest.mark.parametrize("codec", CODECS)
def test_fault_containers_equal_the_ports(codec, fault_blobs):
    """The port's compress of the text and the 97-value input gives the
    reference's container, which has three full streams and a tail."""
    for seed in (0, 1):
        data, blob = fault_blobs[codec, seed]
        assert pcontainer.compress(data, codec, SS, device="cpu") == blob
        assert int.from_bytes(blob[20:24], "little") == 4


@pytest.mark.parametrize("seed", range(chip_smoke.FAULT_SEEDS))
@pytest.mark.parametrize("codec", CODECS)
def test_mutations_match_the_reference(codec, seed, fault_blobs):
    """Every mutation: the same outcome class and the same bytes from the
    JAX package's default route and the port's own route; the 97-value
    input's also from the port's device route, which every codec then
    takes (the pool serves the text's cheetah and lion containers)."""
    data, blob = fault_blobs[codec, seed]
    assert _port_decompress(blob) == ("ok", data)
    muts = chip_smoke.mutations(blob, seed)
    assert len(muts) >= 25
    outcomes, diffs = [], []
    for name, bad in muts:
        want = _jax_decompress(bad)
        got = [_port_decompress(bad)]
        if seed % 2 and codec != "chameleon":
            got.append(_port_decompress(bad, device_route=True))
        outcomes.append(want[0])
        diffs += [(name, want[0], g[0]) for g in got if g != want]
    assert not diffs, diffs
    # both kinds of outcome occur
    assert "ok" in outcomes and "DecodeError" in outcomes


@pytest.mark.parametrize("codec", ["cheetah", "lion"])
def test_map_token_of_an_empty_slot_keeps_its_wire_hash(codec):
    """After a map token, the reference's context is the token's hash from
    the wire, even where its slot holds a quad of another hash (never
    written: 0). The stream of P, Q, P, Q (plain, plain, map P, predicted
    Q) with the map token's hash rewritten to an empty slot's: the quad
    after it reads the prediction of that slot's context (0), not of
    hash(0)'s, which the first token wrote (P). The device decode held
    hash(0), and so returned P there."""
    from density_tpu_torch import host_scan
    from density_tpu_torch.constants import hash_u16
    p, q = b"abcd", b"wxyz"
    enc = pnative.encode(codec, p + q + p + q)
    h_p = hash_u16(int.from_bytes(p, "little"))
    assert enc[-2:] == h_p.to_bytes(2, "little")  # the map token ends it
    empty = next(h for h in range(1, 1 << 16) if h not in (
        h_p, hash_u16(int.from_bytes(q, "little"))))
    bad = enc[:-2] + empty.to_bytes(2, "little")
    want = jnative.decode(codec, bad, 16)
    assert want == p + q + bytes(8)
    assert pnative.decode(codec, bad, 16) == want
    assert host_scan.decode_scalar(bad, codec) == want
    assert sharding.decode_streams([bad], [16], device="cpu",
                                   codec=codec) == [want]
    blob = _header(codec, 16, SS, [len(bad)]) + bad
    assert _port_decompress(blob, device_route=True) == (
        _jax_decompress(blob)) == ("ok", want)


# ------------------------------------------------------------ edge inputs

def _text(n, seed=5):
    return chip_smoke.fault_input(2 * seed)[:n]


COMPRESS_EDGES = {
    **{f"stream_size {s}": (_text(10000), s)
       for s in (0, -4, 4096, 5000, 65536, 2**33)},
    **{f"64 bytes, stream_size {s}": (_text(64), s) for s in (3, 6)},
    **{f"{n} bytes": (_text(n), SS) for n in range(6)},
    "empty, stream_size 0": (b"", 0),
    "empty, stream_size 2**33": (b"", 2**33),
    "bytearray": (bytearray(_text(5001)), SS),
    "memoryview": (memoryview(_text(5001)), SS),
}


@pytest.mark.parametrize("name", list(COMPRESS_EDGES))
@pytest.mark.parametrize("codec", CODECS)
def test_compress_edges(codec, name):
    data, stream_size = COMPRESS_EDGES[name]
    want = _jax_compress(data, codec, stream_size)
    got = chip_smoke.outcome(pcontainer.compress, data, codec, stream_size,
                             device="cpu")
    assert got == want
    if stream_size >= 2**32:
        assert got[0] == "error"  # struct.error, as build_header raises
    if got[0] == "ok":
        assert pcontainer.decompress(got[1], device="cpu") == bytes(data)


def test_unknown_codec():
    assert (chip_smoke.outcome(pcontainer.compress, b"abcd", "zebra",
                               device="cpu")
            == _jax_compress(b"abcd", "zebra", SS) == ("EncodeError", None))
    with pytest.raises(papi.EncodeError):
        papi.encode_raw(b"abcd", "zebra", device="cpu")
    with pytest.raises(DecodeError):
        papi.decode_raw(b"abcd", "zebra", device="cpu")


def _header(codec, original_len, stream_size, lengths):
    return struct.pack("<4sBBHQII", b"DTPU", 1, CODEC_IDS[codec], 0,
                       original_len, stream_size, len(lengths)) + (
        np.asarray(lengths, "<u4").tobytes())


def _decompress_edges(codec):
    """name -> container: a good one with trailing bytes, cut, its
    stream size rewritten or zeroed; hand-built headers of 0 and 1
    streams."""
    data = _text(10000)
    _, blob = _jax_compress(data, codec, SS)
    one = jnative.encode(codec, data)

    def ss(n):
        return blob[:16] + n.to_bytes(4, "little") + blob[20:]
    return {
        "1 trailing byte": blob + b"\0",
        "5 trailing bytes": blob + b"\1\2\3\4\5",
        "cut 1": blob[:-1],
        "cut 100": blob[:-100],
        **{f"stream_size {n}": ss(n)
           for n in (0, 4095, 4097, 2048, 8192, 1 << 31)},
        "0 streams, length 5000": _header(codec, 5000, SS, []),
        "0 streams, length 0": _header(codec, 0, SS, []),
        "1 stream, whole input": _header(codec, len(data), len(data),
                                         [len(one)]) + one,
        "1 stream, stream_size short": _header(codec, len(data), SS,
                                               [len(one)]) + one,
        "1 empty stream, length 0": _header(codec, 0, SS, [0]),
        "1 empty stream, length 5": _header(codec, 5, SS, [0]),
    }


DECOMPRESS_EDGES = (
    ["1 trailing byte", "5 trailing bytes", "cut 1", "cut 100"]
    + [f"stream_size {n}" for n in (0, 4095, 4097, 2048, 8192, 1 << 31)]
    + ["0 streams, length 5000", "0 streams, length 0",
       "1 stream, whole input", "1 stream, stream_size short",
       "1 empty stream, length 0", "1 empty stream, length 5"])


@pytest.mark.parametrize("name", DECOMPRESS_EDGES)
@pytest.mark.parametrize("codec", CODECS)
def test_decompress_edges(codec, name):
    edges = _decompress_edges(codec)
    assert list(edges) == DECOMPRESS_EDGES
    blob = edges[name]
    assert _port_decompress(blob) == _jax_decompress(blob)
