"""The port's containers over several devices, on the CPU.

`device=["cpu"] * k` stands for k devices (a device named twice takes
two shares), as the JAX package's tests stand for several devices with
virtual CPU devices. A container does not depend on the number of
shares: the port's from k = 1-4 shares equal the JAX package's under a
4-device mesh, for the three codecs, with stream counts that k does not
divide, a ragged tail and empty shares; decompress and `decode_streams`
through shares on both routes; and each package decodes the other's.
Every comparison is exact; inputs come from numpy seeds.

The JAX containers are computed once, in a module fixture (lion's XLA
encode compiles once for each new shape, so its input stages every
stream at one capacity).
"""

import jax
import numpy as np
import pytest
import torch

from density_tpu import container as jcontainer
from density_tpu.parallel.mesh import default_mesh
from density_tpu_torch import container as pcontainer
from density_tpu_torch.parallel import mesh, sharding
from tests.test_torch_cheetah import _alphabet, _mixed, _text
from tests.test_torch_cheetah_container import _route_spies

torch.set_num_threads(1)

CODECS = ("chameleon", "cheetah", "lion")
STREAM = 4096


def _input(codec: str) -> bytes:
    """Chameleon and cheetah: 7 full streams and a 1328-byte tail (30,000
    bytes, the JAX multi-host test's size); lion: 3 full streams and a
    3700-byte tail, which stage at one capacity."""
    rng = np.random.default_rng(11)
    if codec == "chameleon":
        return (b"multihost ordered gather determinism check " * 700)[:30000]
    if codec == "cheetah":
        return _mixed(rng, 30000)
    return _text(rng, 3 * STREAM + 3700)


@pytest.fixture(scope="module")
def jax_blobs():
    """Each codec's container from the JAX package under a mesh of 4 CPU
    devices."""
    m = default_mesh(jax.devices("cpu")[:4])
    return {c: jcontainer.compress(_input(c), c, STREAM, mesh=m)
            for c in CODECS}


def _parts(blob):
    _, _, _, lengths, off = pcontainer.parse_header(blob)
    ends = off + np.cumsum(lengths)
    return [blob[e - n:e] for e, n in zip(ends, lengths)]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("codec", CODECS)
def test_containers_match_jax(jax_blobs, codec, k):
    data = _input(codec)
    blob = pcontainer.compress(data, codec, STREAM, device=["cpu"] * k)
    assert blob == jax_blobs[codec]
    assert pcontainer.decompress(blob, device=["cpu"] * k) == data


@pytest.mark.parametrize("n_full,tail,k", [
    (7, 1328, 2), (7, 1328, 3), (7, 1328, 4), (5, 0, 2), (5, 0, 3),
    (5, 0, 4), (1, 0, 4), (0, 999, 4), (2, 3, 3), (3, 4095, 4)])
def test_stream_counts_over_shares(n_full, tail, k):
    """Stream counts that k does not divide, with and without a ragged
    tail, and shares left empty (one stream over 4): the same container
    as one device, and the round trip through the shares."""
    rng = np.random.default_rng(n_full * 10 + tail)
    data = _alphabet(rng, (n_full * STREAM + tail) // 4 + 1)[
        :n_full * STREAM + tail]
    one = pcontainer.compress(data, "chameleon", STREAM, device="cpu")
    blob = pcontainer.compress(data, "chameleon", STREAM, device=["cpu"] * k)
    assert blob == one
    assert len(_parts(blob)) == n_full + (tail > 0)
    assert pcontainer.decompress(blob, device=["cpu"] * k) == data
    assert jcontainer.decompress(blob) == data


def test_shares_split_like_a_sharded_axis():
    assert mesh.shares(8, 4) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert mesh.shares(7, 2) == [(0, 4), (4, 7)]
    assert mesh.shares(8, 3) == [(0, 3), (3, 6), (6, 8)]
    assert mesh.shares(1, 4) == [(0, 1), (1, 1), (1, 1), (1, 1)]
    assert mesh.shares(0, 2) == [(0, 0), (0, 0)]
    assert mesh.shares(5, 4) == [(0, 2), (2, 4), (4, 5), (5, 5)]


def test_device_lists():
    cpu = torch.device("cpu")
    assert mesh.resolve_devices("cpu") == [cpu]
    assert mesh.resolve_devices(["cpu", "cpu"]) == [cpu, cpu]
    assert mesh.resolve_devices(("cpu",)) == [cpu]
    with pytest.raises(ValueError):
        mesh.resolve_devices([])
    assert mesh.process_count() == 1 and mesh.process_index() == 0
    mesh.distributed_init()  # one process: nothing to start
    if not torch.cuda.is_available():
        for device in (None, "cuda", ["cpu", "cuda"]):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                mesh.resolve_devices(device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pcontainer.compress(b"abc", device=None)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("route", ["device", "pool"])
@pytest.mark.parametrize("codec", ["cheetah", "lion"])
def test_decompress_through_shares(jax_blobs, monkeypatch, codec, route, k):
    """Both routes, chosen once for the whole container: the device route
    decodes each non-empty share on its device (one `decode_batch` per
    share), the pool every stream of the container in one call."""
    data = _input(codec)
    blob = jax_blobs[codec]
    monkeypatch.setattr(sharding, "PREDICTED_DEVICE_CUTOFF",
                        1.0 if route == "device" else -1.0)
    seen = _route_spies(monkeypatch)
    assert pcontainer.decompress(blob, device=["cpu"] * k) == data
    n = len(_parts(blob))
    live = sum(b > a for a, b in mesh.shares(n, k))
    assert seen == ([route] * live if route == "device" else ["pool"])


def test_decode_prep_stages_each_share():
    data = _input("chameleon")
    blob = pcontainer.compress(data, "chameleon", STREAM, device="cpu")
    shards, streams, meta = sharding.decode_prep(blob, device=["cpu"] * 3)
    assert [(a, b) for a, b, _ in shards] == [(0, 3), (3, 6), (6, 8)]
    one, _, _ = sharding.decode_prep(blob, device="cpu")
    for a, b, args in shards:
        for got, want in zip(args[1:], one[1:]):  # woff ... out_len
            assert torch.equal(got, want[a:b])
    outs = [sharding.decode_batch(*args) for _, _, args in shards]
    got = sharding._finish([o[0] for o in outs], [o[1] for o in outs],
                           [o[2] for o in outs], streams, *meta[2:5])
    assert b"".join(got) == data


@pytest.mark.parametrize("codec", CODECS)
def test_decode_streams_over_shares(jax_blobs, codec):
    """Bare streams in shares, a zero-length stream at a share boundary
    left in its place (neither scanned nor decoded)."""
    data = _input(codec)
    parts = _parts(jax_blobs[codec])
    chunks = [data[i:i + STREAM] for i in range(0, len(data), STREAM)]
    assert sharding.decode_streams(parts, None, ["cpu"] * 3, codec) == chunks
    out_lens = [len(c) for c in chunks]
    z = mesh.shares(len(parts), 2)[1][0]  # the second share's first
    out_lens[z] = 0
    parts[z] = b"\x01"  # not a stream
    got = sharding.decode_streams(parts, out_lens, ["cpu"] * 2, codec)
    assert got == chunks[:z] + [b""] + chunks[z + 1:]


@pytest.mark.parametrize("codec", CODECS)
def test_packages_decode_each_other(jax_blobs, codec):
    data = _input(codec)
    blob = pcontainer.compress(data, codec, STREAM, device=["cpu"] * 3)
    assert jcontainer.decompress(blob) == data
    assert pcontainer.decompress(jax_blobs[codec], device=["cpu"] * 4) == data
