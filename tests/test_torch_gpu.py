"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one.

Run them on a machine with a card (it has no JAX, so the repo's
conftest, which imports JAX, is left out):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest \
        -o addopts="" -p no:cacheprovider -q

Inputs are made from a numpy seed; every comparison is exact.
"""

import numpy as np
import pytest
import torch

from density_tpu_torch import container
from density_tpu_torch.errors import DecodeError
from density_tpu_torch.kernels import bigsort, packroute, unpack

pytestmark = pytest.mark.gpu

CHAM = dict(q=64, sig_words=4, flag_bits=1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _data(seed, n):
    rng = np.random.default_rng(seed)
    words = [b"the quick brown fox ", b"jumps over ", b"lazy dog "]
    text = b"".join(words[i] for i in rng.integers(0, 3, n // 8 + 1))
    rand = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    return b"".join(text[i:i + 5000] + rand[i:i + 5000]
                    for i in range(0, n, 10000))[:n]


@pytest.mark.parametrize("S,N,n_keys,n_arr", [
    (3, 256, 1, 1), (38, 65536, 1, 2), (2, 1 << 17, 2, 2),
    (4, 16384, 2, 3), (2, 8192, 1, 3)])
def test_bigsort_matches_plain(cuda, S, N, n_keys, n_arr):
    rng = np.random.default_rng(N + n_arr)
    arrs = [torch.from_numpy(rng.integers(-2**31, 2**31, (S, N),
                                          dtype=np.int64).astype(np.int32))
            for _ in range(n_arr)]
    got = bigsort.sort(*(a.to(cuda) for a in arrs), n_keys=n_keys)
    torch.cuda.synchronize()
    want = bigsort.sort_plain(*arrs, n_keys=n_keys)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("tail", [0, 1, 3, 555])
def test_pack_matches_plain(cuda, tail):
    from density_tpu_torch.codecs import chameleon
    from density_tpu_torch.engine import layout
    data = _data(tail, 4 * 65536)
    buf = np.frombuffer(data, np.uint8).reshape(4, 65536)
    quads = layout.stage_quads(buf, cuda)
    nbytes = torch.tensor([65536, 65536 - tail, 65536, 1000 + tail],
                          dtype=torch.int32, device=cuda)
    flags, pw, w0, w1, _, _ = chameleon.plan_fast(quads, nbytes)
    w0, w1 = layout.stamp_ragged(quads, nbytes, w0, w1)
    kw = dict(q=64, sig_words=4, block=256, flag_bits=1)
    got = packroute.pack(flags, pw, w0, w1, nbytes, **kw)
    torch.cuda.synchronize()
    want = packroute.pack_plain(*(x.cpu() for x in (flags, pw, w0, w1,
                                                    nbytes)), **kw)
    assert torch.equal(got.cpu(), want)


def test_unpack_matches_plain_and_rejects_bad_offsets(cuda):
    from density_tpu_torch.parallel import sharding
    blob = container.compress(_data(5, 3 * 65536 + 7), "chameleon", 65536,
                              device="cpu")
    (words, woff, is_copy, nb_real, _), _, _ = sharding.decode_prep(
        blob, device="cpu")
    assert bool(is_copy.any())
    live = torch.arange(woff.shape[1])[None, :] < nb_real[:, None]
    woff = torch.where(live, woff, -1)
    got = unpack.unpack(words.to(cuda), woff.to(cuda), is_copy.to(cuda),
                        **CHAM)
    torch.cuda.synchronize()
    want = unpack.unpack_plain(words, woff, is_copy, **CHAM)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    bad = woff.clone()
    bad[0, 3] = words.shape[1] + 0x10000
    with pytest.raises(DecodeError):
        unpack.unpack(words.to(cuda), bad.to(cuda), is_copy.to(cuda), **CHAM)


@pytest.mark.parametrize("n", [125, 65536 + 40001, 3 * 65536 + 2])
def test_container_on_card_equals_cpu(cuda, n):
    data = _data(n, n)
    blob = container.compress(data, "chameleon", 65536, device=cuda)
    assert blob == container.compress(data, "chameleon", 65536,
                                      device="cpu")
    assert container.decompress(blob, device=cuda) == data
