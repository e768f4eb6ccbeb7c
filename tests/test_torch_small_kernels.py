"""The port's kernel modules of the small-stream slice against the JAX
package's Pallas kernels, run in interpret mode on the CPU:
`kernels/bitonic.py` (the whole sort network in one launch) and
`kernels/pack.py` (the pack kernel of 4096- and 8192-quad streams).

Here every wrapper takes its plain PyTorch version (the tensors lie on
the CPU); the CUDA kernels are held against those same plain versions
on the card by `chip_smoke.py` and the `gpu`-marked tests. Both
packages get the same numpy inputs, made from a seed. All arithmetic
is integer, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from density_tpu.codecs import chameleon as jcham
from density_tpu.kernels import bitonic as jbitonic
from density_tpu.kernels import pack as jpack
from density_tpu_torch.engine import layout
from density_tpu_torch.kernels import bigsort, bitonic, pack, unpack

# The test workers share the machine's cores with each other and with
# XLA; torch's own thread pool on top of them only oversubscribes it.
torch.set_num_threads(1)


def _i32(rng, shape, lo, hi):
    return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)


# ---------------------------------------------------------------- bitonic

@pytest.mark.parametrize("N,n_keys,n_arr,ties", [
    (256, 1, 1, False), (256, 1, 2, False), (256, 1, 3, True),
    (256, 2, 2, False), (256, 2, 3, True), (4096, 1, 1, False),
    (4096, 1, 2, False), (4096, 1, 3, True), (4096, 2, 2, True),
    (4096, 2, 3, False)])
def test_bitonic_matches_pallas(N, n_keys, n_arr, ties):
    """Signed keys, negative ones included; with many ties the carried
    arrays show that both run the same compare-exchange network. The
    output also equals bigsort's (the same network)."""
    rng = np.random.default_rng(N + 10 * n_keys + n_arr)
    hi = 40 if ties else 2**31
    arrs = [_i32(rng, (2, N), -hi, hi) for _ in range(n_arr)]
    want = jbitonic.sort(*map(jnp.asarray, arrs), n_keys=n_keys,
                         interpret=True)
    got = bitonic.sort(*map(torch.from_numpy, arrs), n_keys=n_keys)
    big = bigsort.sort(*map(torch.from_numpy, arrs), n_keys=n_keys)
    assert len(got) == n_arr
    for g, w, b in zip(got, want, big):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, b)
    assert bitonic.launches == 0  # the CPU never launches the kernel


@pytest.mark.parametrize("N", [128, 768])
def test_bitonic_rejects_bad_lengths(N):
    """N must be a power of two of at least 256, as in the TPU kernel."""
    with pytest.raises(ValueError):
        bitonic.sort(torch.zeros((1, N), dtype=torch.int32))


# ---------------------------------------------------------------- pack

def _check_pack(got, want, pw, nbytes, sig_words, block):
    """Equal u16 values over each stream's ceil(total / 2) words, and the
    port's output zero after them."""
    totals = (2 * pw.sum(1) + 2 * sig_words * (-(-nbytes // block))
              + nbytes % 4)
    for s in range(got.shape[0]):
        t = (int(totals[s]) + 1) // 2
        np.testing.assert_array_equal(got[s, :t], want[s, :t].astype(
            np.int64), err_msg=f"stream {s}")
        assert not got[s, t:].any()


@pytest.mark.parametrize("tail", [0, 1, 3, 555])
@pytest.mark.parametrize("N", [4096, 8192])
def test_pack_matches_pallas(N, tail):
    """Chameleon plans from the JAX planner (Pallas sort, interpret
    mode), ragged tails stamped; a stream shorter than one tile too."""
    rng = np.random.default_rng(N + tail)
    S = 3
    vocab = rng.integers(1, 1 << 32, 61, dtype=np.uint64).astype(np.uint32)
    quads = vocab[rng.integers(0, 61, (S, N))]
    nbytes = np.array([N * 4, N * 4 - tail, 3000 + tail], np.int32)
    quads[2, (3000 + tail + 3) // 4:] = 0  # zero past the stream's end
    plan = jcham.plan_fast_pallas(jnp.asarray(quads), jnp.asarray(nbytes),
                                  interpret=True)
    tq = torch.from_numpy(quads.view(np.int32))
    tn = torch.from_numpy(nbytes)
    flags, pw, w0, w1 = (torch.from_numpy(np.asarray(x).astype(np.int64)
                                          .astype(np.int32))
                         for x in plan[:4])
    w0, w1 = layout.stamp_ragged(tq, tn, w0, w1)
    kw = dict(q=64, sig_words=4, block=256, flag_bits=1)
    want = np.asarray(jpack.pack(*(jnp.asarray(x.numpy())
                                   for x in (flags, pw, w0, w1)),
                                 jnp.asarray(nbytes), interpret=True, **kw))
    got = pack.pack(flags, pw, w0, w1, tn, **kw).numpy()
    _check_pack(got, want, pw.numpy(), nbytes, 4, 256)
    assert pack.launches == 0


@pytest.mark.parametrize("q,sig_words,flag_bits", [(32, 4, 2), (16, 3, 3)])
def test_pack_geometry_matches_pallas(q, sig_words, flag_bits):
    """The cheetah (2-bit) and lion (3-bit, crossing u16 words)
    geometries with seeded flags and ragged tails."""
    rng = np.random.default_rng(q)
    N = 4096
    nbytes = np.array([4 * N, 4 * N - 3, 999], np.int32)
    S = len(nbytes)
    real = np.arange(N)[None, :] < (nbytes[:, None] // 4)
    flags = np.where(real, rng.integers(0, 1 << flag_bits, (S, N)), 0)
    pw = unpack.flag_payload_words(torch.from_numpy(flags), flag_bits)
    pw = np.where(real, pw.numpy(), 0)
    w0, w1 = (rng.integers(0, 1 << 16, (S, N)) for _ in range(2))
    tokens = [x.astype(np.int32) for x in (flags, pw, w0, w1)]
    kw = dict(q=q, sig_words=sig_words, block=4 * q, flag_bits=flag_bits)
    want = np.asarray(jpack.pack(*map(jnp.asarray, tokens),
                                 jnp.asarray(nbytes), interpret=True, **kw))
    got = pack.pack(*map(torch.from_numpy, tokens),
                    torch.from_numpy(nbytes), **kw).numpy()
    _check_pack(got, want, tokens[1], nbytes, sig_words, 4 * q)


def test_pack_rejects_untiled_streams():
    """N must be a multiple of 4096 (the TPU kernel's GQ_MIN)."""
    z = torch.zeros((1, 2048), dtype=torch.int32)
    with pytest.raises(ValueError):
        pack.pack(z, z, z, z, torch.zeros(1, dtype=torch.int32), q=64,
                  sig_words=4, block=256, flag_bits=1)
