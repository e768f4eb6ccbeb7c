"""The port's pack and unpack kernel modules (density_tpu_torch.kernels)
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

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

from density_tpu import native
from density_tpu.engine import unlayout as junlayout
from density_tpu.kernels import packroute as jpackroute
from density_tpu.kernels import unpack as junpack
from density_tpu_torch.codecs import chameleon as pcham
from density_tpu_torch.engine import layout as playout
from density_tpu_torch.errors import DecodeError
from density_tpu_torch.kernels import packroute, unpack

Q = 64
CHAM = dict(q=64, sig_words=4, flag_bits=1)

# The test workers share the machine's cores with each other and with
# XLA; torch's own thread pool on top of them only oversubscribes it.
torch.set_num_threads(1)


def _corpus(rng, n, mode):
    if mode == "text":
        parts = [b"the quick brown fox ", b"jumps over ", b"lazy dog ",
                 rng.integers(0, 256, 64, dtype=np.uint8).tobytes()]
        return b"".join(parts[rng.integers(0, 4)]
                        for _ in range(n // 12))[:n]
    mix = bytearray()
    while len(mix) < n:
        mix += (b"abcd" * 700)[:2800]
        mix += rng.integers(0, 256, 2800, dtype=np.uint8).tobytes()
    return bytes(mix)[:n]


# ---------------------------------------------------------------- pack

@pytest.mark.parametrize("tail", [0, 1, 3, 555])
def test_pack_matches_pallas(tail):
    """Packing the planner's tokens, ragged tails and the multi-group
    word base included (as tests/test_pack_kernel.py does for JAX)."""
    rng = np.random.default_rng(1000 + tail)
    S, N = 2, 16384
    vocab = rng.integers(1, 1 << 32, 61, dtype=np.uint64).astype(np.uint32)
    quads = vocab[rng.integers(0, 61, (S, N))].view(np.int32)
    nbytes = np.array([N * 4, N * 4 - tail], np.int32)
    tq, tn = torch.from_numpy(quads), torch.from_numpy(nbytes)
    flags, pw, w0, w1, _, _ = pcham.plan_fast(tq, tn)
    w0, w1 = playout.stamp_ragged(tq, tn, w0, w1)
    tokens = [x.numpy() for x in (flags, pw, w0, w1)]
    kw = dict(q=64, sig_words=4, block=256, flag_bits=1)
    want = np.asarray(jpackroute.pack(*map(jnp.asarray, tokens),
                                      jnp.asarray(nbytes), interpret=True,
                                      **kw))
    got = packroute.pack(*map(torch.from_numpy, tokens), tn, **kw).numpy()
    totals = 2 * tokens[1].sum(1) + 8 * (-(-nbytes // 256)) + nbytes % 4
    for s in range(S):
        t = (int(totals[s]) + 1) // 2
        np.testing.assert_array_equal(got[s, :t], want[s, :t])
        assert not got[s, t:].any()
    assert packroute.check_route_invariants(tokens[0], tokens[1], nbytes,
                                            **kw)
    assert jpackroute.check_route_invariants(tokens[0], tokens[1], nbytes,
                                             **kw)


# ---------------------------------------------------------------- unpack

def _stage(encs, nb_pad):
    """Stage reference-encoded streams as both packages take them."""
    scans = [native.scan("chameleon", e) for e in encs]
    W = max((len(e) + 255) // 256 * 128 for e in encs)
    words = np.zeros((len(encs), W), np.uint32)
    woff = np.full((len(encs), nb_pad), -1, np.int32)
    copyf = np.zeros((len(encs), nb_pad), bool)
    for s, (e, (in_off, _, is_copy)) in enumerate(zip(encs, scans)):
        words[s, :(len(e) + 1) // 2] = np.frombuffer(
            e + b"\0" * (len(e) % 2), "<u2")
        woff[s, :len(in_off)] = in_off // 2
        copyf[s, :len(in_off)] = is_copy.astype(bool)
    return words, woff, copyf


def test_unpack_matches_pallas():
    """Two streams, one with copy blocks: flags and w0 equal everywhere,
    w1 wherever the token has two words (plain tokens, copy blocks)."""
    rng = np.random.default_rng(7)
    data = [_corpus(rng, 60000, "text"), _corpus(rng, 60003, "mixed")]
    encs = [native.encode("chameleon", d) for d in data]
    words, woff, copyf = _stage(encs, 16384 // Q)
    assert copyf[1].any() and not copyf[0].any()
    want = [np.asarray(x) for x in junpack.unpack(
        jnp.asarray(words), jnp.asarray(woff), jnp.asarray(copyf),
        interpret=True, **CHAM)]
    got = [x.numpy() for x in unpack.unpack(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(woff),
        torch.from_numpy(copyf), **CHAM)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    live = np.repeat(woff >= 0, Q, axis=1)
    two = live & ((got[0] == 0) | np.repeat(copyf, Q, axis=1))
    np.testing.assert_array_equal(got[2][two], want[2][two])
    assert not got[2][~live].any()


@pytest.mark.parametrize("q,sig_words,flag_bits", [(32, 4, 2), (16, 3, 3)])
def test_unpack_geometry_matches_xla_extraction(q, sig_words, flag_bits):
    """The cheetah (2-bit) and lion (3-bit, straddling) geometries against
    the JAX package's XLA extraction on random words."""
    rng = np.random.default_rng(q)
    S, NB = 2, 64
    span = sig_words + 2 * q
    woff = np.cumsum(rng.integers(sig_words, span, (S, NB)), axis=1) - span
    woff = np.maximum(woff, 0).astype(np.int32)
    W = int(woff.max()) + span + 8
    words = rng.integers(0, 1 << 16, (S, W)).astype(np.uint32)
    wf, ww0, ww1 = (np.asarray(x) for x in junlayout.extract_tokens_xla(
        jnp.asarray(words), jnp.asarray(woff), q, sig_words, flag_bits))
    gf, gw0, gw1 = (x.numpy() for x in unpack.unpack(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(woff),
        q=q, sig_words=sig_words, flag_bits=flag_bits))
    np.testing.assert_array_equal(gf, wf)
    pw = unpack.flag_payload_words(torch.from_numpy(gf), flag_bits)
    has = pw.numpy() >= 1
    np.testing.assert_array_equal(gw0[has], ww0[has])
    np.testing.assert_array_equal(gw1[has], ww1[has])
    assert not gw0[~has].any()


@pytest.mark.parametrize("where", ["at_end", "past_end", "sig_overrun",
                                   "int32_max"])
def test_unpack_malformed_offset_raises(where):
    """A live block starting outside the words raises DecodeError and
    never reads out of bounds (ADVICE.md's finding on the TPU kernel's
    packed routing, which could mis-route such a word)."""
    rng = np.random.default_rng(3)
    enc = native.encode("chameleon", _corpus(rng, 20000, "text"))
    words, woff, copyf = _stage([enc], 16384 // Q)
    W = words.shape[1]
    woff[0, 5] = {"at_end": W, "past_end": W + 0x10000,
                  "sig_overrun": W - 2, "int32_max": 2**31 - 1}[where]
    with pytest.raises(DecodeError):
        unpack.unpack(torch.from_numpy(words.view(np.int32)),
                      torch.from_numpy(woff), torch.from_numpy(copyf), **CHAM)
