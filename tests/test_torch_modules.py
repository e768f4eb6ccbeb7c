"""The port's chameleon modules against their JAX counterparts on the CPU:
hash and fingerprint arithmetic (quads with the top bit set), the
protection FSM, the encode planner, the decode map resolution, the host
block scanner and the scalar encoder.

Both packages get the same numpy inputs, made from a seed; every
comparison is exact (integer arithmetic). Pallas kernels run in
interpret mode; above 16384 quads the JAX side is its XLA path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from density_tpu import native
from density_tpu.constants import CHAMELEON as JCHAMELEON
from density_tpu.codecs import chameleon as jcham
from density_tpu.codecs.scalar import ScalarChameleon
from density_tpu.engine import grouping as jgrouping
from density_tpu.engine import unlayout as junlayout
from density_tpu.engine.protection import replay_fsm_np
from density_tpu.native import fallback as jfallback
from density_tpu_torch import host_scan
from density_tpu_torch.constants import CHAMELEON
from density_tpu_torch.codecs import chameleon as pcham
from density_tpu_torch.engine import grouping, unlayout
from density_tpu_torch.engine.protection import replay_fsm
from density_tpu_torch.kernels import unpack

# The test workers share the machine's cores with each other and with
# XLA; torch's own thread pool on top of them only oversubscribes it.
torch.set_num_threads(1)


def _quads(rng, shape, top_bit_share=0.5):
    """uint32 quads, about `top_bit_share` of them >= 2**31."""
    q = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    top = rng.random(shape) < top_bit_share
    return np.where(top, q | 0x80000000, q & 0x7FFFFFFF).astype(np.uint32)


def _vocab_quads(rng, shape, n_vocab=61):
    """Compressible quads: a small vocabulary, top bits included."""
    return _quads(rng, n_vocab)[rng.integers(0, n_vocab, shape)]


def _corpus(rng, n, mode):
    text = b"".join([b"the quick brown fox ", b"jumps over ",
                     b"lazy dog "][rng.integers(0, 3)] for _ in range(n // 9))
    rand = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if mode == "text":
        return text[:n]
    if mode == "random":
        return rand
    return b"".join(text[i:i + 3000] + rand[i:i + 3000]
                    for i in range(0, n, 6000))[:n]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_quads_top_bit(seed):
    q = _quads(np.random.default_rng(seed), 4096, top_bit_share=0.9)
    want = np.asarray(jgrouping.hash_quads(jnp.asarray(q)))
    got = grouping.hash_quads(torch.from_numpy(q.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert got.min() >= 0 and got.max() < 65536


@pytest.mark.parametrize("seed", [0, 1])
def test_cmp16_round_trip(seed):
    """(hash, cmp16) <-> quad is a bijection, top bit included, and the
    fingerprint equals the JAX package's."""
    q = _quads(np.random.default_rng(seed), 4096, top_bit_share=0.5)
    tq = torch.from_numpy(q.view(np.int32))
    c16 = unlayout.quad_cmp16(tq)
    want = np.asarray(junlayout.quad_cmp16(jnp.asarray(q)))
    np.testing.assert_array_equal(c16.numpy(), want.astype(np.int32))
    back = unlayout.quad_from_cmp16(grouping.hash_quads(tq), c16)
    np.testing.assert_array_equal(back.numpy(), q.view(np.int32))


@pytest.mark.parametrize("density", [0.0, 0.3, 0.7, 1.0])
def test_replay_fsm_matches_numpy(density):
    rng = np.random.default_rng(int(density * 10))
    bits = rng.random((5, 700)) < density
    got = replay_fsm(bits)
    for s in range(bits.shape[0]):
        np.testing.assert_array_equal(got[s], replay_fsm_np(bits[s]))
    np.testing.assert_array_equal(replay_fsm(bits[0]), replay_fsm_np(bits[0]))


def test_prev_valid_value_in_group_matches_jax():
    rng = np.random.default_rng(5)
    group = rng.integers(0, 40, (2, 3000)).astype(np.int32)
    values = rng.integers(-2**31, 2**31, (2, 3000),
                          dtype=np.int64).astype(np.int32)
    valid = rng.random((2, 3000)) < 0.6
    got_v, got_h = grouping.prev_valid_value_in_group(
        *map(torch.from_numpy, (group, values, valid)))
    for s in range(2):
        wv, wh = jgrouping.prev_valid_value_in_group(
            jnp.asarray(group[s]), jnp.asarray(values[s]),
            jnp.asarray(valid[s]))
        np.testing.assert_array_equal(got_v[s].numpy(), np.asarray(wv))
        np.testing.assert_array_equal(got_h[s].numpy(), np.asarray(wh))


def _check_plan(got, want):
    names = ("flags", "pw", "w0", "w1", "real", "bits")
    for name, g, w in zip(names, got, want):
        w = np.broadcast_to(np.asarray(w), g.shape)
        np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype),
                                      err_msg=name)


def test_plan_fast_matches_pallas():
    """The 1-key branch (n_q <= 2^16) against plan_fast_pallas on the
    Pallas sort in interpret mode; a ragged stream included."""
    rng = np.random.default_rng(11)
    q = _vocab_quads(rng, (2, 16384))
    nbytes = np.array([65536, 65533], np.int32)
    got = pcham.plan_fast(torch.from_numpy(q.view(np.int32)),
                          torch.from_numpy(nbytes))
    want = jcham.plan_fast_pallas(jnp.asarray(q), jnp.asarray(nbytes),
                                  interpret=True)
    _check_plan(got, want)


def test_plan_fast_two_key_branch_matches_xla():
    """The 2-key cmp16 branch (n_q = 2^17) against the JAX package's XLA
    copy-free plan (the same semantics, without the Pallas sort)."""
    rng = np.random.default_rng(12)
    q = _vocab_quads(rng, (1, 1 << 17), n_vocab=3000)
    q[0, :5] = 0  # zero quads hash to group 0: the first-in-group rule
    nbytes = np.array([(1 << 19) - 2], np.int32)
    got = pcham.plan_fast(torch.from_numpy(q.view(np.int32)),
                          torch.from_numpy(nbytes))
    want = jcham.PIPELINE.plan_fast(jnp.asarray(q), jnp.asarray(nbytes))
    _check_plan(got, want)


def test_resolve_matches_pallas():
    """Map resolution on tokens of two reference-encoded streams, against
    resolve_chameleon on the Pallas sort in interpret mode."""
    rng = np.random.default_rng(13)
    N = 16384
    words = np.zeros((2, 40000), np.uint32)
    woff = np.full((2, N // 64), -1, np.int32)
    out_len = []
    for s, mode in enumerate(("text", "mixed")):
        data = _corpus(rng, 60000 + s, mode)
        enc = native.encode("chameleon", data)
        in_off, _, is_copy = native.scan("chameleon", enc)
        words[s, :len(enc) // 2] = np.frombuffer(enc[:len(enc) // 2 * 2],
                                                 "<u2")
        woff[s, :len(in_off)] = np.where(is_copy, -1, in_off // 2)
        out_len.append(len(data))
    flags, w0, w1 = unpack.unpack(torch.from_numpy(words.view(np.int32)),
                                  torch.from_numpy(woff), q=64, sig_words=4,
                                  flag_bits=1)
    real = torch.arange(N)[None, :] < torch.tensor(out_len)[:, None] // 4
    valid = real & (torch.from_numpy(woff) >= 0).repeat_interleave(64, 1)
    is_map = (flags == 1) & valid
    is_plain = valid & ~is_map
    plain = w0 | (w1 << 16)
    h = torch.where(is_map, w0, grouping.hash_quads(plain))
    got = unlayout.resolve_chameleon(is_map, is_plain, h, plain)
    want = junlayout.resolve_chameleon(
        jnp.asarray(is_map.numpy()), jnp.asarray(is_plain.numpy()),
        jnp.asarray(h.numpy().astype(np.uint32)),
        jnp.asarray(plain.numpy().view(np.uint32)), interpret=True)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


def test_decode_two_key_resolve_matches_xla():
    """A 300 KB stream decodes at 2^17 quads (the 2-key resolve branch):
    the same bytes as the JAX package's XLA decode."""
    data = _corpus(np.random.default_rng(14), 300_001, "mixed")
    enc = native.encode("chameleon", data)
    got = pcham.decode(enc, device="cpu")
    assert got == data
    assert got == jcham.decode(enc)


def test_seg_fill_last_nonzero_brute_force():
    rng = np.random.default_rng(0)
    S, N = 2, 2048
    grp = np.sort(rng.integers(0, 30, (S, N)), axis=1)
    isp = rng.random((S, N)) < 0.3
    c16 = rng.integers(0, 65536, (S, N))
    x = np.where(isp, (1 << 16) | c16, 0).astype(np.int32)
    first = np.ones((S, N), bool)
    first[:, 1:] = grp[:, 1:] != grp[:, :-1]
    got = unlayout.seg_fill_last_nonzero(torch.from_numpy(x),
                                         torch.from_numpy(first)).numpy()
    for s in range(S):
        last = 0
        for i in range(N):
            if first[s, i]:
                last = 0
            if isp[s, i]:
                last = x[s, i]
            assert got[s, i] == last


@pytest.mark.parametrize("mode,n", [("text", 70001), ("random", 50002),
                                    ("mixed", 90003), ("text", 3),
                                    ("mixed", 300)])
def test_scanner_matches_fallback(mode, n):
    enc = native.encode("chameleon",
                        _corpus(np.random.default_rng(n), n, mode))
    got = host_scan.scan_with_counts(enc)
    want = jfallback.scan_with_counts("chameleon", enc)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3:] == tuple(want[3:])


@pytest.mark.parametrize("mode,n", [("text", 20001), ("random", 20002),
                                    ("mixed", 40003), ("text", 125)])
def test_scalar_encoder_matches(mode, n):
    data = _corpus(np.random.default_rng(n), n, mode)
    assert host_scan.encode_scalar(data) == ScalarChameleon().encode(data)


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 262144, 230974])
def test_safe_encode_buffer_size_matches(n):
    """The worst-case encoded size bounds the scalar encoder's output."""
    assert CHAMELEON.safe_encode_buffer_size(n) == (
        JCHAMELEON.safe_encode_buffer_size(n))
    data = np.random.default_rng(n).integers(0, 256, min(n, 4096),
                                             dtype=np.uint8).tobytes()
    assert len(host_scan.encode_scalar(data)) <= (
        CHAMELEON.safe_encode_buffer_size(len(data)))
