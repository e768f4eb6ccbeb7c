"""The port's lion codec against the JAX package's, on the CPU.

Module by module: the 5-slot queue scan and the MTF-5 depths, the
signature packing, the masked classifier, the copy-free planner
(`plan_fast_pallas`, with its Pallas sorts in interpret mode, under both
sort options), token extraction, the context-fixpoint resolve
(interpret mode) and assembly, on the same seeded numpy inputs at S=2
streams of 4096 quads; and the planner's 2-key branch above 65536 quads
against the native encoder. The slice as a whole is in
`test_torch_lion_container.py`. Every comparison is exact.

Each JAX reference that compiles a Pallas kernel in interpret mode is
computed once, in a module fixture, at one shape.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from density_tpu import native as jnative
from density_tpu.codecs import lion as jlion
from density_tpu.engine import grouping as jg
from density_tpu.engine import mtf as jmtf
from density_tpu_torch import container as pcontainer
from density_tpu_torch.codecs import lion as plion
from density_tpu_torch.engine import grouping as pg
from density_tpu_torch.engine import mtf as pmtf
from density_tpu_torch.parallel import sharding
from tests.test_torch_cheetah import (
    _alphabet, _eq, _mixed, _quads, _stdlib_text, _t, _text)

torch.set_num_threads(1)

S, N = 2, 4096  # streams x quads of the interpret-mode references
K = plion.K


def _chopped(rng, n: int, run: int = 200) -> bytes:
    """Stdlib text in runs of `run` bytes, each followed by half as many
    random bytes: predictions in short chains, so the lion fixpoint
    converges in a few dozen rounds (whole text needs over a hundred)."""
    text = _stdlib_text(2 * n)
    rand = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    parts, i = [], 0
    while sum(map(len, parts)) < n:
        parts += [text[i:i + run], rand[i:i + run // 2]]
        i += run
    return b"".join(parts)[:n]


# ---------------------------------------------------------------- scans

def _scan_inputs(seed, kind):
    """Segment starts and values of three rows: "alphabet" (values 0-6),
    "text" (the quads of stdlib text) or "ties" (values 0-1, long
    segments); a tenth of the positions invalid."""
    rng = np.random.default_rng(seed)
    shape = (3, 1024)
    first = rng.random(shape) < (0.01 if kind == "ties" else 0.1)
    first[:, 0] = True
    if kind == "alphabet":
        vals = rng.integers(0, 7, shape).astype(np.uint32)
        vals[1] = rng.integers(0, 1 << 32, shape[1], dtype=np.uint64)
    elif kind == "text":
        vals = np.frombuffer(_stdlib_text(4 * 3 * 1024), "<u4").reshape(shape)
    else:
        vals = rng.integers(0, 2, shape).astype(np.uint32)
    valid = rng.random(shape) < 0.9
    return first, vals, valid


@pytest.mark.parametrize("kind", ["alphabet", "text", "ties"])
def test_mtf_depths_sorted_matches(kind):
    first, vals, valid = _scan_inputs(1, kind)
    want = jmtf.mtf_depths_sorted(jnp.asarray(first), jnp.asarray(vals),
                                  jnp.asarray(valid), K, axis=1)
    got = pmtf.mtf_depths_sorted(_t(first), _t(vals), _t(valid), K)
    _eq(got, want)
    assert (np.asarray(want) < K).any() and (np.asarray(want) == K).any()


@pytest.mark.parametrize("kind", ["alphabet", "text", "ties"])
def test_mtf_depths_in_group_matches(kind):
    _, vals, valid = _scan_inputs(2, kind)
    rng = np.random.default_rng(3)
    group = rng.integers(0, 3 if kind == "ties" else 40,
                         vals.shape).astype(np.int32)
    want = np.stack([np.asarray(jmtf.mtf_depths_in_group(
        jnp.asarray(group[i]), jnp.asarray(vals[i]), jnp.asarray(valid[i]),
        K)) for i in range(vals.shape[0])])
    _eq(pmtf.mtf_depths_in_group(_t(group), _t(vals), _t(valid), K), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_seg_selq_before_matches(seed):
    first, vals, _ = _scan_inputs(seed, "alphabet")
    rng = np.random.default_rng(seed + 20)
    kind = rng.integers(0, 3, vals.shape).astype(np.int32)
    depth = rng.integers(0, K, vals.shape).astype(np.int32)
    want = jg.seg_selq_before(jnp.asarray(first), jnp.asarray(kind),
                              jnp.asarray(depth), jnp.asarray(vals), K,
                              axis=1)
    got = pg.seg_selq_before(_t(first), _t(kind), _t(depth), _t(vals), K)
    assert got.shape == (3, 1024, K)
    _eq(got, want)


def test_shift_n_takes_a_broadcast_fill():
    x = torch.arange(24, dtype=torch.int32).reshape(2, 4, 3)
    ident = torch.tensor([7, 8, 9])
    got = pg.shift_n(x, 2, ident, dim=1)
    assert torch.equal(got[:, :2], ident.expand(2, 2, 3).to(torch.int32))
    assert torch.equal(got[:, 2:], x[:, :2])
    assert torch.equal(pg.shift_n(x, 5, ident, dim=1),
                       ident.expand(2, 4, 3).to(torch.int32))


def test_sig_pack_unpack_match():
    """Random 3-bit flags, so flag 10 (bits 30-32) straddles words 1 and
    2 with every bit pattern."""
    rng = np.random.default_rng(4)
    flags = rng.integers(0, 8, (257, 16)).astype(np.int32)
    flags[:8, 10] = np.arange(8)
    want = jlion.sig_pack(jnp.asarray(flags))
    got = plion.sig_pack(_t(flags))
    _eq(got, want)
    _eq(plion.sig_unpack(got), jlion.sig_unpack(jnp.asarray(want)))
    _eq(plion.sig_unpack(got), flags)


# ---------------------------------------------------------------- encode

@pytest.fixture(scope="module")
def plan_case():
    """Two streams (a 1024-value alphabet with a run of zero quads, and
    stdlib text ending ragged), and the JAX planner's six outputs under
    each sort option (its Pallas sorts in interpret mode)."""
    rng = np.random.default_rng(3)
    a = bytearray(_alphabet(rng, N))
    a[400:600] = bytes(200)
    text = _stdlib_text(4 * N - 3)
    quads = _quads([bytes(a), text])
    nbytes = np.array([4 * N, len(text)], np.int32)
    refs = {}
    for option in ("bigsort", "bitonic"):
        os.environ["DENSITY_TPU_SORT"] = option
        try:
            refs[option] = [np.asarray(x) for x in jlion.plan_fast_pallas(
                jnp.asarray(quads), jnp.asarray(nbytes), interpret=True)]
        finally:
            del os.environ["DENSITY_TPU_SORT"]
    return quads, nbytes, refs


@pytest.mark.parametrize("option", ["bigsort", "bitonic"])
def test_plan_fast_matches(plan_case, option, monkeypatch):
    quads, nbytes, refs = plan_case
    monkeypatch.setenv("DENSITY_TPU_SORT", option)
    got = plion.plan_fast(_t(quads), torch.from_numpy(nbytes))
    assert len(got) == len(refs[option]) == 6
    for g, w in zip(got, refs[option]):
        _eq(g, w)
    for g, w in zip(refs["bigsort"], refs["bitonic"]):
        np.testing.assert_array_equal(g, w)
    flags = refs[option][0]
    for f in range(8):  # every flag occurs
        assert (flags == f).any()


def test_classify_masked_matches(plan_case):
    """The masked classifier of the fixed point, under a copy-block mask
    (blocks 3-5 and 140 of stream 0, every third block of stream 1)."""
    quads, nbytes, _ = plan_case
    nb = N // plion.Q
    copy = np.zeros((S, nb), bool)
    copy[0, [3, 4, 5, 140]] = True
    copy[1, ::3] = True
    real = np.arange(N)[None, :] < (nbytes[:, None] // 4)
    hashes = np.asarray(jg.hash_quads(jnp.asarray(quads)))
    got = plion.classify(_t(quads), _t(hashes), _t(real), _t(copy))
    for s in range(S):
        p = jlion.classify(jnp.asarray(quads[s]), jnp.asarray(hashes[s]),
                           jnp.asarray(real[s]), jnp.asarray(copy[s]))
        want = (p.flags, p.payload_words, p.w0, p.w1, p.valid)
        for g, w in zip(got, want):
            _eq(g[s], w)


def test_plan_fast_large_streams_equal_native():
    """Above 65536 quads the planner makes 2-key 3-array sorts: one
    2^17-quad stream (and its 4096-quad ragged tail) against the JAX
    package's native encoder."""
    rng = np.random.default_rng(4)
    data = _stdlib_text(1 << 19) + _text(rng, 9999)
    blob = pcontainer.compress(data, "lion", 1 << 19, device="cpu")
    _, _, _, lengths, off = pcontainer.parse_header(blob)
    ends = off + np.cumsum(lengths)
    parts = [blob[e - n:e] for e, n in zip(ends, lengths)]
    assert parts == [jnative.encode("lion", data[:1 << 19]),
                     jnative.encode("lion", data[1 << 19:])]


# ---------------------------------------------------------------- decode

def _staged(streams, out_lens):
    """The port's staged decode inputs of byte strings (lion)."""
    woff, copyf, nb_real, _ = sharding._scan("lion", streams, out_lens)
    return sharding._stage(streams, out_lens, woff, copyf, nb_real, "cpu")


def _jax_args(args):
    return [jnp.asarray(a.numpy().astype(np.uint32) if i == 0 else a.numpy())
            for i, a in enumerate(args)]


@pytest.fixture(scope="module")
def decode_case():
    """Stream 0 converges (alphabet quads), stream 1 is chopped stdlib
    text (it does not at 12 rounds, it does at 40); their tokens, and the
    JAX resolve at 12 and at 40 rounds (interpret mode)."""
    rng = np.random.default_rng(5)
    data = [_alphabet(rng, N), _chopped(rng, 4 * N)]
    streams = [jnative.encode("lion", d) for d in data]
    args = _staged(streams, [4 * N, 4 * N])
    jargs = _jax_args(args)
    toks = jax.vmap(jlion._extract_tokens)(*jargs)
    res = [[np.asarray(x) for x in jlion._resolve_parallel_batched(
        *toks, max_rounds=rounds, interpret=True)] for rounds in (12, 40)]
    return data, args, jargs, [np.asarray(t) for t in toks], *res


def test_extract_tokens_matches(decode_case):
    _, args, _, toks, _, _ = decode_case
    got = plion.extract_tokens(*args)
    for g, w in zip(got, toks):
        _eq(g, w)


def test_extract_and_assemble_with_copy_blocks():
    """Streams with copy blocks and ragged ends: extraction and assembly
    against JAX's (XLA) on the same staged inputs."""
    rng = np.random.default_rng(6)
    data = [_mixed(rng, 4 * N - 2), _mixed(rng, 9001), _text(rng, 3)]
    streams = [jnative.encode("lion", d) for d in data]
    args = _staged(streams, [len(d) for d in data])
    assert bool(args[2].any())
    jargs = _jax_args(args)
    got = plion.extract_tokens(*args)
    want = jax.vmap(jlion._extract_tokens)(*jargs)
    for g, w in zip(got, want):
        _eq(g, w)
    n_q = args[1].shape[1] * plion.Q
    quads = _quads(data, n_q)
    valid = np.asarray(want[3])
    out = plion.assemble(_t(quads), got[3], *args)
    ref = jax.vmap(jlion._assemble)(jnp.asarray(quads), jnp.asarray(valid),
                                    *jargs)
    _eq(out, ref)


def test_resolve_matches_at_12_rounds(decode_case):
    data, _, _, toks, (quads, ok), _ = decode_case
    got_q, got_ok, rounds = plion.resolve(*[_t(t) for t in toks],
                                          max_rounds=12)
    np.testing.assert_array_equal(got_ok.numpy(), ok)
    assert ok.tolist() == [True, False] and rounds == 12
    _eq(got_q, quads)
    valid = toks[3]
    np.testing.assert_array_equal(
        got_q[0].numpy().view(np.uint32)[valid[0]],
        np.frombuffer(data[0], np.uint32)[valid[0]])


def test_resolve_converges_at_raised_rounds(decode_case):
    """Chopped text (which needs more than 12 rounds) converges with
    more; the quads are JAX's and the input's."""
    data, _, _, toks, _, (quads, ok) = decode_case
    got_q, got_ok, rounds = plion.resolve(*[_t(t) for t in toks],
                                          max_rounds=40)
    assert ok.all() and got_ok.all() and 12 < rounds < 40
    _eq(got_q, quads)
    valid = toks[3]
    np.testing.assert_array_equal(got_q.numpy().view(np.uint32)[valid],
                                  _quads(data)[valid])


def test_assemble_matches(decode_case):
    _, args, jargs, toks, _, (quads, _) = decode_case
    got = plion.assemble(_t(quads), _t(toks[3]), *args)
    want = jax.vmap(jlion._assemble)(jnp.asarray(quads), jnp.asarray(toks[3]),
                                     *jargs)
    _eq(got, want)
