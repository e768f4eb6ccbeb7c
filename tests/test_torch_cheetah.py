"""The port's cheetah codec against the JAX package's, on the CPU.

Module by module: the grouping scans, the masked classifier, the
copy-free planner (`plan_fast_pallas`, with its Pallas sorts in
interpret mode, under both sort options), token extraction, the
context-fixpoint resolve (interpret mode) and assembly, on the same
seeded numpy inputs at S=2 streams of 4096 quads; and the planner's
2-key branch above 65536 quads against the native encoder. The slice
as a whole is in `test_torch_cheetah_container.py`. Every comparison is
exact.

Each JAX reference that compiles a Pallas kernel in interpret mode is
computed once, in a module fixture, at one shape.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from density_tpu import native as jnative
from density_tpu.codecs import cheetah as jche
from density_tpu.engine import grouping as jg
from density_tpu_torch import container as pcontainer
from density_tpu_torch.codecs import cheetah as pche
from density_tpu_torch.engine import grouping as pg
from density_tpu_torch.parallel import sharding

torch.set_num_threads(1)

S, N = 2, 4096  # streams x quads of the interpret-mode references


def _stdlib_text(n: int) -> bytes:
    """Python source text of this machine's stdlib, in sorted order."""
    root = os.path.dirname(os.__file__)
    parts, size = [], 0
    for name in sorted(os.listdir(root)):
        if name.endswith(".py"):
            with open(os.path.join(root, name), "rb") as f:
                parts.append(f.read())
            size += len(parts[-1])
            if size >= n:
                break
    return b"".join(parts)[:n]


def _alphabet(rng, n_quads: int, size: int = 1024) -> bytes:
    """Quads drawn i.i.d. from `size` random values (top bits included):
    map tokens are common, predictions rare."""
    vals = rng.integers(0, 1 << 32, size, dtype=np.uint64).astype(np.uint32)
    return vals[rng.integers(0, size, n_quads)].tobytes()


def _text(rng, n: int) -> bytes:
    words = [b"the quick brown fox ", b"jumps over ", b"lazy dog ",
             b"density ", b"cheetah\n"]
    return b"".join(words[i] for i in rng.integers(0, 5, n // 4 + 1))[:n]


def _mixed(rng, n: int) -> bytes:
    rand = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    text = _text(rng, n)
    return b"".join(text[i:i + 3000] + rand[i:i + 3000]
                    for i in range(0, n, 6000))[:n]


def _quads(streams, n_q=N):
    """Zero-padded (len(streams), n_q) uint32 quads of byte strings."""
    out = np.zeros((len(streams), 4 * n_q), np.uint8)
    for i, s in enumerate(streams):
        out[i, :len(s)] = np.frombuffer(s, np.uint8)
    return out.view("<u4")


def _t(a):
    """numpy -> torch int32 bit patterns (bool stays bool)."""
    a = np.asarray(a)
    if a.dtype == bool:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.astype(np.uint32).view(np.int32).copy())


def _eq(got, want):
    """Exact equality of a port tensor and a JAX/numpy array, compared
    as unsigned 32-bit values (bools as bools)."""
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got.astype(np.uint32),
                                      want.astype(np.uint32))


# ---------------------------------------------------------------- scans

def _scan_inputs(seed):
    rng = np.random.default_rng(seed)
    shape = (3, 1024)
    first = rng.random(shape) < 0.1
    first[:, 0] = True
    vals = rng.integers(0, 6, shape).astype(np.uint32)
    vals[1] = rng.integers(0, 1 << 32, shape[1], dtype=np.uint64)
    active = rng.random(shape) < 0.6
    return first, vals, active


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["seg_last_active_before",
                                  "seg_mtf2_before", "seg_mtf2_before_packed",
                                  "seg_sel2_before", "ctx_fill",
                                  "mru2_state_in_group"])
def test_grouping_scan_matches(name, seed):
    first, vals, active = _scan_inputs(seed)
    rng = np.random.default_rng(seed + 10)
    if name == "seg_mtf2_before_packed":
        vals = vals & 0x1FFFF
    if name == "seg_sel2_before":
        op = rng.integers(0, 3, vals.shape).astype(np.int32)
        want = jg.seg_sel2_before(jnp.asarray(first), jnp.asarray(op),
                                  jnp.asarray(vals), axis=1)
        got = pg.seg_sel2_before(_t(first), _t(op), _t(vals))
    elif name == "ctx_fill":
        h = rng.integers(0, 1 << 16, vals.shape).astype(np.int32)
        want = (jg.ctx_fill(jnp.asarray(h), jnp.asarray(active), axis=1),)
        got = (pg.ctx_fill(_t(h), _t(active)),)
    elif name == "mru2_state_in_group":
        group = rng.integers(0, 40, vals.shape).astype(np.int32)
        want = [np.stack(x) for x in zip(*[
            jg.mru2_state_in_group(jnp.asarray(group[i]),
                                   jnp.asarray(vals[i]),
                                   jnp.asarray(active[i]))
            for i in range(vals.shape[0])])]
        got = pg.mru2_state_in_group(_t(group), _t(vals), _t(active))
    else:
        want = getattr(jg, name)(jnp.asarray(first), jnp.asarray(vals),
                                 jnp.asarray(active), axis=1)
        got = getattr(pg, name)(_t(first), _t(vals), _t(active))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _eq(g, w)


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
            refs[option] = [np.asarray(x) for x in jche.plan_fast_pallas(
                jnp.asarray(quads), jnp.asarray(nbytes), interpret=True)]
        finally:
            del os.environ["DENSITY_TPU_SORT"]
    return quads, nbytes, refs


@pytest.mark.parametrize("option", ["bigsort", "bitonic"])
def test_plan_fast_matches(plan_case, option, monkeypatch):
    quads, nbytes, refs = plan_case
    monkeypatch.setenv("DENSITY_TPU_SORT", option)
    got = pche.plan_fast(_t(quads), torch.from_numpy(nbytes))
    assert len(got) == len(refs[option]) == 6
    for g, w in zip(got, refs[option]):
        _eq(g, w)
    for g, w in zip(refs["bigsort"], refs["bitonic"]):
        np.testing.assert_array_equal(g, w)


def test_classify_masked_matches(plan_case):
    """The masked classifier of the fixed point, under a copy-block mask
    (blocks 3-5 and 70 of stream 0, every third block of stream 1)."""
    quads, nbytes, _ = plan_case
    nb = N // pche.Q
    copy = np.zeros((S, nb), bool)
    copy[0, [3, 4, 5, 70]] = True
    copy[1, ::3] = True
    real = np.arange(N)[None, :] < (nbytes[:, None] // 4)
    hashes = np.asarray(jg.hash_quads(jnp.asarray(quads)))
    got = pche.classify(_t(quads), _t(hashes), _t(real), _t(copy))
    for s in range(S):
        p = jche.classify(jnp.asarray(quads[s]), jnp.asarray(hashes[s]),
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
    blob = pcontainer.compress(data, "cheetah", 1 << 19, device="cpu")
    _, _, _, lengths, off = pcontainer.parse_header(blob)
    ends = off + np.cumsum(lengths)
    parts = [blob[e - n:e] for e, n in zip(ends, lengths)]
    assert parts == [jnative.encode("cheetah", data[:1 << 19]),
                     jnative.encode("cheetah", data[1 << 19:])]


# ---------------------------------------------------------------- decode

def _staged(streams, out_lens):
    """The port's staged decode inputs of byte strings (cheetah)."""
    woff, copyf, nb_real, _ = sharding._scan("cheetah", streams, out_lens)
    return sharding._stage(streams, out_lens, woff, copyf, nb_real, "cpu")


@pytest.fixture(scope="module")
def decode_case():
    """Stream 0 converges (alphabet quads), stream 1 is stdlib text (it
    does not at 12 rounds); their tokens, and the JAX resolve at 12 and
    at 64 rounds (interpret mode)."""
    rng = np.random.default_rng(5)
    data = [_alphabet(rng, N), _stdlib_text(4 * N)]
    streams = [jnative.encode("cheetah", d) for d in data]
    args = _staged(streams, [4 * N, 4 * N])
    jargs = [jnp.asarray(a.numpy().astype(np.uint32) if i == 0 else a.numpy())
             for i, a in enumerate(args)]
    import jax
    toks = jax.vmap(jche._extract_tokens)(*jargs)
    res = [[np.asarray(x) for x in jche._resolve_parallel_batched(
        *toks, max_rounds=rounds, interpret=True)] for rounds in (12, 64)]
    return data, args, jargs, [np.asarray(t) for t in toks], *res


def test_extract_tokens_matches(decode_case):
    _, args, _, toks, _, _ = decode_case
    got = pche.extract_tokens(*args)
    for g, w in zip(got, toks):
        _eq(g, w)


def test_extract_and_assemble_with_copy_blocks():
    """Streams with copy blocks and ragged ends: extraction and assembly
    against JAX's (XLA) on the same staged inputs."""
    import jax
    rng = np.random.default_rng(6)
    data = [_mixed(rng, 4 * N - 2), _mixed(rng, 9001), _text(rng, 3)]
    streams = [jnative.encode("cheetah", d) for d in data]
    args = _staged(streams, [len(d) for d in data])
    assert bool(args[2].any())
    jargs = [jnp.asarray(a.numpy().astype(np.uint32) if i == 0 else a.numpy())
             for i, a in enumerate(args)]
    got = pche.extract_tokens(*args)
    want = jax.vmap(jche._extract_tokens)(*jargs)
    for g, w in zip(got, want):
        _eq(g, w)
    n_q = args[1].shape[1] * pche.Q
    quads = _quads(data, n_q)
    valid = np.asarray(want[3])
    out = pche.assemble(_t(quads), got[3], *args)
    ref = jax.vmap(jche._assemble)(jnp.asarray(quads), jnp.asarray(valid),
                                   *jargs)
    _eq(out, ref)


def test_resolve_matches_at_12_rounds(decode_case):
    data, args, _, toks, (quads, ok), _ = decode_case
    got_q, got_ok, rounds = pche.resolve(*[_t(t) for t in toks],
                                         max_rounds=12)
    np.testing.assert_array_equal(got_ok.numpy(), ok)
    assert ok[0] and rounds == (12 if not ok.all() else rounds)
    valid = toks[3]
    for s in np.flatnonzero(ok):
        _eq(got_q[s], quads[s])
        # copy blocks hold no tokens: their quads come from assembly
        np.testing.assert_array_equal(
            got_q[s].numpy().view(np.uint32)[valid[s]],
            np.frombuffer(data[s], np.uint32)[valid[s]])


def test_resolve_converges_at_raised_rounds(decode_case):
    """Stdlib text (which needs more than 12 rounds here) converges with
    more; the quads are JAX's and the input's."""
    data, _, _, toks, _, (quads, ok) = decode_case
    got_q, got_ok, rounds = pche.resolve(*[_t(t) for t in toks],
                                         max_rounds=64)
    assert ok.all() and got_ok.all() and rounds < 64
    _eq(got_q, quads)
    valid = toks[3]
    np.testing.assert_array_equal(got_q.numpy().view(np.uint32)[valid],
                                  _quads(data)[valid])


def test_assemble_matches(decode_case):
    import jax
    _, args, jargs, toks, (quads, _), _ = decode_case
    got = pche.assemble(_t(quads), _t(toks[3]), *args)
    want = jax.vmap(jche._assemble)(jnp.asarray(quads), jnp.asarray(toks[3]),
                                    *jargs)
    _eq(got, want)
