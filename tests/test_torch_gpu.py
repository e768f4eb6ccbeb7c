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
from density_tpu_torch.kernels import bigsort, bitonic, pack, packroute, unpack

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


def _sort_inputs(rng, S, N, n_keys, n_arr, ties):
    """Keys in -50..49 (many ties) or over all of int32; the carried
    arrays over all of int32."""
    hi = [50 if ties else 2**31] * n_keys + [2**31] * (n_arr - n_keys)
    return [torch.from_numpy(rng.integers(-h, h, (S, N), dtype=np.int64)
                             .astype(np.int32)) for h in hi]


def _check_bigsort(cuda, arrs, n_keys):
    got = bigsort.sort(*(a.to(cuda) for a in arrs), n_keys=n_keys)
    torch.cuda.synchronize()
    # the plain version on the card: the same arithmetic, faster than the
    # CPU at these sizes
    want = bigsort.sort_plain(*(a.to(cuda) for a in arrs), n_keys=n_keys)
    assert len(got) == len(arrs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# (n_arrays, n_keys): every combination the kernel takes
SORT_KINDS = [(1, 1), (2, 1), (3, 1), (2, 2), (3, 2)]
# N across the schedule's boundaries: one tile with idle lanes (N = 256),
# one tile of up to 16384 elements, and tiles below a row with 2-4 merge
# stages; S rotates over 1, 311 and 622 rows (fewer where a case would
# pass 2^25 elements)
BIGSORT_CASES = [
    (min((1, 311, 622)[i % 3], (1 << 25) // N), N, nk, na)
    for i, (N, (na, nk)) in enumerate(
        (N, kind) for N in (256, 512, 1024, 4096, 8192, 16384, 32768, 65536,
                            1 << 17) for kind in SORT_KINDS)]


@pytest.mark.parametrize("S,N,n_keys,n_arr", BIGSORT_CASES)
def test_bigsort_matches_plain(cuda, S, N, n_keys, n_arr):
    rng = np.random.default_rng(N + n_arr)
    _check_bigsort(cuda, _sort_inputs(rng, S, N, n_keys, n_arr, False),
                   n_keys)


@pytest.mark.parametrize("S,N,n_keys,n_arr", [
    (311, 8192, 1, 2), (622, 4096, 2, 3), (38, 65536, 1, 2), (38, 65536, 1, 1),
    (5, 65536, 2, 3), (1, 1 << 15, 2, 2), (150, 1 << 15, 1, 3),
    (2, 1 << 17, 2, 3), (64, 1 << 17, 1, 2), (7, 2048, 1, 2), (9, 1024, 2, 2)])
def test_bigsort_ties_follow_the_network(cuda, S, N, n_keys, n_arr):
    """Keys with many ties: the carried arrays come out in the plain
    network's order only if every pair is compared in the same order.
    Rows of 2^15, 2^16 and 2^17 merge through global launches of 2-3,
    2-4 and 1-4 bits (the 5-bit stage of 2^17 takes two)."""
    rng = np.random.default_rng(S + N + n_arr)
    _check_bigsort(cuda, _sort_inputs(rng, S, N, n_keys, n_arr, True),
                   n_keys)


def test_bigsort_takes_any_layout(cuda):
    """A broadcast row, rows cut from wider ones, a non-contiguous column
    view and a contiguous view off the 16-byte alignment of the kernel's
    loads all sort as their contiguous copies."""
    rng = np.random.default_rng(3)
    S, N = 38, 65536
    wide = [a.to(cuda) for a in _sort_inputs(rng, S, 2 * N, 1, 3, True)]
    shifted = wide[2].view(-1)[1:1 + S * N].view(S, N)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    for arrs in ([wide[0][:1, :N].expand(S, N), wide[1][:, N:],
                  wide[2][:, ::2]], [wide[1][:, :N], shifted]):
        _check_bigsort(cuda, arrs, 1)
        got = bigsort.sort(*arrs, n_keys=1)
        want = bigsort.sort(*(a.contiguous() for a in arrs), n_keys=1)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("S,N,n_arr,want", [
    (311, 8192, 2, 1), (622, 4096, 1, 1), (3, 16384, 3, 1), (38, 65536, 2, 7),
    (38, 65536, 1, 7), (2, 1 << 17, 3, 10)])
def test_bigsort_launches_per_sort(cuda, S, N, n_arr, want):
    """The kernel launches of three sorts, counted by the profiler: one a
    sort while a row fits in a tile of 16384; above, the sort of its
    8192-element tiles, then for each merge stage a launch per 4 bits it
    spans above its 4096-element tiles and a tile launch."""
    rng = np.random.default_rng(N + n_arr)
    arrs = [a.to(cuda) for a in _sort_inputs(rng, S, N, 1, n_arr, True)]
    assert _traced_launches(lambda: bigsort.sort(*arrs, n_keys=1)) == 3 * want


def _traced_launches(fn, calls=3, sessions=3,
                     names=("tile_kernel", "cluster_kernel",
                            "global_kernel")):
    """The launches of the kernels named `names` in `calls` calls of
    `fn`, as the profiler's trace counts them: the most of `sessions`
    sessions, since a session now and then drops an event (seen on the
    H100) but never adds one. A small kernel after the calls, inside the
    window, keeps the calls' own kernels from being its last events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    tail = torch.zeros(1, device="cuda")
    counts = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            tail.add_(1)
            torch.cuda.synchronize()
        counts.append(sum(
            e.count for e in prof.key_averages()
            if any(name in e.key for name in names)))
    return max(counts)


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


# (N, S): rows of one cluster of 2, 4 and 8 CTAs, longer spans, and one
# stream of the default 32 MiB
PACKROUTE_SHAPES = [(16384, 12), (65536, 12), (1 << 18, 8), (1 << 23, 1)]


@pytest.mark.parametrize("q,sig_words,flag_bits", [
    (64, 4, 1), (32, 4, 2), (16, 3, 3)])
@pytest.mark.parametrize("N,S", PACKROUTE_SHAPES)
def test_packroute_geometries_match_plain(cuda, N, S, q, sig_words,
                                          flag_bits):
    """Ragged tails of 0-3 bytes, streams that end inside a block,
    padding blocks beyond them, a zero-length stream, and random tokens
    at each geometry."""
    rng = np.random.default_rng(N + q + S)
    full = 4 * N
    nbytes = np.array([full, full - 1, full - 2, full - 3, 1000, 0,
                       full // 3 + 1, 4 * q * 5, 13, full - 4 * q - 2,
                       full // 2, 2 * q + 3][:S], np.int32)
    tokens = _geometry_tokens(rng, S, N, q, flag_bits, nbytes)
    kw = dict(q=q, sig_words=sig_words, block=4 * q, flag_bits=flag_bits)
    args = [x.to(cuda) for x in tokens] + [torch.from_numpy(nbytes).to(cuda)]
    got = packroute.pack(*args, **kw)
    torch.cuda.synchronize()
    # the plain version on the card: the same arithmetic, faster than the
    # CPU at these sizes
    assert torch.equal(got, packroute.pack_plain(*args, **kw))


def test_packroute_one_launch(cuda):
    """One kernel launch per call, and no memset, in the profiler's
    trace."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(9)
    nbytes = np.full(38, 4 * 65536, np.int32)
    args = [x.to(cuda) for x in _geometry_tokens(rng, 38, 65536, 64, 1,
                                                 nbytes)]
    args.append(torch.from_numpy(nbytes).to(cuda))
    kw = dict(q=64, sig_words=4, block=256, flag_bits=1)
    fn = lambda: packroute.pack(*args, **kw)  # noqa: E731
    assert _traced_launches(fn, names=("packroute_kernel",)) == 3
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    assert not any("Memset" in e.key for e in prof.key_averages())


@pytest.mark.parametrize("S,N,n_keys,n_arr", [
    (3, 256, 1, 1), (5, 4096, 1, 2), (3, 8192, 1, 3), (4, 16384, 2, 3),
    (3, 32768, 1, 1), (40, 32768, 2, 3), (38, 65536, 1, 2), (40, 65536, 1, 1),
    (38, 65536, 2, 3), (2, 65536, 1, 2), (2, 1 << 17, 2, 2),
    (5, 1 << 17, 1, 3), (2, 1 << 18, 1, 2), (1, 1 << 18, 2, 3)])
def test_bitonic_matches_plain_and_bigsort(cuda, S, N, n_keys, n_arr):
    """Keys in -50..49 (many ties), so that the carried arrays show the
    network's order: rows of one CTA (N <= 16384), of one cluster of 4 or
    8 CTAs (S = 38 and 40 leave the last clusters for a second round on
    the card), and longer rows (cluster spans merged by global launches).
    The output also equals bigsort's."""
    rng = np.random.default_rng(N + 7 * n_arr)
    arrs = [a.to(cuda) for a in _sort_inputs(rng, S, N, n_keys, n_arr, True)]
    got = bitonic.sort(*arrs, n_keys=n_keys)
    torch.cuda.synchronize()
    # the plain version on the card: the same arithmetic, faster than the
    # CPU at these sizes
    want = bitonic.sort_plain(*arrs, n_keys=n_keys)
    big = bigsort.sort(*arrs, n_keys=n_keys)
    assert len(got) == n_arr
    for g, w, b in zip(got, want, big):
        assert torch.equal(g, w)
        assert torch.equal(g, b)


@pytest.mark.parametrize("S,N,n_arr,want", [
    (311, 8192, 2, 1), (622, 4096, 1, 1), (3, 16384, 3, 1), (40, 32768, 2, 1),
    (38, 65536, 2, 1), (38, 65536, 1, 1), (2, 1 << 17, 3, 3),
    (2, 1 << 18, 2, 5)])
def test_bitonic_launches_per_sort(cuda, S, N, n_arr, want):
    """The kernel launches of three sorts, counted by the profiler: one a
    sort while a row has at most 65536 elements (one CTA, or one cluster
    per row); above, the sort of its 65536-element spans, then for each
    merge stage a global launch and a cluster launch."""
    rng = np.random.default_rng(N + n_arr)
    arrs = [a.to(cuda) for a in _sort_inputs(rng, S, N, 1, n_arr, True)]
    assert _traced_launches(lambda: bitonic.sort(*arrs, n_keys=1)) == 3 * want


def _geometry_tokens(rng, S, N, q, flag_bits, nbytes):
    """Seeded flags with their payload words (zero past nbytes // 4) and
    random w0/w1, as a cheetah (2-bit) or lion (3-bit) plan has them."""
    real = np.arange(N)[None, :] < (nbytes[:, None] // 4)
    flags = np.where(real, rng.integers(0, 1 << flag_bits, (S, N)), 0)
    pw = unpack.flag_payload_words(torch.from_numpy(flags), flag_bits).numpy()
    pw = np.where(real, pw, 0)
    w0, w1 = (rng.integers(0, 1 << 16, (S, N)) for _ in range(2))
    return [torch.from_numpy(x.astype(np.int32)) for x in (flags, pw, w0, w1)]


@pytest.mark.parametrize("N,q,sig_words,flag_bits", [
    (4096, 64, 4, 1), (8192, 64, 4, 1), (65536, 64, 4, 1),
    (8192, 32, 4, 2), (4096, 16, 3, 3)])
def test_small_stream_pack_matches_plain(cuda, N, q, sig_words, flag_bits):
    """Tails of 0, 1, 3 and 555 bytes, a stream shorter than one tile
    and an empty one."""
    rng = np.random.default_rng(N + q)
    full = 4 * N
    nbytes = np.array([full, full - 1, full - 3, full - 555, 1000, 0],
                      np.int32)
    tokens = _geometry_tokens(rng, len(nbytes), N, q, flag_bits, nbytes)
    kw = dict(q=q, sig_words=sig_words, block=4 * q, flag_bits=flag_bits)
    tn = torch.from_numpy(nbytes)
    got = pack.pack(*(x.to(cuda) for x in tokens), tn.to(cuda), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), pack.pack_plain(*tokens, tn, **kw))


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


def _geometry_blocks(rng, S, NB, q, sig_words):
    """Random words with back-to-back block offsets (each block a random
    length up to its largest), a tenth of the blocks copy blocks, a
    tenth dead, and the last block of each stream running past W (its
    reads past the words give 0)."""
    span = sig_words + 2 * q
    lens = rng.integers(sig_words, span + 1, (S, NB))
    woff = (np.cumsum(lens, axis=1) - lens).astype(np.int32)
    is_copy = rng.random((S, NB)) < 0.1
    woff[rng.random((S, NB)) < 0.1] = -1
    W = int(woff.max()) + sig_words + 5
    words = rng.integers(0, 1 << 16, (S, W)).astype(np.int32)
    words |= rng.integers(0, 2, (S, W)).astype(np.int32) << 20  # high junk
    return (torch.from_numpy(words), torch.from_numpy(woff),
            torch.from_numpy(is_copy))


@pytest.mark.parametrize("q,sig_words,flag_bits,NB", [
    (64, 4, 1, 1024), (64, 4, 1, 24), (32, 4, 2, 512), (16, 3, 3, 1024),
    (16, 3, 3, 70)])
def test_unpack_geometries_match_plain(cuda, q, sig_words, flag_bits, NB):
    """flag_bits 1-3 with copy, dead and ragged blocks and tiles cut by
    NB; then a malformed block, whose outputs are zeros beside the flag
    in `unpack_flagged` and which `unpack` raises."""
    rng = np.random.default_rng(q * NB + flag_bits)
    words, woff, is_copy = _geometry_blocks(rng, 5, NB, q, sig_words)
    kw = dict(q=q, sig_words=sig_words, flag_bits=flag_bits)
    args = [x.to(cuda) for x in (words, woff, is_copy)]
    got = unpack.unpack(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, unpack.unpack_plain(words, woff, is_copy, **kw)):
        assert torch.equal(g.cpu(), w)
    woff[2, NB // 2] = words.shape[1] - sig_words + 1
    is_copy[2, NB // 2] = False
    args = [x.to(cuda) for x in (words, woff, is_copy)]
    *got, bad = unpack.unpack_flagged(*args, **kw)
    *want, wbad = unpack._plain(words, woff, is_copy, q, sig_words,
                                flag_bits)
    assert int(bad.cpu()[0]) == 1 and int(wbad[0]) == 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    with pytest.raises(DecodeError):
        unpack.unpack(*args, **kw)


def test_unpack_one_launch(cuda):
    """One kernel launch per call in the profiler's trace."""
    rng = np.random.default_rng(8)
    args = [x.to(cuda) for x in _geometry_blocks(rng, 38, 1024, 64, 4)]
    assert _traced_launches(lambda: unpack.unpack_flagged(*args, **CHAM),
                            names=("unpack_kernel",)) == 3


def test_malformed_raises_in_finish_without_a_host_sync(cuda, monkeypatch):
    """A malformed block offset (the scan is rewritten: no valid stream
    makes one) raises DecodeError through `sharding.decompress`, from
    the flag read with the words in `_finish`; the device decode before
    it makes no host sync (CUDA's sync debug mode would raise)."""
    from density_tpu_torch import native
    from density_tpu_torch.parallel import sharding
    blob = container.compress(_data(6, 3 * 65536 + 11), "chameleon", 65536,
                              device=cuda)
    scan = native.scan_many

    def bad_scan(codec, streams, max_blocks):
        bio, *rest = scan(codec, streams, max_blocks)
        bio[1, 3] = 2 * (max(len(s) for s in streams) + 100)
        return (bio, *rest)

    decode = sharding.decode_batch

    def no_sync_decode(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return decode(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(sharding, "decode_batch", no_sync_decode)
    assert container.decompress(blob, device=cuda) == _data(6, 3 * 65536 + 11)
    monkeypatch.setattr(native, "scan_many", bad_scan)
    with pytest.raises(DecodeError, match="malformed"):
        container.decompress(blob, device=cuda)


def test_unpack_at_4096_quads(cuda):
    """NB * 64 = 4096, the smallest decode capacity: the kernel has no
    16384-quad grouping and serves it as it is."""
    from density_tpu_torch.parallel import sharding
    blob = container.compress(_data(9, 3 * 16384 + 1598), "chameleon", 16384,
                              device="cpu")
    (words, woff, is_copy, nb_real, _), _, _ = sharding.decode_prep(
        blob, device="cpu")
    assert woff.shape[1] * 64 == 4096
    live = torch.arange(woff.shape[1])[None, :] < nb_real[:, None]
    woff = torch.where(live, woff, -1)
    got = unpack.unpack(words.to(cuda), woff.to(cuda), is_copy.to(cuda),
                        **CHAM)
    torch.cuda.synchronize()
    for g, w in zip(got, unpack.unpack_plain(words, woff, is_copy, **CHAM)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n,stream", [
    (125, 65536), (65536 + 40001, 65536), (3 * 65536 + 2, 65536),
    (5 * 16384 + 1598, 16384), (3 * 32768 + 1598, 32768)])
def test_container_on_card_equals_cpu(cuda, n, stream):
    data = _data(n, n)
    before = pack.launches
    blob = container.compress(data, "chameleon", stream, device=cuda)
    assert blob == container.compress(data, "chameleon", stream,
                                      device="cpu")
    assert container.decompress(blob, device=cuda) == data
    if stream < 65536:
        assert pack.launches > before


@pytest.mark.parametrize("stream,n", [
    (1 << 20, 2 * (1 << 20) + 12345), (32 << 20, 17 * (1 << 20) + 3)])
def test_large_stream_containers_on_card(cuda, stream, n):
    """Streams of 2^18 quads (1 MiB) and the default 32 MiB stream (a
    17 MiB input: one stream of 2^23 quads): the round trip on the card,
    and a 2 MiB prefix byte-equal to the CPU path (which keeps the CPU
    side at 2^19 quads)."""
    data = _data(n, n)
    before = packroute.launches
    blob = container.compress(data, "chameleon", stream, device=cuda)
    assert packroute.launches > before
    assert container.decompress(blob, device=cuda) == data
    prefix = data[:2 << 20]
    assert container.compress(prefix, "chameleon", stream, device=cuda) == (
        container.compress(prefix, "chameleon", stream, device="cpu"))


def test_options_on_card_give_default_containers(cuda, monkeypatch):
    """DENSITY_TPU_SORT=bitonic and pack mode "onehot" change the kernels,
    not the bytes."""
    from density_tpu_torch.engine import layout
    data = _data(11, 2 * 65536 + 3 * 32768 + 77)
    want = {st: container.compress(data, "chameleon", st, device=cuda)
            for st in (65536, 32768)}
    monkeypatch.setenv("DENSITY_TPU_SORT", "bitonic")
    before = bitonic.launches
    for st, blob in want.items():
        assert container.compress(data, "chameleon", st, device=cuda) == blob
    assert bitonic.launches > before
    monkeypatch.delenv("DENSITY_TPU_SORT")
    monkeypatch.setattr(layout, "PACK_MODE", "onehot")
    before = (pack.launches, packroute.launches)
    assert container.compress(data, "chameleon", 65536, device=cuda) == (
        want[65536])
    assert pack.launches > before[0] and packroute.launches == before[1]


@pytest.mark.parametrize("n", [0, 1, 255, 1000, 16384, 32771])
def test_encode_raw_on_card(cuda, n):
    from density_tpu_torch import api
    data = _data(n + 1, n)
    enc = api.encode_raw(data, device=cuda)
    assert enc == api.encode_raw(data, backend="scalar")
    assert api.decode_raw(enc, device=cuda) == data


# ------------------------------------------------------------- cheetah

def _cheetah_parts(blob):
    _, _, _, lengths, off = container.parse_header(blob)
    ends = off + np.cumsum(lengths)
    return [blob[e - n:e] for e, n in zip(ends, lengths)]


@pytest.mark.parametrize("S,N", [(38, 65536), (1, 1 << 22)])
@pytest.mark.parametrize("sort", ["bigsort", "bitonic"])
def test_three_array_two_key_sorts_at_cheetah_shapes(cuda, S, N, sort):
    """The 2-key 3-array sorts of cheetah's resolve (S=38 x 65536) and
    planner (one 2^22-quad stream), on tie-heavy keys, against the plain
    network; bitonic also against bigsort."""
    mod = {"bigsort": bigsort, "bitonic": bitonic}[sort]
    arrs = [a.to(cuda) for a in _sort_inputs(np.random.default_rng(S), S, N,
                                             2, 3, True)]
    got = mod.sort(*arrs, n_keys=2)
    torch.cuda.synchronize()
    for g, w in zip(got, bigsort.sort_plain(*arrs, n_keys=2)):
        assert torch.equal(g, w)
    if sort == "bitonic":
        for g, w in zip(got, bigsort.sort(*arrs, n_keys=2)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("n,stream", [(3 * 65536 + 555, 65536),
                                      (5 * 16384 + 3, 16384),
                                      (9 * 4096 + 1, 4096)])
def test_cheetah_container_on_card(cuda, n, stream):
    """Cheetah compress on the card equals the native encoder stream for
    stream (packroute at 16384 quads, pack below); decompress on the
    card round-trips on both routes."""
    from density_tpu_torch import native
    from density_tpu_torch.parallel import sharding
    data = _data(9, n)
    blob = container.compress(data, "cheetah", stream, device=cuda)
    parts = _cheetah_parts(blob)
    assert parts == [native.encode("cheetah", data[i:i + stream])
                     for i in range(0, n, stream)]
    assert container.decompress(blob, device=cuda) == data
    assert b"".join(sharding.decode_streams(parts, None, cuda,
                                            "cheetah")) == data


def test_cheetah_device_decode_converges(cuda):
    """Quads from a 1024-value alphabet: few predictions, the device
    route, every stream converged, the input's bytes."""
    from density_tpu_torch.codecs import cheetah
    from density_tpu_torch.parallel import sharding
    rng = np.random.default_rng(10)
    vals = rng.integers(0, 1 << 32, 1024, dtype=np.uint64).astype(np.uint32)
    data = vals[rng.integers(0, 1024, 4 * 16384)].tobytes() + b"ab"
    blob = container.compress(data, "cheetah", 65536, device=cuda)
    dargs, streams, meta = sharding.decode_prep(blob, device=cuda)
    assert sharding.route("cheetah", meta[-1]) == "device"
    out, ok, rounds = cheetah.decode_batch(*dargs)
    assert bool(ok.all()) and rounds <= 12
    got = sharding._finish(out, None, ~ok, streams, *meta[2:5], "cheetah")
    assert b"".join(got) == data
    assert container.decompress(blob, device=cuda) == data


def test_cheetah_options_on_card_give_default_containers(cuda, monkeypatch):
    data = _data(11, 2 * 65536 + 7)
    want = container.compress(data, "cheetah", 65536, device=cuda)
    monkeypatch.setenv("DENSITY_TPU_SORT", "bitonic")
    assert container.compress(data, "cheetah", 65536, device=cuda) == want
    small = container.compress(data, "cheetah", 16384, device=cuda)
    monkeypatch.delenv("DENSITY_TPU_SORT")
    assert container.compress(data, "cheetah", 16384, device=cuda) == small


@pytest.mark.parametrize("n", [0, 1, 127, 128, 1000, 16384, 32771])
def test_cheetah_encode_raw_on_card(cuda, n):
    from density_tpu_torch import api
    data = _data(12, n)
    enc = api.encode_raw(data, "cheetah", device=cuda)
    assert enc == api.encode_raw(data, "cheetah", backend="native")
    assert api.decode_raw(enc, "cheetah", device=cuda) == data


# ------------------------------------------------------------------ lion

@pytest.mark.parametrize("n,stream", [(3 * 262144 + 555, 262144),
                                      (5 * 16384 + 3, 16384)])
def test_lion_container_on_card_equals_cpu(cuda, n, stream):
    """Lion compress on the card (packroute at 65536 quads, pack at
    4096) equals the CPU path and the native encoder stream for stream;
    decompress on the card round-trips on both routes."""
    from density_tpu_torch import native
    from density_tpu_torch.parallel import sharding
    data = _data(13, n)
    blob = container.compress(data, "lion", stream, device=cuda)
    assert blob == container.compress(data, "lion", stream, device="cpu")
    parts = _cheetah_parts(blob)
    assert parts == [native.encode("lion", data[i:i + stream])
                     for i in range(0, n, stream)]
    assert container.decompress(blob, device=cuda) == data
    assert b"".join(sharding.decode_streams(parts, None, cuda,
                                            "lion")) == data


def _lion_alphabet_decode_args(cuda):
    from density_tpu_torch.parallel import sharding
    rng = np.random.default_rng(14)
    vals = rng.integers(0, 1 << 32, 1024, dtype=np.uint64).astype(np.uint32)
    data = vals[rng.integers(0, 1024, 4 * 16384)].tobytes() + b"ab"
    blob = container.compress(data, "lion", 65536, device=cuda)
    dargs, streams, meta = sharding.decode_prep(blob, device=cuda)
    assert sharding.route("lion", meta[-1]) == "device"
    return data, blob, dargs, streams, meta


def test_lion_device_decode_converges(cuda):
    """Quads from a 1024-value alphabet: few predictions, the device
    route, every stream converged, the input's bytes."""
    from density_tpu_torch.codecs import lion
    from density_tpu_torch.parallel import sharding
    data, blob, dargs, streams, meta = _lion_alphabet_decode_args(cuda)
    out, ok, rounds = lion.decode_batch(*dargs)
    assert bool(ok.all()) and rounds <= 12
    got = sharding._finish(out, None, ~ok, streams, *meta[2:5], "lion")
    assert b"".join(got) == data
    assert container.decompress(blob, device=cuda) == data


def test_lion_decode_one_host_sync_a_round(cuda):
    """The device decode reads back one flag a fixpoint round after the
    first (whether any stream changed), and the last one that ends the
    loop: as many host syncs as rounds, nothing else."""
    import warnings
    from density_tpu_torch.codecs import lion
    _, _, dargs, _, _ = _lion_alphabet_decode_args(cuda)
    lion.decode_batch(*dargs)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, ok, rounds = lion.decode_batch(*dargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchronizing CUDA operation" in str(w.message)
                for w in caught)
    assert bool(ok.all()) and 1 < rounds < 12
    assert syncs == rounds


def test_lion_options_on_card_give_default_containers(cuda, monkeypatch):
    from density_tpu_torch.engine import layout
    data = _data(15, 2 * 65536 + 7)
    want = container.compress(data, "lion", 65536, device=cuda)
    monkeypatch.setenv("DENSITY_TPU_SORT", "bitonic")
    assert container.compress(data, "lion", 65536, device=cuda) == want
    small = container.compress(data, "lion", 16384, device=cuda)
    monkeypatch.delenv("DENSITY_TPU_SORT")
    assert container.compress(data, "lion", 16384, device=cuda) == small
    monkeypatch.setattr(layout, "PACK_MODE", "onehot")
    assert container.compress(data, "lion", 65536, device=cuda) == want


@pytest.mark.parametrize("n", [0, 1, 63, 64, 127, 1000, 16384, 32771])
def test_lion_encode_raw_on_card(cuda, n):
    from density_tpu_torch import api
    data = _data(16, n)
    enc = api.encode_raw(data, "lion", device=cuda)
    assert enc == api.encode_raw(data, "lion", backend="native")
    assert api.decode_raw(enc, "lion", device=cuda) == data


@pytest.mark.parametrize("codec", ["chameleon", "cheetah", "lion"])
def test_shares_on_card_give_one_device_containers(cuda, codec, monkeypatch):
    """Two shares on one card (the list names it twice): the container of
    one device, each kernel of the path launched once a share at least,
    and decompress through the shares on both routes."""
    from density_tpu_torch.parallel import sharding
    data = _data(21, 5 * 65536 + 999)
    one = container.compress(data, codec, 65536, device=cuda)
    before = bigsort.launches, packroute.launches
    two = container.compress(data, codec, 65536, device=[cuda, cuda])
    assert two == one
    assert bigsort.launches - before[0] >= 2
    assert packroute.launches - before[1] >= 2
    for cutoff in (-1.0, 1.0):  # the pool, then the device
        monkeypatch.setattr(sharding, "PREDICTED_DEVICE_CUTOFF", cutoff)
        assert container.decompress(two, device=[cuda, cuda]) == data


@pytest.mark.parametrize("codec", ["chameleon", "cheetah", "lion"])
def test_encode_stats_on_card(cuda, codec):
    """encode_stats on the card equals stream_stats of the card's stream,
    through bigsort."""
    from density_tpu_torch import api, stats
    data = _data(22, 2 * 65536 + 77)
    before = bigsort.launches
    got = stats.encode_stats(codec, data, device=cuda)
    assert bigsort.launches > before
    enc = api.encode_raw(data, codec, device=cuda)
    assert got == stats.stream_stats(codec, data, enc)
    assert got == stats.encode_stats(codec, data, device="cpu")


def test_kernels_on_a_second_card():
    """Every kernel on the second card's tensors, against its plain
    version there, and containers over every card equal to one card's:
    the per-device shared-memory attributes and occupancy, and the device
    made current for each launch."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    second = devs[1]
    rng = np.random.default_rng(23)
    for S, N, n_keys, n_arr in ((4, 16384, 2, 3), (2, 1 << 17, 1, 2)):
        arrs = [a.to(second) for a in _sort_inputs(rng, S, N, n_keys, n_arr,
                                                   True)]
        for mod in (bigsort, bitonic):
            got = mod.sort(*arrs, n_keys=n_keys)
            torch.cuda.synchronize(second)
            for g, w in zip(got, mod.sort_plain(*arrs, n_keys=n_keys)):
                assert g.device == second and torch.equal(g, w)
    data = _data(24, 9 * 65536 + 4321)
    for codec in ("chameleon", "cheetah", "lion"):
        one = container.compress(data, codec, 65536, device=devs[0])
        assert container.compress(data, codec, 65536, device=devs) == one
        assert container.compress(data[:65536], codec, 65536,
                                  device=second) == container.compress(
            data[:65536], codec, 65536, device="cpu")
        assert container.decompress(one, device=devs) == data
    blob = container.compress(data, "chameleon", 16384, device=second)
    assert container.decompress(blob, device=second) == data
