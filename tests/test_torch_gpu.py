"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one.

Run them on a machine with a card (it has no JAX, so the repo's
conftest, which imports JAX, is left out):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest \
        -o addopts="" -p no:cacheprovider -q

Inputs are made from a numpy seed; every comparison is exact.
"""

import threading

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


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("codec", ["chameleon", "cheetah", "lion"])
def test_concurrent_shares_on_card_repeat_one_device_containers(
        cuda, codec, k, monkeypatch):
    """k shares on one card, run at once (a worker thread and a CUDA
    stream each), compressed and decompressed 5 times on the device
    route: every container equal to one device's, every round trip
    exact."""
    from density_tpu_torch.parallel import sharding
    data = _data(25, 9 * 65536 + 999)
    one = container.compress(data, codec, 65536, device=cuda)
    monkeypatch.setattr(sharding, "PREDICTED_DEVICE_CUTOFF", 1.0)
    for _ in range(5):
        blob = container.compress(data, codec, 65536, device=[cuda] * k)
        assert blob == one
        assert container.decompress(blob, device=[cuda] * k) == data


def test_packroute_from_two_threads_on_two_streams(cuda):
    """Two threads, each on a CUDA stream of its own, launch packroute 50
    times each at once (rows of 2^18 quads, whose clusters trade totals
    through the words tagged with each call's epoch): every result equals
    the plain version's."""
    kw = dict(q=64, sig_words=4, block=256, flag_bits=1)
    N, S = 1 << 18, 8
    inputs = []
    for seed in (31, 32):
        rng = np.random.default_rng(seed)
        nbytes = rng.integers(1, 4 * N + 1, S).astype(np.int32)
        args = [x.to(cuda) for x in _geometry_tokens(rng, S, N, 64, 1,
                                                     nbytes)]
        args.append(torch.from_numpy(nbytes).to(cuda))
        inputs.append((args, packroute.pack_plain(*args, **kw)))
    torch.cuda.synchronize()
    start = threading.Barrier(2, timeout=60)
    errors = []

    def run(args, want):
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda)):
                start.wait()
                for call in range(50):
                    if not torch.equal(packroute.pack(*args, **kw), want):
                        errors.append(f"call {call} differs")
        except Exception as e:  # noqa: BLE001 - reported by the assert
            errors.append(repr(e))
    threads = [threading.Thread(target=run, args=a) for a in inputs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


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


def test_a_span_encloses_its_kernels_on_the_profilers_clock(cuda):
    """A `density.*` span around a kernel's launches and a synchronise
    encloses the kernels' device events in the same profiler trace: the
    port's spans and the card's events share one clock. While a session
    records, the share workers' spans reach it too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from density_tpu_torch import tracing
    rng = np.random.default_rng(9)
    arrs = [a.to(cuda) for a in _sort_inputs(rng, 38, 65536, 1, 2, False)]
    bigsort.sort(*arrs, n_keys=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with tracing.span("engine.plan"):
            bigsort.sort(*arrs, n_keys=1)
            torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    (span,) = [e for e in events if e.device_type() == DeviceType.CPU
               and e.name() == "density.engine.plan"]
    lo, hi = span.start_ns(), span.start_ns() + span.duration_ns()
    kernels = [e for e in events if e.device_type() != DeviceType.CPU
               and not e.is_user_annotation()
               and any(k in e.name() for k in ("tile_kernel",
                                                 "global_kernel"))]
    assert kernels
    for k in kernels:
        assert lo <= k.start_ns() and k.start_ns() + k.duration_ns() <= hi
    data = _data(10, 3 * 65536 + 11)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        blob = container.compress(data, "chameleon", 65536,
                                  device=[cuda, cuda])
    assert blob == container.compress(data, "chameleon", 65536, device=cuda)
    shares = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU
              and e.name() == "density.sharding.share"]
    assert len(shares) == 3  # two shares and the tail's batch


# ------------------------------------------- MTF-5 and MTF-2 scans (mtf.cu)

MTF_KINDS = ["plan", "dictionary", "one_segment", "each_alone", "zeros",
             "invalid_runs", "boundaries"]


def _dictionary_inputs(cuda, S, n, seed):
    """(first, values, active) of cheetah's copy-free plan of `_data` on
    the card, as it hands them to its MTF-2 scan: 17-bit in-group
    fingerprints up to 65536 quads a row, whole fingerprints (the 2-key
    branch) above."""
    from density_tpu_torch.codecs import cheetah
    quads = torch.from_numpy(np.frombuffer(
        _data(seed, S * n * 4), np.int32).reshape(S, n).copy())
    nbytes = torch.full((S,), n * 4 - 4 * (n // 4), dtype=torch.int32)
    seen, scan = [], cheetah.mtf2_depths_sorted
    cheetah.mtf2_depths_sorted = lambda *a: seen.append(a) or scan(*a)
    try:
        cheetah.plan_fast(quads.to(cuda), nbytes.to(cuda))
    finally:
        cheetah.mtf2_depths_sorted = scan
    (ops,) = seen
    return ops


def _mtf_inputs(kind, S, n, seed):
    """(first, values, valid) of one kind on the CPU. "plan": lion's own
    planner input, the quads of `_data` sorted by context (the hash of the
    quad before, ties by index) with their fingerprints, a quarter of the
    tail invalid as past a stream's end; "boundaries": segments starting
    on, and one before, every run of a thread (16 elements), warp (512)
    and block (4096) of the kernel's tiles."""
    from density_tpu_torch.engine.grouping import (
        hash_quads, shift_right, sig32)
    rng = np.random.default_rng(seed)
    if kind == "plan":
        buf = np.frombuffer(_data(seed, S * n * 4), np.int32).reshape(S, n)
        quads = torch.from_numpy(buf.copy())
        ctx = shift_right(hash_quads(quads), 0).to(torch.int64)
        idx = torch.arange(n)
        key = (ctx << 32) | idx
        order = torch.sort(key, dim=-1).indices
        c_s = torch.gather(ctx, -1, order)
        first = c_s != shift_right(c_s, -1)
        vals = torch.gather(sig32(quads), -1, order)
        valid = torch.gather(idx.expand(S, n), -1, order) < n - n // 4
        return first, vals, valid
    first = rng.random((S, n)) < 0.05
    vals = rng.integers(-3, 4, (S, n)).astype(np.int32)
    valid = rng.random((S, n)) < 0.9
    if kind == "one_segment":
        first[:] = False
        first[:, 0] = True
    elif kind == "each_alone":
        first[:] = True
    elif kind == "zeros":
        vals[:] = 0
        first = rng.random((S, n)) < 0.001
    elif kind == "invalid_runs":
        valid = np.broadcast_to(np.arange(n) // 37 % 3 != 0, (S, n)).copy()
        valid &= rng.random((S, n)) < 0.95
        first = rng.random((S, n)) < 0.002
    elif kind == "boundaries":
        first[:] = False
        for step in (16, 512, 4096):
            first[:, step::step] = True
            first[:, step - 1::step] = True
    return tuple(torch.from_numpy(x) for x in (first, vals, valid))


@pytest.mark.parametrize("K", [5, 2])
@pytest.mark.parametrize("kind", MTF_KINDS)
@pytest.mark.parametrize("S,n", [(38, 4096), (1, 4096), (38, 65536),
                                 (1, 65536), (1, 1 << 22)])
def test_mtf_matches_plain(cuda, S, n, kind, K):
    """The kernel equals the plain doubling scan bit for bit at both K,
    in rows of one tile and of many tiles (whose look-back carries the
    list); at K=2 also the planners' MTF-2 op chain."""
    from density_tpu_torch.kernels import mtf
    if kind == "dictionary":
        first, vals, valid = _dictionary_inputs(cuda, S, n, n + S)
    else:
        first, vals, valid = (x.to(cuda)
                              for x in _mtf_inputs(kind, S, n, n + S))
    got = mtf.depths(first, vals, valid, K)
    torch.cuda.synchronize()
    want = mtf.depths_plain(first, vals, valid, K)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert bool((want < K).any())
    if K == 2:
        assert torch.equal(got, mtf.mtf2_plain(first, vals, valid))


def test_mtf_depths_in_group_on_card(cuda):
    """`mtf_depths_in_group` on the card (the masked plan's route to the
    kernel) equals the CPU's plain version."""
    from density_tpu_torch.engine.mtf import mtf_depths_in_group
    rng = np.random.default_rng(21)
    group = torch.from_numpy(rng.integers(0, 3000, (38, 65536))
                             .astype(np.int32))
    _, vals, valid = _mtf_inputs("invalid_runs", 38, 65536, 22)
    got = mtf_depths_in_group(group.to(cuda), vals.to(cuda), valid.to(cuda),
                              5)
    assert torch.equal(got.cpu(), mtf_depths_in_group(group, vals, valid, 5))


def test_mtf_one_launch_a_scan(cuda):
    """A scan is one launch of the wrapper's count and one kernel event in
    the profiler's trace, and no other kernel runs (the memset of the
    look-back words is no kernel); lion's copy-free plan scans twice:
    its queue at K=5 and its dictionaries at K=2."""
    from density_tpu_torch.codecs import lion
    from density_tpu_torch.engine.mtf import mtf_depths_sorted
    from density_tpu_torch.kernels import mtf
    first, vals, valid = (x.to(cuda) for x in _mtf_inputs("plan", 38, 65536,
                                                         23))
    before = mtf.launches
    mtf_depths_sorted(first, vals, valid, 5)
    assert mtf.launches == before + 1
    fn = lambda: mtf_depths_sorted(first, vals, valid, 5)  # noqa: E731
    assert _traced_launches(fn, names=("mtf_kernel",)) == 3
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    kernels = set()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels |= {e.key for e in prof.key_averages()
                    if e.device_type != DeviceType.CPU
                    and not e.key.startswith(("Memset", "Memcpy"))}
    assert kernels and all("mtf_kernel" in k for k in kernels), kernels
    quads = torch.from_numpy(np.frombuffer(
        _data(24, 4 * 65536 * 4), np.int32).reshape(4, 65536).copy())
    nbytes = torch.full((4,), 4 * 65536, dtype=torch.int32)
    before = mtf.launches, dict(mtf.launches_k)
    lion.plan_fast(quads.to(cuda), nbytes.to(cuda))
    # the prediction queue at K=5 and the dictionaries at K=2
    assert mtf.launches == before[0] + 2
    assert mtf.launches_k == {2: before[1][2] + 1, 5: before[1][5] + 1}


def test_mtf2_one_launch_a_scan(cuda):
    """At K=2 a scan is one launch, counted under K=2, and one kernel
    event in the profiler's trace; cheetah's copy-free plan scans its
    dictionaries once, at K=2 alone."""
    from density_tpu_torch.codecs import cheetah
    from density_tpu_torch.engine.mtf import mtf2_depths_sorted
    from density_tpu_torch.kernels import mtf
    first, vals, valid = _dictionary_inputs(cuda, 38, 65536, 26)
    before = mtf.launches, dict(mtf.launches_k)
    mtf2_depths_sorted(first, vals, valid)
    assert mtf.launches == before[0] + 1
    assert mtf.launches_k == {2: before[1][2] + 1, 5: before[1][5]}
    fn = lambda: mtf2_depths_sorted(first, vals, valid)  # noqa: E731
    assert _traced_launches(fn, names=("mtf_kernel",)) == 3
    quads = torch.from_numpy(np.frombuffer(
        _data(27, 4 * 65536 * 4), np.int32).reshape(4, 65536).copy())
    nbytes = torch.full((4,), 4 * 65536, dtype=torch.int32)
    before = dict(mtf.launches_k)
    cheetah.plan_fast(quads.to(cuda), nbytes.to(cuda))
    assert mtf.launches_k == {2: before[2] + 1, 5: before[5]}


@pytest.mark.parametrize("codec", ["cheetah", "lion"])
def test_plan_fast_on_card_equals_cpu(cuda, codec):
    """Cheetah's and lion's copy-free plans of 38 streams of 65536 quads
    (the bulk cells' batch), with their scans on the card, equal the
    CPU's."""
    import importlib
    mod = importlib.import_module(f"density_tpu_torch.codecs.{codec}")
    quads = torch.from_numpy(np.frombuffer(
        _data(28, 38 * 65536 * 4), np.int32).reshape(38, 65536).copy())
    nbytes = torch.full((38,), 4 * 65536, dtype=torch.int32)
    nbytes[-1] = 4 * 40000 + 3
    got = mod.plan_fast(quads.to(cuda), nbytes.to(cuda))
    want = mod.plan_fast(quads, nbytes)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_mtf_rejects_what_it_does_not_take(cuda):
    """On the card the wrapper raises on what the kernel does not take,
    and never falls back to the plain version."""
    from density_tpu_torch.kernels import mtf
    first, vals, valid = (x.to(cuda) for x in _mtf_inputs("plan", 2, 8192,
                                                         25))
    before = mtf.launches, dict(mtf.launches_k)
    for args in ((first, vals, valid, 4), (first, vals, valid, 3),
                 (first, vals.long(), valid, 5),
                 (first.int(), vals, valid, 5),
                 (first, vals, valid[:, :4096], 5),
                 (first[:, ::2], vals[:, ::2], valid[:, ::2], 5),
                 (first, vals.cpu(), valid, 5)):
        with pytest.raises(ValueError):
            mtf.depths(*args)
    assert (mtf.launches, mtf.launches_k) == before
    empty = mtf.depths(first[:0], vals[:0], valid[:0], 5)
    assert empty.shape == (0, 8192)
    assert (mtf.launches, mtf.launches_k) == before


# ------------------------------------------- protection FSM step (fsm.cu)

FSM_KINDS = ["sparse", "half", "dense", "ones", "zeros", "alternating",
             "runs"]
# (S, nb, block): lion's, cheetah's and chameleon's bulk batches, lion's
# tail, the objects cell's record, and a batch of more streams than the
# kernel's 32 warps
FSM_SHAPES = [(38, 4096, 64), (38, 2048, 128), (38, 1024, 256),
              (1, 4096, 64), (1, 512, 256), (40, 1024, 128)]


def _fsm_inputs(kind, S, nb, block, seed):
    """(bits, nbytes) of one kind on the CPU: seeded random bits at three
    densities, all ones, all zeros, alternating, or runs of ones 2-60
    blocks long (they arm penalties that raise copy_penalty_start above
    2 and span the 16-tick halvings) between runs of zeros. nbytes is
    ragged: stream 0 ends 37 bytes into its last block, the last stream
    of several is full, the others end anywhere."""
    rng = np.random.default_rng(seed)
    if kind in ("sparse", "half", "dense"):
        p = {"sparse": 0.1, "half": 0.5, "dense": 0.9}[kind]
        bits = rng.random((S, nb)) < p
    elif kind == "ones":
        bits = np.ones((S, nb), bool)
    elif kind == "zeros":
        bits = np.zeros((S, nb), bool)
    elif kind == "alternating":
        bits = np.broadcast_to(np.arange(nb) % 2 == 0, (S, nb)).copy()
    else:
        bits = np.zeros((S, nb), bool)
        for s in range(S):
            at = int(rng.integers(0, 8))
            while at < nb:
                n = int(rng.integers(2, 61))
                bits[s, at:at + n] = True
                at += n + int(rng.integers(1, 40))
    nbytes = rng.integers(1, nb * block + 1, S)
    nbytes[0] = (nb - 3) * block + 37
    if S > 1:
        nbytes[-1] = nb * block
    return (torch.from_numpy(bits),
            torch.from_numpy(nbytes.astype(np.int32)))


def _stdlib_text(n: int) -> bytes:
    """Python source text of this machine's stdlib, in sorted order."""
    import os
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


def _multipass(seed=5):
    """Random bytes, then text: a stream whose copy-block fixed point
    takes three or more passes in each codec."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
            + _stdlib_text(12288))


def _encode_counted(codec, data, dev):
    """`layout.run_encode` of `data` as one stream on `dev`: (out, totals,
    converged) on the host and the passes of its fixed point."""
    from density_tpu_torch.engine import layout
    from density_tpu_torch.parallel import sharding
    pipe = sharding.codec_module(codec).PIPELINE
    n = len(data)
    padded = np.zeros((1, layout.bucket_bytes(n, pipe.BLOCK)), np.uint8)
    padded[0, :n] = np.frombuffer(data, np.uint8)
    passes = []
    step = layout.step_fsm
    layout.step_fsm = lambda *a: passes.append(1) or step(*a)
    try:
        out, totals, converged = layout.run_encode(
            pipe, layout.stage_quads(padded, dev),
            torch.tensor([n], dtype=torch.int32, device=dev))
    finally:
        layout.step_fsm = step
    return (out.cpu(), totals.cpu(), converged), len(passes)


@pytest.mark.parametrize("kind", FSM_KINDS)
@pytest.mark.parametrize("S,nb,block", FSM_SHAPES)
def test_fsm_matches_plain(cuda, S, nb, block, kind):
    """The kernel equals the plain replay bit for bit, in the copy set and
    in both flags, against a copy set of zeros, against the plain result
    (nothing changed) and against it with one real block flipped; blocks
    past ceil(nbytes / block) come out 0."""
    from density_tpu_torch.kernels import fsm
    bits, nbytes = _fsm_inputs(kind, S, nb, block, S * nb + len(kind))
    zeros = torch.zeros_like(bits)
    want, want_flags = fsm.step_plain(bits, nbytes, block, zeros)
    flipped = want.clone()
    flipped[0, 0] = ~flipped[0, 0]
    for prev in (zeros, want, flipped):
        got, flags = fsm.step(bits.to(cuda), nbytes.to(cuda), block,
                              prev.to(cuda))
        torch.cuda.synchronize()
        assert got.dtype == torch.bool and torch.equal(got.cpu(), want)
        changed = not torch.equal(prev, want)
        assert flags.cpu().tolist() == [int(changed), int(want.any())]
    assert want_flags.tolist() == [int(bool(want.any())), int(want.any())]
    real = torch.arange(nb) < ((nbytes.long() + block - 1) // block)[:, None]
    assert not bool((want & ~real).any())


# Three profiler sessions of three steps and a small kernel after them,
# in a process of its own: late in a long process the profiler drops
# device events (seen on the H100), and a fresh one records them all.
FSM_TRACE = """
import json
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from density_tpu_torch.kernels import fsm
rng = np.random.default_rng(7)
bits = torch.from_numpy(rng.random((38, 4096)) < 0.5).cuda()
nbytes = torch.full((38,), 4096 * 64, dtype=torch.int32, device="cuda")
prev = torch.zeros_like(bits)
fsm.step(bits, nbytes, 64, prev)
tail = torch.zeros(1, device="cuda")
torch.cuda.synchronize()
counts = []
for _ in range(3):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fsm.step(bits, nbytes, 64, prev)
        tail.add_(1)
        torch.cuda.synchronize()
    work = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    steps = sum(e.count for e in work if "fsm_kernel" in e.key)
    counts.append([steps, sum(e.count for e in work) - steps])
print(json.dumps(counts))
"""


def test_fsm_one_launch_a_pass(cuda):
    """A step is one launch of the wrapper's count and makes no host sync;
    in the profiler's trace it is one kernel event, and no other kernel,
    copy or memset runs (three steps and the small kernel after them are
    four device events; a session may drop events but never adds one)."""
    import json
    import pathlib
    import subprocess
    import sys
    from density_tpu_torch.kernels import fsm
    bits, nbytes = (x.to(cuda) for x in _fsm_inputs("half", 38, 4096, 64, 7))
    prev = torch.zeros_like(bits)
    before = fsm.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        fsm.step(bits, nbytes, 64, prev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fsm.launches == before + 1
    out = subprocess.run([sys.executable, "-c", FSM_TRACE], check=True,
                         cwd=pathlib.Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=300)
    counts = json.loads(out.stdout.strip().splitlines()[-1])
    assert [3, 1] in counts, counts
    assert all(s <= 3 and o <= 1 for s, o in counts), counts


@pytest.mark.parametrize("codec", ["chameleon", "cheetah", "lion"])
def test_run_encode_on_card_equals_cpu(cuda, codec):
    """`run_encode`'s (out, totals, converged) on the card equal the CPU
    path's on a stream of three or more passes, one FSM launch a pass."""
    from density_tpu_torch.kernels import fsm
    data = _multipass()
    want, cpu_passes = _encode_counted(codec, data, "cpu")
    before = fsm.launches
    got, passes = _encode_counted(codec, data, cuda)
    assert passes == cpu_passes >= 3
    assert fsm.launches == before + passes
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] is want[2] is True


def test_fsm_rejects_what_it_does_not_take(cuda):
    """On the card the wrapper raises on what the kernel does not take,
    and never falls back to the plain replay."""
    from density_tpu_torch.kernels import fsm
    bits, nbytes = (x.to(cuda) for x in _fsm_inputs("half", 4, 1024, 64, 8))
    prev = torch.zeros_like(bits)
    wide = torch.zeros((4, 1024 + 16), dtype=torch.bool, device=cuda)
    before = fsm.launches
    for args in ((bits[:, :1000].contiguous(), nbytes, 64,
                  prev[:, :1000].contiguous()),
                 (wide.view(-1)[1:1 + 4 * 1024].view(4, 1024), nbytes, 64,
                  prev),
                 (bits, nbytes.long(), 64, prev),
                 (bits, nbytes, 64, prev.cpu()),
                 (bits, nbytes, 0, prev)):
        with pytest.raises(ValueError):
            fsm.step(*args)
    assert fsm.launches == before
