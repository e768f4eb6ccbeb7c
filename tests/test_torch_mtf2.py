"""The MTF-2 dictionary depths of the copy-free planners on the CPU.

`engine/mtf.py::mtf2_depths_sorted` gives each valid element its depth
in the 2-deep move-to-front list of its segment (`kernels/mtf.py`, K=2;
one launch of `csrc/mtf.cu` on the card). Cheetah's and lion's planners
read their two dictionary flags from it: depth 0 is a hit on the front
(chunk_a), depth 1 a hit on the second (chunk_b). Here the CPU path is
held to the JAX package's MTF-2 scans (`seg_mtf2_before` and its packed
form: the flags `v == front` and `v != front and v == second` on active
positions) and to the plain K-slot scan at K=2 (`depths_plain`). Every
comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from density_tpu.engine import grouping as jg
from density_tpu_torch.engine import mtf as pmtf
from density_tpu_torch.kernels import mtf as kmtf
from tests.test_torch_cheetah import _t

torch.set_num_threads(1)

KINDS = ["alphabet", "dense_starts", "zeros", "narrow", "wide"]


def _inputs(kind, seed):
    """(first, values, active) of three rows of 1024: "alphabet" (values
    0-5), "dense_starts" (half the positions start a segment), "zeros"
    (values 0-2, most of them 0, met at every count of the list),
    "narrow" (an alphabet of 17-bit values, 0 and 0x1FFFF among them) and
    "wide" (an alphabet over all 32 bits, 0 among them)."""
    rng = np.random.default_rng(seed)
    shape = (3, 1024)
    first = rng.random(shape) < (0.5 if kind == "dense_starts" else 0.1)
    first[:, 0] = True
    active = rng.random(shape) < 0.6
    if kind in ("alphabet", "dense_starts"):
        vals = rng.integers(0, 6, shape).astype(np.uint32)
    elif kind == "zeros":
        vals = np.where(rng.random(shape) < 0.6, 0,
                        rng.integers(1, 3, shape)).astype(np.uint32)
    else:
        top = 1 << 17 if kind == "narrow" else 1 << 32
        alphabet = rng.integers(0, top, 40, dtype=np.uint64)
        alphabet[:2] = (0, top - 1)
        vals = alphabet[rng.integers(0, 40, shape)].astype(np.uint32)
    return first, vals, active


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_mtf2_depths_give_the_jax_dictionary_flags(kind, seed):
    first, vals, active = _inputs(kind, seed)
    depth = pmtf.mtf2_depths_sorted(_t(first), _t(vals), _t(active)).numpy()
    scans = [jg.seg_mtf2_before]
    if kind != "wide":
        scans.append(jg.seg_mtf2_before_packed)
    for scan in scans:
        front, second = (np.asarray(x).astype(np.uint32) for x in scan(
            jnp.asarray(first), jnp.asarray(vals), jnp.asarray(active),
            axis=1))
        a = vals == front
        b = ~a & (vals == second)
        np.testing.assert_array_equal((depth == 0)[active], a[active])
        np.testing.assert_array_equal((depth == 1)[active], b[active])
    assert (depth[~active] == 2).all()
    assert (depth[active] == 0).any() and (depth[active] == 1).any()
    assert (depth[active] == 2).any()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_mtf2_depths_match_the_plain_k_slot_scan(kind, seed):
    first, vals, active = (_t(x) for x in _inputs(kind, seed))
    got = pmtf.mtf2_depths_sorted(first, vals, active)
    want = kmtf.depths_plain(first, vals, active, 2)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_mtf2_zero_values_by_count():
    """A value of 0 not in the list takes the live count while the list
    is not full (the zero-initialised chunk_a and chunk_b), and misses in
    a full one."""
    segs = [[0], [7, 0], [7, 8, 0], [0, 0], [7, 0, 7], [7, 8, 7, 0, 8]]
    want = [[0], [2, 1], [2, 2, 2], [0, 0], [2, 1, 1], [2, 2, 1, 2, 2]]
    vals = torch.tensor([v for s in segs for v in s], dtype=torch.int32)
    first = torch.tensor([i == 0 for s in segs for i in range(len(s))])
    valid = torch.ones_like(first)
    got = pmtf.mtf2_depths_sorted(first[None], vals[None], valid[None])
    assert got[0].tolist() == [d for w in want for d in w]
    assert torch.equal(got, kmtf.depths_plain(first[None], vals[None],
                                              valid[None], 2))


@pytest.mark.parametrize("K", [1, 3, 4, 6])
def test_depths_take_k_2_and_5_only(K):
    first, vals, active = (_t(x) for x in _inputs("alphabet", 0))
    with pytest.raises(ValueError):
        kmtf.depths(first, vals, active, K)
