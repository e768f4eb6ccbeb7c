"""Segmented move-to-front (MTF-K) depths: lion's prediction-queue scan
(K = 5) and cheetah's and lion's dictionary scan (K = 2).

Counterpart of the JAX package's `engine/mtf.py::mtf_depths_sorted`
(a `jax.lax.associative_scan`; no Pallas kernel): lion's 5-deep
prediction queue (lion.rs:42-57, 211-270) as a monoid. A hit at depth d
promotes the entry to the front, a miss shifts the queue and inserts at
the front. A run of updates is summarized by its distinct values in
recency order, capped at K:

    D(seg) = take_K(distinct-by-recency)
    D(a ++ b) = take_K(D(b) ++ (D(a) \\ set(D(b))))

so the queue state of every position comes from one segmented prefix
scan over the groups. The zero-initialized queue is modelled by padding
with zeros: its five zero sentinels sit below every live entry, so

    depth(v at t) = index of v in D_before, if present,
                    else cnt_before if v == 0 and cnt_before < K,
                    else K (a miss).

The dictionaries of cheetah and lion (chunk_a, chunk_b of a hash,
cheetah.rs:131-139) are the same monoid at K = 2: depth 0 is a hit on
chunk_a, depth 1 a hit on chunk_b.

On a CUDA tensor `depths` launches `csrc/mtf.cu` at K = 5 or K = 2 (one
launch and, for rows above one tile, a memset of its look-back words);
on a CPU tensor it runs `depths_plain` at K = 5 and `mtf2_plain` at
K = 2 (`engine/grouping.py`'s MTF-2 doubling scans).
"""

from __future__ import annotations

import torch

from density_tpu_torch.engine.grouping import (
    monoid_scan, seg_mtf2_before, seg_mtf2_before_packed, shift_right)
from density_tpu_torch.kernels import _build

launches = 0  # kernel launches through `depths` (see chip_smoke.py)
launches_k = {2: 0, 5: 0}  # the same launches by K
# the C entry point and tile of each K
_ENTRY = {5: ("mtf_depths", "mtf_tile"), 2: ("mtf2_depths", "mtf2_tile")}


def depths(first, v_s, valid_s, K: int):
    """Sorted-domain core: (..., n) values already grouped contiguously
    (segment starts marked by `first`), valid elements only. Returns the
    MTF-K depth of each element at its arrival, int32 in [0, K] (K: a
    miss; invalid elements get K). K is 5 or 2; any other K raises.

    On the card: `first` and `valid_s` bool, `v_s` int32, one shape, all
    contiguous on one device; anything else raises."""
    if K not in _ENTRY:
        raise ValueError(f"the MTF kernel is built for K=5 and K=2, not "
                         f"K={K}")
    if first.device.type != "cuda":
        if K == 2:
            return mtf2_plain(first, v_s, valid_s)
        return depths_plain(first, v_s, valid_s, K)
    _check_args(first, v_s, valid_s)
    out = torch.empty(v_s.shape, dtype=torch.int32, device=v_s.device)
    n = v_s.shape[-1]
    S = v_s.numel() // n if n else 0
    if S == 0:
        return out
    entry, tile = _ENTRY[K]
    tiles = -(-n // getattr(_build.load("mtf"), tile)())
    # look-back words: a status word and 2K slot values a tile
    scratch = (torch.empty((1 + 2 * K) * S * tiles, dtype=torch.int32,
                           device=v_s.device) if tiles > 1 else None)
    fn = _build.function("mtf", entry, 8, (5, 6))
    _build.launch(fn, "mtf", v_s.device, _build.ptr(first), _build.ptr(v_s),
                  _build.ptr(valid_s), _build.ptr(out), _build.ptr(scratch),
                  S, n)
    _build.count_launch(globals(), K)
    return out


def _check_args(first, v_s, valid_s):
    if (first.dtype, v_s.dtype, valid_s.dtype) != (
            torch.bool, torch.int32, torch.bool):
        raise ValueError("first and valid must be bool, the values int32")
    if v_s.ndim < 1 or first.shape != v_s.shape or (
            valid_s.shape != v_s.shape):
        raise ValueError("first, values and valid must have one shape")
    if v_s.numel() >= 2**31:
        raise ValueError("the kernel takes fewer than 2**31 elements")
    if not (first.device == v_s.device == valid_s.device):
        raise ValueError("first, values and valid must be on one device")
    if not (first.is_contiguous() and v_s.is_contiguous()
            and valid_s.is_contiguous()):
        raise ValueError("first, values and valid must be contiguous")


def depths_plain(first, v_s, valid_s, K: int):
    """`depths` by a doubling scan in plain PyTorch. The state is
    (..., n, K) slot values on a trailing slot axis plus one operand of
    count << 1 | sticky segment bit, so a doubling level is a few dozen
    tensor ops (the JAX package unrolls the K slots into ~250
    elementwise ops a level, which XLA fuses; here each op is a launch).
    """
    dim = first.dim() - 1
    dev = first.device
    slot = torch.arange(K, dtype=torch.int32, device=dev)
    v_s = v_s.to(torch.int32)
    D = torch.where(valid_s, v_s, 0)[..., None] * (slot == 0)
    # count (3 bits) and sticky bit in one operand
    cs = (valid_s.to(torch.int32) << 1) | first.to(torch.int32)

    def combine(a, b):
        Da, csa = a
        Db, csb = b
        cnta = (csa >> 1)[..., None]
        cntb = (csb >> 1)[..., None]
        live_b = slot < cntb
        # Da[j] is kept where live in a and absent from Db's live slots
        in_b = ((Da[..., :, None] == Db[..., None, :])
                & live_b[..., None, :]).any(-1)
        keep = (slot < cnta) & ~in_b
        keep32 = keep.to(torch.int32)
        # the kept values before each slot, slot by slot (a cumsum over
        # an innermost axis of 5 takes milliseconds on the card)
        ranks, run = [], torch.zeros_like(cnta)
        for j in range(K):
            ranks.append(run)
            run = run + keep32[..., j:j + 1]
        # Db's live slots, then a's kept values from slot cntb on; a value
        # pushed past slot K - 1 lands in the spare slot K and is dropped
        pos = torch.where(keep, cntb + torch.cat(ranks, -1), K)
        buf = torch.cat([torch.where(live_b, Db, 0),
                         torch.zeros_like(Db[..., :1])], -1)
        Dm = buf.scatter(-1, pos.clamp_(max=K).long(),
                         torch.where(keep, Da, 0))[..., :K]
        cntm = torch.clamp(cntb + run, max=K)[..., 0]
        stb = (csb & 1) == 1
        cnto = torch.where(stb, csb >> 1, cntm)
        return (torch.where(stb[..., None], Db, Dm),
                (cnto << 1) | ((csa | csb) & 1))

    Ds, cso = monoid_scan(combine, (D, cs), (0, 0), dim)
    # the state BEFORE each element: the scan at t - 1, empty at starts
    D_before = torch.where(first[..., None], 0, shift_right(Ds, 0, dim))
    cnt_before = torch.where(first, 0, shift_right(cso >> 1, 0))
    hit = (slot < cnt_before[..., None]) & (D_before == v_s[..., None])
    at = torch.where(hit, slot, K).amin(-1)
    zero_pad = (v_s == 0) & (cnt_before < K)
    depth = torch.where(at < K, at, torch.where(zero_pad, cnt_before, K))
    return torch.where(valid_s, depth, K).to(torch.int32)


def mtf2_plain(first, v_s, valid_s):
    """`depths` at K = 2 from the MTF-2 doubling scan of the dictionaries
    (`seg_mtf2_before`; its packed form while every valid value fits in
    17 bits, as the planners' in-group fingerprints do). On a valid
    element, a hit on the front is depth 0 and one on the second depth 1.
    Both slots read 0 while empty, so a value of 0 gets the live count
    while the list is not full (the front reads 0 only with count 0,
    the second with count 0 or 1), and anything else misses."""
    v_s = v_s.to(torch.int32)
    narrow = not bool((valid_s & ((v_s >> 17) != 0)).any())
    front, second = (seg_mtf2_before_packed if narrow else seg_mtf2_before)(
        first, v_s, valid_s)
    depth = torch.where(v_s == front, 0, torch.where(v_s == second, 1, 2))
    return torch.where(valid_s, depth, 2).to(torch.int32)
