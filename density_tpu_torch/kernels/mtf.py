"""Segmented move-to-front (MTF-K) depths: lion's prediction-queue scan.

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

On a CUDA tensor `depths` launches `csrc/mtf.cu` (one launch and, for
rows above 4096 elements, a memset of its look-back words); on a CPU
tensor it runs `depths_plain`, the doubling scan in plain PyTorch.
"""

from __future__ import annotations

import torch

from density_tpu_torch.engine.grouping import monoid_scan, shift_right
from density_tpu_torch.kernels import _build

launches = 0  # kernel launches through `depths` (see chip_smoke.py)


def depths(first, v_s, valid_s, K: int):
    """Sorted-domain core: (..., n) values already grouped contiguously
    (segment starts marked by `first`), valid elements only. Returns the
    MTF-K depth of each element at its arrival, int32 in [0, K] (K: a
    miss; invalid elements get K).

    On the card: `first` and `valid_s` bool, `v_s` int32, one shape, all
    contiguous on one device, K = 5; anything else raises."""
    if first.device.type != "cuda":
        return depths_plain(first, v_s, valid_s, K)
    _check_args(first, v_s, valid_s, K)
    out = torch.empty(v_s.shape, dtype=torch.int32, device=v_s.device)
    n = v_s.shape[-1]
    S = v_s.numel() // n if n else 0
    if S == 0:
        return out
    lib = _build.load("mtf")
    tiles = -(-n // lib.mtf_tile())
    # look-back words: a status word and 10 slot values a tile
    scratch = (torch.empty(11 * S * tiles, dtype=torch.int32,
                           device=v_s.device) if tiles > 1 else None)
    fn = _build.function("mtf", "mtf_depths", 8, (5, 6))
    _build.launch(fn, "mtf", v_s.device, _build.ptr(first), _build.ptr(v_s),
                  _build.ptr(valid_s), _build.ptr(out), _build.ptr(scratch),
                  S, n)
    _build.count_launch(globals())
    return out


def _check_args(first, v_s, valid_s, K):
    if K != 5:
        raise ValueError(f"the MTF kernel is built for K=5, not K={K}")
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
