"""Segmented move-to-front (MTF-K) depths by a doubling scan.

Counterpart of the JAX package's `engine/mtf.py`: lion's 5-deep
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

The state is (..., n, K) slot values on a trailing slot axis plus one
operand of count << 1 | sticky segment bit, so a doubling level is a
few dozen tensor ops (the JAX package unrolls the K slots into ~250
elementwise ops a level, which XLA fuses; here each op is a launch).
"""

from __future__ import annotations

import torch

from density_tpu_torch.engine.grouping import monoid_scan, shift_right


def mtf_depths_sorted(first, v_s, valid_s, K: int):
    """Sorted-domain core: (..., n) values already grouped contiguously
    (segment starts marked by `first`), valid elements only. Returns the
    MTF-K depth of each element at its arrival, int32 in [0, K] (K: a
    miss; invalid elements get K)."""
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


def mtf_depths_in_group(group, values, valid, K: int):
    """MTF-K depth of each element at its arrival within its group, over
    valid elements, in input order ((..., n) tensors). The group sort is
    a stable `torch.sort`: the JAX package sorts here with XLA's argsort
    outside any Pallas kernel (`sort_by_group`), and only the masked plan
    of streams with copy blocks reaches it."""
    g_s, order = torch.sort(group, dim=-1, stable=True)
    first = g_s != shift_right(g_s, 0)
    first[..., 0] = True
    depth_s = mtf_depths_sorted(first, torch.gather(values, -1, order),
                                torch.gather(valid, -1, order), K)
    return torch.empty_like(depth_s).scatter_(-1, order, depth_s)
