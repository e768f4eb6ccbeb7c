"""Sort-based hash-grouping primitives on int32 tensors.

Counterpart of the JAX package's `engine/grouping.py` (the part the
chameleon, cheetah and lion paths use). Quads are kept as int32 bit
patterns: torch has no usable uint32 arithmetic (`>>` on int32 is
arithmetic, on uint32 it is not implemented for the CPU), so every right
shift is followed by a mask and the hash relies on int32 multiplication
wrapping mod 2**32.

Functions act on a trailing scan axis and are batched over any leading
axes (the streams).
"""

from __future__ import annotations

import torch

from density_tpu_torch.constants import (
    HASH_BITS, HASH_MULTIPLIER_I32, OP_INS, OP_SWAP)


def hash_quads(quads: torch.Tensor) -> torch.Tensor:
    """h = (quad * 0x9D6EF916) >> 16 as int32 in [0, 65536)."""
    prod = quads.to(torch.int32) * HASH_MULTIPLIER_I32
    return (prod >> (32 - HASH_BITS)) & ((1 << HASH_BITS) - 1)


def shift_n(x: torch.Tensor, s: int, fill, dim: int = -1) -> torch.Tensor:
    """Dense shift by s along `dim`, filling with `fill`: a scalar, or a
    tensor that broadcasts over the pad (a per-slot identity on a
    trailing slot axis)."""
    n = x.shape[dim]
    pad_shape = list(x.shape)
    pad_shape[dim] = min(s, n)
    if isinstance(fill, torch.Tensor):
        pad = fill.to(dtype=x.dtype, device=x.device).expand(pad_shape)
    else:
        pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    if s >= n:
        return pad.contiguous()
    return torch.cat([pad, x.narrow(dim, 0, n - s)], dim=dim)


def shift_right(x: torch.Tensor, fill, dim: int = -1) -> torch.Tensor:
    """Dense shift by one along `dim` (the previous element)."""
    return shift_n(x, 1, fill, dim)


def monoid_scan(combine, elems, identities, dim: int = -1):
    """Inclusive prefix scan by Hillis-Steele doubling: log2(n)
    applications of combine(state shifted by s, state), filling with the
    monoid identity."""
    n = elems[0].shape[dim]
    state = list(elems)
    s = 1
    while s < n:
        shifted = [shift_n(x, s, f, dim) for x, f in zip(state, identities)]
        state = list(combine(tuple(shifted), tuple(state)))
        s *= 2
    return state


def prev_valid_value_in_group(group: torch.Tensor, values: torch.Tensor,
                              valid: torch.Tensor, fill: int = 0):
    """For each position i of each row: the value of the latest position
    j < i with group[j] == group[i] and valid[j], else `fill`.

    The group sort is `torch.sort` (stable): the JAX package computes
    this with XLA's sort outside any Pallas kernel, and only the masked
    fixed-point plan (streams with copy blocks) reaches it.
    Returns (prev_value, has_prev) in original order.
    """
    n = group.shape[-1]
    g_s, order = torch.sort(group, dim=-1, stable=True)
    v_s = torch.gather(values, -1, order)
    valid_s = torch.gather(valid, -1, order)
    idx = torch.arange(n, device=group.device).expand_as(order)
    lv_incl = torch.cummax(torch.where(valid_s, idx, -1), dim=-1).values
    lv = shift_right(lv_incl, -1)
    lv_c = lv.clamp(min=0)
    same_group = torch.gather(g_s, -1, lv_c) == g_s
    has_prev_s = (lv >= 0) & same_group
    prev_val_s = torch.where(has_prev_s, torch.gather(v_s, -1, lv_c),
                             torch.full_like(v_s, fill))
    inv = torch.empty_like(order)
    inv.scatter_(-1, order, idx.contiguous())
    return (torch.gather(prev_val_s, -1, inv),
            torch.gather(has_prev_s, -1, inv))


def seg_last_active_before(first, vals, active):
    """Sorted-domain segmented fill: for each position t, the value of
    the latest ACTIVE position strictly before t within its segment
    (segments start where `first` is set), else 0. Returns (value, has).
    """

    def combine(a, b):
        va, ha, sa = a
        vb, hb, sb = b
        v = torch.where(sb | hb, vb, va)
        h = torch.where(sb, hb, ha | hb)
        return v, h, sa | sb

    vi, hi, _ = monoid_scan(
        combine, (torch.where(active, vals, 0), active, first),
        (0, False, False))
    # exclusive: shift by one, reset at segment starts
    v = torch.where(first, 0, shift_right(vi, 0))
    h = torch.where(first, False, shift_right(hi, False))
    return v, h


def _mtf2_merge(a0, a1, ca, b0, b1, cb):
    """Merge of two MTF-2 states: b's distinct values (cb of them) in
    front, then a's that b does not hold, capped at two."""
    in_b0 = ((cb >= 1) & (a0 == b0)) | ((cb >= 2) & (a0 == b1))
    in_b1 = ((cb >= 1) & (a1 == b0)) | ((cb >= 2) & (a1 == b1))
    keep0 = (ca >= 1) & ~in_b0
    keep1 = (ca >= 2) & ~in_b1
    first_kept = torch.where(keep0, a0, a1)
    any_kept = keep0 | keep1
    m0 = torch.where(cb >= 1, b0, torch.where(any_kept, first_kept, 0))
    m1 = torch.where(cb >= 2, b1,
                     torch.where(cb == 1, torch.where(any_kept, first_kept, 0),
                                 torch.where(keep0 & keep1, a1, 0)))
    cm = torch.clamp(cb + keep0.to(cb.dtype) + keep1.to(cb.dtype), max=2)
    return m0, m1, cm


def seg_mtf2_before(first, vals, active):
    """Sorted-domain MTF-2 state observed BEFORE each position, over
    active positions, reset at `first`: (front, second), the chunk_a /
    chunk_b pair the reference dictionaries hold when the position is
    processed (missing entries read as 0). A doubling scan of the MTF
    monoid; count (2 bits) and sticky segment bit share one operand."""
    cs0 = (active.to(torch.int32) << 1) | first.to(torch.int32)

    def combine(a, b):
        a0, a1, csa = a
        b0, b1, csb = b
        sb = (csb & 1) == 1
        m0, m1, cm = _mtf2_merge(a0, a1, csa >> 1, b0, b1, csb >> 1)
        return (torch.where(sb, b0, m0), torch.where(sb, b1, m1),
                (torch.where(sb, csb >> 1, cm) << 1) | ((csa | csb) & 1))

    i0, i1, _ = monoid_scan(
        combine, (torch.where(active, vals, 0), torch.zeros_like(vals), cs0),
        (0, 0, 0))
    front = torch.where(first, 0, shift_right(i0, 0))
    second = torch.where(first, 0, shift_right(i1, 0))
    return front, second


def seg_mtf2_before_packed(first, vals, active):
    """`seg_mtf2_before` for values of at most 17 bits (the planner's
    in-group fingerprints): second, count and sticky bit pack into one
    operand beside front, two scan operands instead of three. The same
    results."""
    vals = vals.to(torch.int32)
    cs0 = ((active.to(torch.int32) << 17) | (first.to(torch.int32) << 19))

    def combine(a, b):
        a0, pa = a
        b0, pb = b
        sb = ((pb >> 19) & 1) == 1
        m0, m1, cm = _mtf2_merge(a0, pa & 0x1FFFF, (pa >> 17) & 3,
                                 b0, pb & 0x1FFFF, (pb >> 17) & 3)
        o1 = torch.where(sb, pb & 0x1FFFF, m1)
        co = torch.where(sb, (pb >> 17) & 3, cm)
        return (torch.where(sb, b0, m0),
                o1 | (co << 17) | ((pa | pb) & (1 << 19)))

    i0, ip = monoid_scan(combine, (torch.where(active, vals, 0), cs0),
                         (0, 0))
    front = torch.where(first, 0, shift_right(i0, 0))
    second = torch.where(first, 0, shift_right(ip & 0x1FFFF, 0))
    return front, second


def seg_sel2_before(first, op, cval):
    """Sorted-domain MTF-2 state BEFORE each position from flag-driven
    ops (the decoder's dictionary chain, cheetah.rs:68-103): OP_INS
    inserts the constant `cval` ((a, b) <- (c, a)), OP_SWAP swaps
    ((a, b) <- (b, a)), OP_ID keeps the state; segments reset to the
    zero state at `first`. One doubling scan of selection maps: each
    output slot selects input slot A (0), B (1) or its constant (2).
    Returns (a_before, b_before)."""
    ins, swap = op == OP_INS, op == OP_SWAP
    sa = torch.where(ins, 2, torch.where(swap, 1, 0))
    sb = torch.where(ins | swap, 0, 1)
    ca = torch.where(ins, cval, 0)
    cb = torch.zeros_like(cval)
    # segment starts compose with the zero state: every selector reads
    # a constant, 0 unless it already was one
    ca = torch.where(first & (sa != 2), 0, ca)
    sa = torch.where(first, 2, sa)
    cb = torch.where(first & (sb != 2), 0, cb)
    sb = torch.where(first, 2, sb)

    def resolve(e_sa, e_ca, e_sb, e_cb, l_src, l_cst):
        """A later selector resolved through the earlier map."""
        src = torch.where(l_src == 2, 2, torch.where(l_src == 0, e_sa, e_sb))
        cst = torch.where(l_src == 2, l_cst,
                          torch.where(l_src == 0, e_ca, e_cb))
        return src, cst

    def combine(a, b):
        asa, aca, asb, acb, sta = a
        bsa, bca, bsb, bcb, stb = b
        osa, oca = resolve(asa, aca, asb, acb, bsa, bca)
        osb, ocb = resolve(asa, aca, asb, acb, bsb, bcb)
        return (torch.where(stb, bsa, osa), torch.where(stb, bca, oca),
                torch.where(stb, bsb, osb), torch.where(stb, bcb, ocb),
                sta | stb)

    # the identity map: out_a = in_a (src 0), out_b = in_b (src 1)
    isa, ica, isb, icb, _ = monoid_scan(combine, (sa, ca, sb, cb, first),
                                        (0, 0, 1, 0, False))
    a_inc = torch.where(isa == 2, ica, 0)
    b_inc = torch.where(isb == 2, icb, 0)
    return (torch.where(first, 0, shift_right(a_inc, 0)),
            torch.where(first, 0, shift_right(b_inc, 0)))


def seg_selq_before(first, kind, depth, cval, K: int):
    """Sorted-domain K-slot prediction-queue state BEFORE each position
    from flag-driven ops (lion's decode, lion.rs:50-57, 126-186):

      kind == OP_INS:  shift-insert the constant `cval` at slot 0
                       (q <- [c, q0, .., q_{K-2}]; no dedup)
      kind == OP_SWAP: promote slot `depth` to the front
                       (q <- [q_d, q0, .., q_{d-1}, q_{d+1}, ..])
      kind == OP_ID:   leave the queue (invalid positions)

    Segments reset to the zero queue at `first`. One doubling scan of
    selection maps on a trailing slot axis: each output slot selects an
    input slot (0..K-1) or its constant (K). Two maps compose by one
    gather on the slot axis, with no (..., K, K) one-hot. Returns
    (..., n, K) int32."""
    dev = first.device
    dim = first.dim() - 1  # the scan axis of (..., n) and (..., n, K)
    slot = torch.arange(K, dtype=torch.int8, device=dev)
    d = depth.to(torch.int8)[..., None]
    src_ins = torch.where(slot == 0, K, slot - 1).to(torch.int8)
    src_pro = torch.where(slot == 0, d, torch.where(slot <= d, slot - 1, slot))
    ins = (kind == OP_INS)[..., None]
    src = torch.where(ins, src_ins,
                      torch.where((kind == OP_SWAP)[..., None], src_pro, slot))
    cst = torch.where(ins & (slot == 0), cval.to(torch.int32)[..., None], 0)
    # segment starts compose with the zero queue: every selector reads a
    # constant, 0 unless it already was one
    cst = torch.where(first[..., None] & (src != K), 0, cst)
    src = torch.where(first[..., None], K, src).to(torch.int8)

    def combine(a, b):
        asrc, acst, sta = a
        bsrc, bcst, stb = b
        sel = bsrc.long().clamp_(max=K - 1)
        isc = bsrc == K
        osrc = torch.where(isc, K, torch.gather(asrc, -1, sel))
        ocst = torch.where(isc, bcst, torch.gather(acst, -1, sel))
        st = stb[..., None]
        return (torch.where(st, bsrc, osrc), torch.where(st, bcst, ocst),
                sta | stb)

    # the identity map: every output slot selects its own input slot
    isrc, icst, _ = monoid_scan(combine, (src, cst, first),
                                (slot, 0, False), dim)
    inc = torch.where(isrc == K, icst, 0)
    return torch.where(first[..., None], 0, shift_right(inc, 0, dim))


def ctx_fill(h, valid):
    """Dense last_hash chain: the hash of the latest valid position
    strictly before each one, 0 if none (cheetah.rs:148). A keep-right-
    if-set doubling scan."""

    def combine(a, b):
        return (torch.where(b[0] < 0, a[0], b[0]),)

    (filled,) = monoid_scan(combine, (torch.where(valid, h, -1),), (-1,))
    return torch.clamp(shift_right(filled, -1), min=0)


def mru2_state_in_group(group, values, valid):
    """MRU-2 (move-to-front, depth 2) dictionary state seen at each
    position, over valid positions grouped by `group`: (front, second)
    == (chunk_a, chunk_b) of cheetah's dictionaries when the position is
    processed (cheetah.rs:131-139), zeros where absent. Closed form
    after one stable sort: front = the previous valid value in the
    group; second = the valid value just before the run of equal values
    that the previous valid position ends. The sort is `torch.sort`,
    as the JAX package sorts here with XLA: only the masked plan of
    streams with copy blocks reaches it. Returns both in input order."""
    n = group.shape[-1]
    g_s, order = torch.sort(group, dim=-1, stable=True)
    v_s = torch.gather(values, -1, order)
    valid_s = torch.gather(valid, -1, order)
    idx = torch.arange(n, device=group.device).expand_as(order)
    lv_incl = torch.cummax(torch.where(valid_s, idx, -1), dim=-1).values
    lv = shift_right(lv_incl, -1)
    lv_c = lv.clamp(min=0)
    has_prev = (lv >= 0) & (torch.gather(g_s, -1, lv_c) == g_s)
    pv = torch.where(has_prev, torch.gather(v_s, -1, lv_c), 0)
    # a valid position starts a run where it has no valid predecessor in
    # its group or its value differs from that predecessor's
    run_start = valid_s & (~has_prev | (v_s != pv))
    rs = torch.cummax(torch.where(run_start, idx, -1), dim=-1).values
    before_run = torch.where(rs >= 0, torch.gather(pv, -1, rs.clamp(min=0)),
                             0)
    second = torch.where(has_prev, torch.gather(before_run, -1, lv_c), 0)
    inv = torch.empty_like(order)
    inv.scatter_(-1, order, idx.contiguous())
    return torch.gather(pv, -1, inv), torch.gather(second, -1, inv)
