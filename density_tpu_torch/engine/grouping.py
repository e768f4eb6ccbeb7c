"""Sort-based hash-grouping primitives on int32 tensors.

Counterpart of the JAX package's `engine/grouping.py` (the part the
chameleon path uses). Quads are kept as int32 bit patterns: torch has
no usable uint32 arithmetic (`>>` on int32 is arithmetic, on uint32 it
is not implemented for the CPU), so every right shift is followed by a
mask and the hash relies on int32 multiplication wrapping mod 2**32.

Functions act on a trailing scan axis and are batched over any leading
axes (the streams).
"""

from __future__ import annotations

import torch

from density_tpu_torch.constants import HASH_BITS, HASH_MULTIPLIER_I32


def hash_quads(quads: torch.Tensor) -> torch.Tensor:
    """h = (quad * 0x9D6EF916) >> 16 as int32 in [0, 65536)."""
    prod = quads.to(torch.int32) * HASH_MULTIPLIER_I32
    return (prod >> (32 - HASH_BITS)) & ((1 << HASH_BITS) - 1)


def shift_n(x: torch.Tensor, s: int, fill, dim: int = -1) -> torch.Tensor:
    """Dense shift by s along `dim`, filling with `fill`."""
    n = x.shape[dim]
    if s >= n:
        return torch.full_like(x, fill)
    pad_shape = list(x.shape)
    pad_shape[dim] = s
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
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
