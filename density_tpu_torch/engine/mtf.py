"""Segmented move-to-front (MTF-K) depths: lion's 5-deep prediction queue
and the 2-deep dictionaries of cheetah and lion.

Counterpart of the JAX package's `engine/mtf.py`. The scan itself, its
monoid and its plain PyTorch versions are in `kernels/mtf.py`; on the
card it is one launch of `csrc/mtf.cu`.
"""

from __future__ import annotations

import torch

from density_tpu_torch.engine.grouping import shift_right
from density_tpu_torch.kernels import mtf

# (first, v_s, valid_s, K) -> int32 depths of values already grouped
# contiguously: the kernel on the card, the doubling scan on the CPU
mtf_depths_sorted = mtf.depths


def mtf2_depths_sorted(first, v_s, valid_s):
    """The copy-free planners' dictionary scan: the MTF-2 depth of each
    valid element of values grouped by hash (segment starts `first`).
    Depth 0 is a hit on the front (chunk_a), 1 a hit on the second
    (chunk_b), 2 a miss or an invalid element. One K=2 launch on the
    card, the MTF-2 doubling scan on the CPU."""
    return mtf.depths(first, v_s, valid_s, 2)


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
