"""Row-wise sort of int32 arrays: the port of the TPU sort kernel.

Counterpart of `density_tpu/kernels/bigsort.py::sort`: sorts S rows of
N int32 arrays by the first `n_keys` (signed, lexicographic), carrying
the rest; 1-3 arrays, N a power of two. Callers bias unsigned keys by
`^ -2**31` and fold a unique index into them, so the sorted order is
unique.

On a CUDA tensor the sort runs the hand-written kernel
(`csrc/bigsort.cu`): a tile kernel runs every pass of distance below the
tile T (the whole row up to 16384 elements, else 8192) on chip, and each
merge stage above the tile is one global launch plus one tile launch, so
a sort of N > T takes 1 + 2 log2(N / T) launches: 7 at N = 65536. The
first launch reads the caller's arrays (contiguous int32, as the paths
pass them) and writes fresh outputs, so nothing is copied first. On a
CPU tensor it runs `sort_plain`, the same bitonic network in plain
PyTorch. Both execute the TPU kernel's compare-exchange network pass for
pass, so all three agree exactly, ties included.
"""

from __future__ import annotations

import torch

from density_tpu_torch.kernels import _build

launches = 0  # calls of `sort` that launched the kernel (see chip_smoke.py)


def check_args(arrays, n_keys):
    if not 1 <= len(arrays) <= 3 or n_keys not in (1, 2) or n_keys > len(
            arrays):
        raise ValueError(f"{len(arrays)} arrays with n_keys={n_keys}")
    S, N = arrays[0].shape
    if N < 2 or N & (N - 1):
        raise ValueError(f"N={N} is not a power of two")
    for a in arrays:
        if a.shape != (S, N) or a.device != arrays[0].device:
            raise ValueError("arrays differ in shape or device")


def sort(*arrays: torch.Tensor, n_keys: int = 1):
    """Returns the sorted copies of `arrays` as a tuple of (S, N) int32."""
    check_args(arrays, n_keys)
    if arrays[0].device.type != "cuda":
        return sort_plain(*arrays, n_keys=n_keys)
    outs = launch("bigsort", arrays, n_keys)
    _build.count_launch(globals())
    return outs


def launch(name: str, arrays, n_keys: int):
    """Sorts checked CUDA `arrays` with the C entry point `<name>_sort` of
    `csrc/<name>.cu` (bigsort's and bitonic's take the same arguments)
    into fresh outputs, and returns them."""
    S, N = arrays[0].shape
    # the kernel reads contiguous rows in 16-byte vectors: int32 arrays in
    # that layout (those of the paths) go in as they are, others are copied
    srcs = [a.to(torch.int32) for a in arrays]
    srcs = [a if a.is_contiguous() and a.data_ptr() % 16 == 0
            else a.clone(memory_format=torch.contiguous_format) for a in srcs]
    outs = [torch.empty((S, N), dtype=torch.int32, device=a.device)
            for a in srcs]
    pad = [None] * (3 - len(srcs))
    fn = _build.function(name, f"{name}_sort", 11, range(6, 10))
    _build.launch(fn, name, srcs[0].device, *[_build.ptr(a) for a in srcs],
                  *pad, *[_build.ptr(o) for o in outs], *pad, len(srcs),
                  n_keys, S, N)
    return tuple(outs)


def _lex_less(a1, a2, b1, b2):
    if a2 is None:
        return a1 < b1
    return (a1 < b1) | ((a1 == b1) & (a2 < b2))


def sort_plain(*arrays: torch.Tensor, n_keys: int = 1):
    """The kernel's bitonic network in plain PyTorch: stage k, distance
    j, partner i ^ j, ascending where (i & k) == 0."""
    check_args(arrays, n_keys)
    S, N = arrays[0].shape
    arrs = [a.to(torch.int32) for a in arrays]
    k = 2
    while k <= N:
        j = k >> 1
        while j >= 1:
            # view each row as (N / 2j) groups of [lo half | hi half]
            v = [a.reshape(S, N // (2 * j), 2, j) for a in arrs]
            lo = [x[:, :, 0, :] for x in v]
            hi = [x[:, :, 1, :] for x in v]
            gi = torch.arange(N // (2 * j), device=arrs[0].device)
            asc = ((gi * 2 * j) & k) == 0  # j < k: same for the whole group
            asc = asc[None, :, None]
            k2l = lo[1] if n_keys == 2 else None
            k2h = hi[1] if n_keys == 2 else None
            swap = torch.where(asc, _lex_less(hi[0], k2h, lo[0], k2l),
                               _lex_less(lo[0], k2l, hi[0], k2h))
            arrs = [torch.stack([torch.where(swap, h, l),
                                 torch.where(swap, l, h)], dim=2
                                ).reshape(S, N)
                    for l, h in zip(lo, hi)]
            j >>= 1
        k <<= 1
    return tuple(arrs)
