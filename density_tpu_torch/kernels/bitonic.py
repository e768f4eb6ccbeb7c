"""Row-wise sort in one launch: the port of the TPU bitonic kernel.

Counterpart of `density_tpu/kernels/bitonic.py::sort`, which the JAX
package's chameleon planner takes under `DENSITY_TPU_SORT=bitonic`. Its
contract is `bigsort.sort`'s: S rows of N int32 arrays sorted by the
first `n_keys` (signed, lexicographic), carrying the rest; 1-3 arrays,
N a power of two >= 256.

On a CUDA tensor the sort runs `csrc/bitonic.cu` in one launch while a
row has at most 65536 elements: one CTA per row up to 16384, above it a
thread-block cluster of N / 8192 CTAs that holds the row in their shared
memory. A longer row takes 1 + 2 log2(N / 65536) launches (up to
N = 2^20): the cluster sorts 65536-element spans, and each merge stage
above the span is a global launch plus a cluster launch. On a CPU tensor
it runs `sort_plain`. Both run the Batcher schedule of the TPU kernel
(stage k, distance j, partner i ^ j, ascending where (i & k) == 0),
which is also bigsort's, so all of them agree exactly, ties included.
"""

from __future__ import annotations

import ctypes

import torch

from density_tpu_torch.kernels import _build, bigsort

MIN_N = 256
launches = 0  # kernel launches through `sort` (see chip_smoke.py)


def _check_args(arrays, n_keys):
    bigsort.check_args(arrays, n_keys)
    N = arrays[0].shape[1]
    if N < MIN_N:
        raise ValueError(f"N={N} is below {MIN_N}")


def sort(*arrays: torch.Tensor, n_keys: int = 1):
    """Returns the sorted copies of `arrays` as a tuple of (S, N) int32."""
    _check_args(arrays, n_keys)
    if arrays[0].device.type != "cuda":
        return sort_plain(*arrays, n_keys=n_keys)
    outs = bigsort.launch("bitonic", arrays, n_keys)
    _build.count_launch(globals())
    return outs


def resident_clusters(n_arrays: int, n_keys: int, N: int) -> int:
    """How many clusters of the sort of rows of N > 16384 elements the
    card holds at once (`cudaOccupancyMaxActiveClusters`)."""
    out = ctypes.c_int(0)
    fn = _build.function("bitonic", "bitonic_clusters", 4, (0, 1, 2))
    _build.check(fn(n_arrays, n_keys, N, ctypes.byref(out)),
                 "bitonic_clusters")
    return out.value


def sort_plain(*arrays: torch.Tensor, n_keys: int = 1):
    """The network in plain PyTorch: `bigsort.sort_plain`, the same
    schedule."""
    _check_args(arrays, n_keys)
    return bigsort.sort_plain(*arrays, n_keys=n_keys)
