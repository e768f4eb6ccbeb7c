"""Row-wise sort in one launch: the port of the TPU bitonic kernel.

Counterpart of `density_tpu/kernels/bitonic.py::sort`, which the JAX
package's chameleon planner takes under `DENSITY_TPU_SORT=bitonic`. Its
contract is `bigsort.sort`'s: S rows of N int32 arrays sorted by the
first `n_keys` (signed, lexicographic), carrying the rest; 1-3 arrays,
N a power of two >= 256.

On a CUDA tensor the sort launches `csrc/bitonic.cu` once (one CTA per
row, the whole network); on a CPU tensor it runs `sort_plain`. Both run
the Batcher schedule of the TPU kernel (`_schedule`: stage k, distance
j, partner i ^ j, ascending where (i & k) == 0), which is also
bigsort's, so all of them agree exactly, ties included.
"""

from __future__ import annotations

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
    global launches
    _check_args(arrays, n_keys)
    if arrays[0].device.type != "cuda":
        return sort_plain(*arrays, n_keys=n_keys)
    # the kernel sorts in place: fresh contiguous copies
    outs = [a.to(torch.int32).clone(memory_format=torch.contiguous_format)
            for a in arrays]
    S, N = outs[0].shape
    fn = _build.function("bitonic", "bitonic_sort", 8, (3, 4, 5, 6))
    p = [_build.ptr(o) for o in outs] + [_build.ptr(None)] * (3 - len(outs))
    rc = fn(*p, len(outs), n_keys, S, N, _build.stream_ptr(outs[0].device))
    _build.check(rc, "bitonic")
    launches += 1
    return tuple(outs)


def sort_plain(*arrays: torch.Tensor, n_keys: int = 1):
    """The network in plain PyTorch: `bigsort.sort_plain`, the same
    schedule."""
    _check_args(arrays, n_keys)
    return bigsort.sort_plain(*arrays, n_keys=n_keys)
