"""One pass of the fixed point over the copy-block set: the protection
FSM's copy decisions for a batch of streams.

Counterpart of the JAX package's `engine/protection.py::replay_fsm` (a
`jax.lax.scan`, vmapped over streams; no Pallas kernel). `step` replays
the FSM over each stream's per-block incompressible bits, keeps the
copies of real blocks alone (blocks at or past ceil(nbytes / block) are
never copies) and compares the new copy set with the last pass's.

On a CUDA tensor `step` launches `csrc/fsm.cu` (one launch, a warp a
stream, the copy set written on the card); on a CPU tensor it runs
`step_plain`: `engine/protection.py::replay_fsm`, the mask and the
compare.
"""

from __future__ import annotations

import numpy as np
import torch

from density_tpu_torch.engine.protection import replay_fsm
from density_tpu_torch.kernels import _build

launches = 0  # kernel launches through `step` (see chip_smoke.py)


def step(bits, nbytes, block: int, prev_copy):
    """(S, nb) bool incompressible bits, (S,) int32 nbytes, the block size
    and the last pass's (S, nb) bool copy set -> (copy, flags): the new
    (S, nb) bool copy set and (2,) int32 flags, (changed, any): whether
    the copy set differs from `prev_copy` anywhere, and whether any block
    is a copy.

    All three tensors contiguous on one device; on the card, besides, nb
    a multiple of 32 and the bool tensors 16-byte aligned. Anything else
    raises."""
    _check_args(bits, nbytes, block, prev_copy)
    if bits.device.type != "cuda":
        return step_plain(bits, nbytes, block, prev_copy)
    S, nb = bits.shape
    if nb % 32 or any(t.data_ptr() % 16 for t in (bits, prev_copy)):
        raise ValueError("the FSM kernel takes nb a multiple of 32 and "
                         "16-byte aligned bits and copy sets")
    copy = torch.empty_like(bits)
    if S == 0:
        return copy, torch.zeros(2, dtype=torch.int32, device=bits.device)
    flags = torch.empty(2, dtype=torch.int32, device=bits.device)
    fn = _build.function("fsm", "fsm_step", 9, (5, 6, 7))
    _build.launch(fn, "fsm", bits.device, _build.ptr(bits),
                  _build.ptr(nbytes), _build.ptr(prev_copy), _build.ptr(copy),
                  _build.ptr(flags), S, nb, block)
    _build.count_launch(globals())
    return copy, flags


def _check_args(bits, nbytes, block, prev_copy):
    if (bits.dtype, nbytes.dtype, prev_copy.dtype) != (
            torch.bool, torch.int32, torch.bool):
        raise ValueError("bits and the copy set must be bool, nbytes int32")
    if bits.ndim != 2 or prev_copy.shape != bits.shape or (
            nbytes.shape != bits.shape[:1]):
        raise ValueError("bits and the copy set must be (S, nb), nbytes (S,)")
    if bits.numel() >= 2**31:
        raise ValueError("the FSM takes fewer than 2**31 blocks")
    if not 1 <= block < 2**31:
        raise ValueError(f"block size {block}")
    if not (bits.device == nbytes.device == prev_copy.device):
        raise ValueError("bits, nbytes and the copy set must be on one "
                         "device")
    if not (bits.is_contiguous() and nbytes.is_contiguous()
            and prev_copy.is_contiguous()):
        raise ValueError("bits, nbytes and the copy set must be contiguous")


def step_plain(bits, nbytes, block: int, prev_copy):
    """`step` on the host: the scalar replay, the mask to real blocks, the
    compare."""
    nb = bits.shape[1]
    nbr = (nbytes.numpy().astype(np.int64) + block - 1) // block
    copy = replay_fsm(bits.numpy()) & (np.arange(nb)[None, :] < nbr[:, None])
    flags = [not np.array_equal(copy, prev_copy.numpy()), bool(copy.any())]
    return torch.from_numpy(copy), torch.tensor(flags, dtype=torch.int32)
