"""Devices and processes (the counterpart of the JAX package's
`parallel/mesh.py`).

Compression is data-parallel over independent streams: the stream axis
is split into contiguous shares, one for each device of a list, and in a
`torch.distributed` run into one contiguous part for each process first.
Encode and decode keep every stream on the device that owns it; the only
communication is the ordered gather of the compressed or decoded bytes.

Entry points run on the CUDA cards unless the caller passes
`device="cpu"` (or a list of devices); they never fall back to the CPU
on their own. A device named twice in a list takes two shares, so the
CPU tests stand for several devices with `["cpu"] * k`.
"""

from __future__ import annotations

import os

import torch


def _no_cuda() -> RuntimeError:
    return RuntimeError(
        "CUDA is not available; pass device='cpu' to run the plain "
        "PyTorch path on the host")


def process_count() -> int:
    """Processes of the `torch.distributed` group (1 without one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank in the `torch.distributed` group (0 without
    one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def default_devices() -> list[torch.device]:
    """Every CUDA device of this process; in a `torch.distributed` run
    this process's one device, `cuda:(LOCAL_RANK % count)` (two ranks on
    one card share `cuda:0`). Raises when there is no card."""
    if not torch.cuda.is_available():
        raise _no_cuda()
    count = torch.cuda.device_count()
    if process_count() > 1:
        local = int(os.environ.get("LOCAL_RANK", process_index()))
        return [torch.device("cuda", local % count)]
    return [torch.device("cuda", i) for i in range(count)]


def resolve_device(device=None) -> torch.device:
    """One device: `None` is the first of `default_devices()`. Raises
    when a CUDA device is asked for and none is present."""
    if device is None:
        return default_devices()[0]
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise _no_cuda()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_devices(device=None) -> list[torch.device]:
    """The devices of the shares: `None` gives `default_devices()`, one
    device a list of one, a list or tuple the list of its devices."""
    if device is None:
        return default_devices()
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("an empty device list")
        return [resolve_device(d) for d in device]
    return [resolve_device(device)]


def shares(S: int, n: int) -> list[tuple[int, int]]:
    """The contiguous split of S streams into n shares (lo, hi), as a
    sharding of the leading axis splits it: ceil(S / n) streams each, the
    last shares shorter or empty."""
    per = -(-S // n) if S else 0
    return [(min(i * per, S), min((i + 1) * per, S)) for i in range(n)]


def distributed_init(init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None) -> None:
    """Multi-process start-up: `torch.distributed.init_process_group`
    with the gloo backend (the gather moves host bytes). The arguments
    default to torchrun's environment (`WORLD_SIZE`, `RANK`,
    `MASTER_ADDR`/`MASTER_PORT` through "env://"). Does nothing when the
    group is already initialised or there is one process."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    dist.init_process_group("gloo", init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
