"""Devices and processes (the counterpart of the JAX package's
`parallel/mesh.py`).

Compression is data-parallel over independent streams: the stream axis
is split into contiguous shares, one for each device of a list, and in a
`torch.distributed` run into one contiguous part for each process first.
Encode and decode keep every stream on the device that owns it; the only
communication is the ordered gather of the compressed or decoded bytes.
Over several devices the shares run at once, each on a thread of torch's
inter-op pool and a CUDA stream of its own (`run_shares`), as a sharded
program runs every device at once; the workers take turns at the host
and hand it on while they wait for their cards (`hostsync`).

Entry points run on the CUDA cards unless the caller passes
`device="cpu"` (or a list of devices); they never fall back to the CPU
on their own. A device named twice in a list takes two shares, so the
CPU tests stand for several devices with `["cpu"] * k`.
"""

import functools
import itertools
import os
import threading
import warnings

import torch

from density_tpu_torch import hostsync
from density_tpu_torch.tracing import span


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


# One CUDA stream for each (device ordinal, worker index), kept for the
# process: a bounded set, so the per-stream state of the kernels
# (`kernels/packroute.py`) and the allocator's per-stream pools do not
# grow with the number of calls.
_worker_streams: dict = {}
_worker_streams_lock = threading.Lock()


def worker_stream(dev: torch.device, i: int):
    """The CUDA stream of worker `i` on card `dev` (an ordinal given)."""
    with _worker_streams_lock:
        s = _worker_streams.get((dev.index, i))
        if s is None:
            s = _worker_streams[dev.index, i] = torch.cuda.Stream(dev)
        return s


# The functions of each call of `run_at_once` in flight, by call number.
_calls: dict = {}
_numbers = itertools.count()


@torch.jit.ignore
def _run_one(call: int, i: int) -> int:
    _calls[call][i]()
    return i


def _fork_all(call: int, n: int) -> int:
    futures = [torch.jit.fork(_run_one, call, i) for i in range(n)]
    for f in futures:
        torch.jit.wait(f)
    return n


@functools.cache
def _forking():
    """`_fork_all`, compiled by TorchScript at its first use."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return torch.jit.script(_fork_all)


def run_at_once(fns: list) -> None:
    """Runs every function of `fns` at once, each on a thread of torch's
    inter-op pool, and returns when all have returned. TorchScript's
    `fork` hands each the calling thread's thread-local state, so a
    profiler session of the caller records their spans and ops too (a
    thread started by `threading` inherits none of it). The pool holds
    `torch.get_num_interop_threads()` threads, one per core unless the
    process sets another number; functions beyond that start as others
    return. Each function catches its own faults."""
    call = next(_numbers)
    _calls[call] = list(fns)
    try:
        _forking()(call, len(fns))
    finally:
        del _calls[call]


def run_shares(devs: list, tasks: list) -> list:
    """Runs each share's task and returns their results in order.

    `tasks` holds (device, fn) pairs; `devs` is the device list of the
    call. With one device the tasks run in turn in the caller's thread,
    on its current stream. With more, every task runs at once on a
    thread of torch's inter-op pool (`run_at_once`), on a CUDA stream of
    its own on a card (`worker_stream`), taking turns at the host
    (`hostsync.turn`): while one worker waits for its card, another
    dispatches, and the cards run every share's work at once. Every
    worker is done before this returns or raises; where tasks fail, the
    first failing task's exception is raised. Each task is the span
    `sharding.share`."""
    if len(devs) == 1:
        results = []
        for _, fn in tasks:
            with span("sharding.share"):
                results.append(fn())
        return results
    results = [None] * len(tasks)
    faults = [None] * len(tasks)
    streams = [worker_stream(torch.device(
        "cuda", torch.cuda.current_device() if dev.index is None
        else dev.index), i) if dev.type == "cuda" else None
        for i, (dev, _) in enumerate(tasks)]

    def work(i: int, fn) -> None:
        with hostsync.turn(), span("sharding.share"):
            try:
                if streams[i] is None:
                    results[i] = fn()
                    return
                with torch.cuda.stream(streams[i]):
                    results[i] = fn()
            except Exception as e:  # noqa: BLE001 - raised in the caller
                faults[i] = e
                if streams[i] is not None:
                    # leave no work of the failed task queued on the card
                    try:
                        with hostsync.waiting(), span("wait.other"):
                            streams[i].synchronize()
                    except RuntimeError:
                        pass  # a CUDA fault: `e` already reports it
    run_at_once([functools.partial(work, i, fn)
                 for i, (_, fn) in enumerate(tasks)])
    for e in faults:
        if e is not None:
            raise e
    return results


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
