"""The host's waits for the card, and the turns that the shares' workers
take at the host.

Over several devices the shares of a container run at once, each on a
worker thread (`parallel.mesh.run_shares`). PyTorch ops release the
interpreter lock while they run, so workers that dispatch at the same
time trade the lock at every op, and each trade wakes a thread: one
small op from four threads at once costs several times its time alone
(`tools/share_costs.py`, PERF.md section 6). So a worker holds the
host's turn while it runs Python (`turn`) and lets go of it only while
it waits for its card or for the native runtime: in `read` (a host read
of the card), `masked` (an index by a boolean mask, which reads the
mask's count), `to_card` (a blocking copy onto the card) and `waiting`
(any other wait). Every such wait of a share's task goes through them;
a sync elsewhere would hold the turn while it blocks and run the
workers in turn. Outside a worker they are the plain calls, so one
device runs as it did.

Each of `read`, `to_card` and `masked` is a span of the `wait` layer
(`wait.read`, `wait.to_card`, `wait.masked`; `tracing`), inside which
the host blocks on the card and runs nothing of the port's own. A
worker opens the span after it lets go of the turn and closes it before
it takes the turn back, so the time it then queues for the turn counts
to the span around the wait, not to the wait.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from density_tpu_torch.tracing import span

_turn = threading.Lock()
_worker = threading.local()


def holds_turn() -> bool:
    """Whether this thread is a worker that holds the host's turn."""
    return getattr(_worker, "turn", False)


@contextlib.contextmanager
def turn():
    """Around a worker's task: it holds the host's turn but in its waits."""
    with _turn:
        _worker.turn = True
        try:
            yield
        finally:
            _worker.turn = False


@contextlib.contextmanager
def waiting():
    """Around a wait of a worker: another worker takes the host meanwhile.
    Does nothing outside a worker."""
    if not holds_turn():
        yield
        return
    _worker.turn = False
    _turn.release()
    try:
        yield
    finally:
        _turn.acquire()
        _worker.turn = True


def read(t: torch.Tensor) -> np.ndarray:
    """`t` as a host array: on a card, a read that waits for its stream."""
    with waiting(), span("wait.read"):
        return t.cpu().numpy()


def to_card(a: np.ndarray, device) -> torch.Tensor:
    """Host array `a` on `device`: on a card, a blocking copy."""
    with waiting(), span("wait.to_card"):
        return torch.from_numpy(a).to(device)


def masked(t: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """`t[mask]`: on a card, it waits for the count of the boolean mask."""
    with waiting(), span("wait.masked"):
        return t[mask]
