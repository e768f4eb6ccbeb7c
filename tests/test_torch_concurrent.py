"""Shares that run at the same time, one worker thread each, on the CPU.

Over a list of several devices, compress and decompress run every share
(and the ragged tail's batch) as a task of its own worker
(`mesh.run_shares`); with one device they run in turn in the caller's
thread. `device=["cpu"] * k` stands for k devices. The tests hold:
- concurrency: each share's task waits on a `threading.Barrier` of all
  the tasks before it works (as a wait for the card, which hands the
  host to the next worker), which only tasks that run at once pass
  (tasks in turn would break the barrier at its timeout and fail); the
  workers take turns at the host outside such waits, and a share's task
  waits for its card only through `hostsync`, which hands the turn on;
- bytes: containers in 1-4 shares, with a ragged tail and an empty
  share, equal the JAX package's (one case a codec, computed once in a
  module fixture) and the port's one-device container;
- faults: a failing share raises its EncodeError or DecodeError after
  every worker is joined, the first share's where several fail;
- thread safety of what the workers share: packroute's epochs, the
  launch counters and the library loads, under threads and a short
  switch interval.
Inputs come from numpy seeds; every comparison is exact.
"""

import ctypes
import sys
import threading
import traceback

import numpy as np
import pytest
import torch

from density_tpu import container as jcontainer
from density_tpu_torch import container as pcontainer
from density_tpu_torch import hostsync
from density_tpu_torch import native as pnative
from density_tpu_torch.errors import DecodeError, EncodeError
from density_tpu_torch.kernels import (
    _build, bigsort, bitonic, fsm, mtf, pack, packroute, unpack)
from density_tpu_torch.native import build as native_build
from density_tpu_torch.parallel import mesh, sharding
from tests.test_torch_cheetah import _alphabet, _mixed, _text

torch.set_num_threads(1)

CODECS = ("chameleon", "cheetah", "lion")
STREAM = 4096
TIMEOUT = 60  # seconds a barrier or a join waits before the test fails


def _input(codec: str, n_full: int = 3, tail: int = 3700) -> bytes:
    """n_full streams and a tail: with 3 and 4 devices a share is left
    empty; a tail of 3700 bytes stages at the streams' capacity, so the
    JAX package's lion encode compiles once."""
    rng = np.random.default_rng(n_full * 100 + tail)
    n = n_full * STREAM + tail
    if codec == "chameleon":
        return _alphabet(rng, n // 4 + 1)[:n]
    if codec == "cheetah":
        return _mixed(rng, n)
    return _text(rng, n)


@pytest.fixture(scope="module")
def jax_blobs():
    return {c: jcontainer.compress(_input(c), c, STREAM) for c in CODECS}


def _barrier_tasks(monkeypatch, name: str, parties: int):
    """Wraps `sharding.<name>`, a share's task, so that it waits on a
    barrier of `parties` tasks first, as it waits for its card (the
    host's turn goes to another worker meanwhile); returns the threads
    that ran it."""
    barrier = threading.Barrier(parties, timeout=TIMEOUT)
    task = getattr(sharding, name)
    ran = []

    def waiting(*args, **kwargs):
        ran.append(threading.current_thread())
        with hostsync.waiting():
            barrier.wait()
        return task(*args, **kwargs)
    monkeypatch.setattr(sharding, name, waiting)
    return ran


@pytest.mark.parametrize("tail", [0, 1000])
@pytest.mark.parametrize("k", [2, 3])
def test_compress_shares_run_at_once(monkeypatch, k, tail):
    """k shares of 2 streams, and the tail's batch as one more task."""
    data = _input("chameleon", 2 * k, tail)
    want = pcontainer.compress(data, "chameleon", STREAM, device="cpu")
    ran = _barrier_tasks(monkeypatch, "_encode_batch_to_parts",
                         k + (tail > 0))
    assert pcontainer.compress(data, "chameleon", STREAM,
                               device=["cpu"] * k) == want
    assert len(set(ran)) == k + (tail > 0)
    assert threading.current_thread() not in ran


def test_traced_shares_run_at_once(monkeypatch):
    """Under a profiler session the shares run at once on the same
    workers as without one, and each worker's task is its span."""
    k = 3
    data = _input("chameleon", 2 * k, 1000)
    want = pcontainer.compress(data, "chameleon", STREAM, device="cpu")
    ran = _barrier_tasks(monkeypatch, "_encode_batch_to_parts", k + 1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = pcontainer.compress(data, "chameleon", STREAM,
                                  device=["cpu"] * k)
    assert got == want
    assert len(set(ran)) == k + 1
    assert threading.current_thread() not in ran
    shares = [e for e in prof.events()
              if e.name == "density.sharding.share"]
    assert len(shares) == k + 1
    assert len({e.thread for e in shares}) == k + 1


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("codec", ["chameleon", "cheetah", "lion"])
def test_decompress_shares_run_at_once(monkeypatch, codec, k):
    """Every share decoded at once on the device route (cheetah and lion
    with the cutoff raised: their rounds read the host each round)."""
    data = _input(codec, 2 * k - 1, 1000)  # k shares of 2, the last ragged
    blob = pcontainer.compress(data, codec, STREAM, device="cpu")
    monkeypatch.setattr(sharding, "PREDICTED_DEVICE_CUTOFF", 1.0)
    ran = _barrier_tasks(monkeypatch, "_decode_share", k)
    assert pcontainer.decompress(blob, device=["cpu"] * k) == data
    assert len(set(ran)) == k
    ran.clear()
    parts = sharding._streams(blob)[2]
    chunks = [data[i:i + STREAM] for i in range(0, len(data), STREAM)]
    assert sharding.decode_streams(parts, None, ["cpu"] * k, codec) == chunks
    assert len(set(ran)) == k


@pytest.mark.parametrize("codec", CODECS)
def test_shares_match_jax(jax_blobs, codec):
    """4 shares over 3 streams (the last empty) and the tail's task."""
    data = _input(codec)
    blob = pcontainer.compress(data, codec, STREAM, device=["cpu"] * 4)
    assert blob == jax_blobs[codec]
    assert pcontainer.decompress(blob, device=["cpu"] * 4) == data


@pytest.mark.parametrize("n_full,tail", [(5, 1000), (4, 0), (1, 7)])
@pytest.mark.parametrize("codec", CODECS)
def test_shares_match_one_device(codec, n_full, tail):
    data = _input(codec, n_full, tail)
    one = pcontainer.compress(data, codec, STREAM, device="cpu")
    for k in (1, 2, 3, 4):
        devs = ["cpu"] * k
        assert pcontainer.compress(data, codec, STREAM, device=devs) == one
        assert pcontainer.decompress(one, device=devs) == data


def test_one_device_starts_no_worker(monkeypatch):
    """One device: its batches (the share and the tail) run in turn in
    the caller's thread, and no worker is started."""
    data = _input("chameleon", 3, 1000)
    for device in ("cpu", ["cpu"]):
        ran = _barrier_tasks(monkeypatch, "_encode_batch_to_parts", 1)
        started = []
        run_at_once = mesh.run_at_once

        def spy(fns):
            started.append(len(fns))
            return run_at_once(fns)
        monkeypatch.setattr(mesh, "run_at_once", spy)
        pcontainer.compress(data, "chameleon", STREAM, device=device)
        monkeypatch.undo()
        assert ran == [threading.current_thread()] * 2
        assert started == []


def _fail_shares(monkeypatch, name: str, fail: dict, first_share_arg):
    """Wraps `sharding.<name>` so that the shares in `fail` (share index
    -> exception) raise; share 1 raises before share 0 does."""
    task = getattr(sharding, name)
    share1_failed = threading.Event()

    def failing(*args):
        i = first_share_arg(args)
        if i in fail:
            if i == 0:
                with hostsync.waiting():
                    share1_failed.wait(TIMEOUT)
            try:
                raise fail[i]
            finally:
                if i == 1:
                    share1_failed.set()
        return task(*args)
    monkeypatch.setattr(sharding, name, failing)


@pytest.mark.parametrize("failing", [[1], [0, 1]])
def test_compress_fault_joins_every_worker(monkeypatch, failing):
    data = _input("chameleon", 6, 1000)
    errors = {i: EncodeError(f"share {i} failed") for i in failing}
    # the task's offset argument names its share (2 streams a share)
    _fail_shares(monkeypatch, "_encode_batch_to_parts", errors,
                 lambda args: args[2] // (2 * STREAM))
    before = threading.active_count()
    with pytest.raises(EncodeError, match=f"share {failing[0]} failed"):
        pcontainer.compress(data, "chameleon", STREAM, device=["cpu"] * 3)
    assert threading.active_count() == before


@pytest.mark.parametrize("failing", [[1], [0, 1]])
def test_decompress_fault_joins_every_worker(monkeypatch, failing):
    data = _input("lion", 5, 1000)
    blob = pcontainer.compress(data, "lion", STREAM, device="cpu")
    monkeypatch.setattr(sharding, "PREDICTED_DEVICE_CUTOFF", 1.0)
    errors = {i: DecodeError(f"share {i} failed") for i in failing}
    # the task's first stream names its share (2 streams a share)
    _fail_shares(monkeypatch, "_decode_share", errors,
                 lambda args: args[6] // 2)
    before = threading.active_count()
    with pytest.raises(DecodeError, match=f"share {failing[0]} failed"):
        pcontainer.decompress(blob, device=["cpu"] * 3)
    assert threading.active_count() == before


def test_run_shares_orders_results_and_raises_the_first():
    devs = [torch.device("cpu")] * 3
    tasks = [(d, lambda i=i: i * i) for i, d in enumerate(devs)]
    assert mesh.run_shares(devs, tasks) == [0, 1, 4]
    assert mesh.run_shares(devs[:1], tasks[:2]) == [0, 1]
    assert mesh.run_shares(devs, []) == []

    def fail(what):
        raise ValueError(what)
    before = threading.active_count()
    with pytest.raises(ValueError, match="second"):
        mesh.run_shares(devs, [tasks[0], (devs[1], lambda: fail("second")),
                               (devs[2], lambda: fail("third"))])
    assert threading.active_count() == before


def test_workers_take_turns_at_the_host():
    """Outside a wait (`hostsync.waiting`) one worker runs at a time; inside
    it the others run, and every worker reaches the barrier; outside a
    worker `waiting` does nothing."""
    k = 3
    devs = [torch.device("cpu")] * k
    barrier = threading.Barrier(k, timeout=TIMEOUT)
    running, most = [0], [0]

    def task():
        for _ in range(2):
            running[0] += 1
            most[0] = max(most[0], running[0])
            for _ in range(20000):  # Python work: the lock is traded
                pass
            running[0] -= 1
            with hostsync.waiting():
                barrier.wait()
        return threading.current_thread()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ran = mesh.run_shares(devs, [(d, task) for d in devs])
    finally:
        sys.setswitchinterval(interval)
    assert most == [1] and len(set(ran)) == k
    with hostsync.waiting():  # the caller's thread holds no turn
        assert not hostsync._turn.locked()


# Tensor methods that wait for the card when the tensor lies on one: a
# copy to the host, a Python number or truth value, an index, the ops
# whose output size depends on the data; indexing by a boolean mask; and
# the functions that make a host array a tensor, which a share's task
# calls only to copy it onto its card.
WAIT_METHODS = ("cpu", "numpy", "item", "tolist", "__bool__", "__int__",
                "__float__", "__index__", "nonzero", "masked_select",
                "unique")
INDEXING = ("__getitem__", "__setitem__")
WAIT_FUNCTIONS = ("nonzero", "masked_select", "unique", "from_numpy",
                  "tensor", "as_tensor")


def _by_mask(args) -> bool:
    """Whether `Tensor.__getitem__`/`__setitem__` arguments index by a
    boolean mask."""
    key = args[1] if isinstance(args[1], tuple) else (args[1],)
    return any(isinstance(k, torch.Tensor) and k.dtype == torch.bool
               for k in key)


def _site() -> str | None:
    """The innermost line of the port in the caller's stack; None inside
    a kernel's plain version, which a card replaces with its kernel."""
    stack = traceback.extract_stack()
    if any("kernels" in f.filename and f.name.endswith("plain")
           for f in stack):
        return None
    for f in reversed(stack):
        if "density_tpu_torch" in f.filename:
            return f"{f.filename.split('density_tpu_torch')[-1]}:{f.lineno}"
    return "outside the port"


@pytest.mark.parametrize("codec", CODECS)
def test_share_tasks_wait_for_the_card_only_through_hostsync(monkeypatch,
                                                             codec):
    """No call that waits for the card on a card runs while a worker
    holds the host's turn (it would keep every other worker from the
    host while it blocks): a share's task reads the card, and copies onto
    it, only through `hostsync.read`, `to_card` and `waiting`, which hand
    the turn on. Compress, and decompress on the device route, in 2 and 3
    shares with a tail."""
    held = []

    def spy(owner, name, waits=lambda args: True):
        fn = getattr(owner, name)

        def call(*args, **kwargs):
            if hostsync.holds_turn() and waits(args) and _site():
                held.append((name, _site()))
            return fn(*args, **kwargs)
        monkeypatch.setattr(owner, name, call)
    data = _input(codec, 5, 1000)
    monkeypatch.setattr(sharding, "PREDICTED_DEVICE_CUTOFF", 1.0)
    for name in WAIT_METHODS:
        spy(torch.Tensor, name)
    for name in INDEXING:
        spy(torch.Tensor, name, _by_mask)
    for name in WAIT_FUNCTIONS:
        spy(torch, name)
    for k in (2, 3):
        blob = pcontainer.compress(data, codec, STREAM, device=["cpu"] * k)
        assert pcontainer.decompress(blob, device=["cpu"] * k) == data
    monkeypatch.undo()
    assert sorted(set(held)) == []


def _stress(fn, threads: int = 8, calls: int = 1000) -> list:
    """`fn(thread, call)` from `threads` threads at once, `calls` calls
    each, under a short switch interval; returns every result."""
    out = [[] for _ in range(threads)]
    start = threading.Barrier(threads, timeout=TIMEOUT)

    def run(t):
        start.wait()
        out[t] += [fn(t, c) for c in range(calls)]
    workers = [threading.Thread(target=run, args=(t,))
               for t in range(threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for w in workers:
            w.start()
        for w in workers:
            w.join(TIMEOUT)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    return [r for rs in out for r in rs]


def test_packroute_epochs_never_repeat(monkeypatch):
    """8 threads x 1000 calls take 8000 distinct epochs, and each (device,
    stream) keeps one buffer; the counter wraps to 1 past 2^31 - 1 and
    then drops every buffer."""
    monkeypatch.setattr(packroute, "_epoch", 0)
    monkeypatch.setattr(packroute, "_tagged", {})
    cpu = torch.device("cpu")
    got = _stress(lambda t, c: packroute._next_epoch(cpu, t, 2))
    epochs = [e for e, _ in got]
    assert sorted(epochs) == list(range(1, 8001))
    assert len(packroute._tagged) == 8
    bufs = {id(b) for _, b in got}
    assert len(bufs) == 8
    assert all(b.numel() == packroute.MAX_K * 64 and not b.any()
               for _, b in got)
    # growing: a buffer too small for S streams is replaced
    _, b = packroute._next_epoch(cpu, 0, 100)
    assert b.numel() == packroute.MAX_K * 100
    assert packroute._next_epoch(cpu, 0, 100)[1] is b
    packroute._epoch = 2**31 - 2
    assert packroute._next_epoch(cpu, 0, 2)[0] == 2**31 - 1
    assert packroute._next_epoch(cpu, 0, 2)[0] == 1
    assert list(packroute._tagged) == [(None, 0)]


@pytest.mark.parametrize("module", [bigsort, packroute, unpack, pack,
                                    bitonic, mtf, fsm])
def test_launch_counts_are_exact_under_threads(monkeypatch, module):
    monkeypatch.setattr(module, "launches", 0)
    _stress(lambda t, c: _build.count_launch(vars(module)))
    assert module.launches == 8000


def _once_under_threads(load, threads: int = 4) -> list:
    """`load()` from `threads` threads at once; returns the results."""
    return _stress(lambda t, c: load(), threads=threads, calls=1)


def test_kernel_library_builds_once(monkeypatch, tmp_path):
    builds, opened = [], []
    path = tmp_path / "libfake.so"

    def fake_build(names):
        builds.append(names)
        threading.Event().wait(0.05)  # widen the window between threads
        path.write_bytes(b"")

    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "lib_path", lambda name: path)
    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda p: opened.append(p) or object())
    libs = _once_under_threads(lambda: _build.load("bigsort"))
    assert builds == [["bigsort"]] and opened == [str(path)]
    assert len({id(lib) for lib in libs}) == 1


def test_native_runtime_builds_once(monkeypatch, tmp_path):
    builds, opened = [], []

    def fake_build():
        builds.append(1)
        threading.Event().wait(0.05)  # widen the window between threads
        return tmp_path / "libdensity-fake.so"

    monkeypatch.delenv("DENSITY_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "_load_error", None)
    monkeypatch.setattr(native_build, "build", fake_build)
    monkeypatch.setattr(pnative, "_bind", lambda lib: lib)
    monkeypatch.setattr(ctypes, "CDLL",
                        lambda p: opened.append(p) or object())
    libs = _once_under_threads(pnative._load)
    assert builds == [1] and len(opened) == 1
    assert len({id(lib) for lib in libs}) == 1
