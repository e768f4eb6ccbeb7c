"""The port's containers across two processes, on the CPU.

Spawns two `torch.distributed` ranks (gloo, on a free local port), as
`test_multihost.py` spawns two JAX processes. Each rank compresses and
decompresses its contiguous part of the streams; the bytes are gathered
in rank order, so every rank returns the whole container and the whole
data. Each rank's container must equal the single-process one: for
chameleon (`test_multihost.py`'s input) also the JAX package's; for
cheetah and lion the port's own, which the other test files hold
against the JAX package. Cheetah and lion decompress on both routes.
Each rank has a timeout of its own, and a failure kills both.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180  # seconds, for each rank

_WORKER = r"""
import os, sys
rank, port, outdir, codec = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                             sys.argv[4])
import torch
torch.set_num_threads(1)
from density_tpu_torch import container
from density_tpu_torch.parallel import mesh, sharding
from tests.test_torch_multihost import STREAM, _input
mesh.distributed_init(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
assert mesh.process_count() == 2 and mesh.process_index() == rank
data = _input(codec)
blob = container.compress(data, codec, STREAM, device="cpu")
if os.environ.get("BAD_STREAM"):  # a malformed block in one rank's part
    from density_tpu_torch import native
    from density_tpu_torch.errors import DecodeError
    scan = native.scan_many
    bad = int(os.environ["BAD_STREAM"])
    def bad_scan(codec, streams, max_blocks):
        bio, *rest = scan(codec, streams, max_blocks)
        bio[bad, 3] = 2 * (max(len(s) for s in streams) + 100)
        return (bio, *rest)
    native.scan_many = bad_scan
    try:
        container.decompress(blob, device="cpu")
        blob = b"no error"
    except DecodeError as e:
        blob = str(e).encode()
else:
    assert container.decompress(blob, device="cpu") == data
    if codec != "chameleon":  # the other route gives the same bytes
        sharding.PREDICTED_DEVICE_CUTOFF = (
            -1.0 if sharding.PREDICTED_DEVICE_CUTOFF > 0 else 0.02)
        assert container.decompress(blob, device="cpu") == data
with open(os.path.join(outdir, f"blob{rank}"), "wb") as f:
    f.write(blob)
torch.distributed.destroy_process_group()
"""

STREAM = 1 << 12


def _input(codec: str) -> bytes:
    """`test_multihost.py`'s input for chameleon; for cheetah and lion
    seeded text with random runs (copy blocks), 7 full streams and a
    tail."""
    if codec == "chameleon":
        return (b"multihost ordered gather determinism check " * 700)[:30000]
    rng = np.random.default_rng(5)
    words = [b"the quick brown fox ", b"jumps over ", b"lazy dog ",
             b"density ", b"lion\n"]
    text = b"".join(words[i] for i in rng.integers(0, 5, 8000))
    rand = rng.integers(0, 256, 30000, dtype=np.uint8).tobytes()
    return b"".join(text[i:i + 5000] + rand[i:i + 1000]
                    for i in range(0, 30000, 6000))[:30000]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_ranks(codec, outdir, **extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(rank), port, str(outdir), codec],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for rank in range(2)]
    try:
        for rank, p in enumerate(procs):
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"rank {rank}: {err.decode()[-2000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(outdir / f"blob{rank}").read_bytes() for rank in range(2)]


@pytest.mark.parametrize("codec", ["chameleon", "cheetah", "lion"])
def test_two_process_container_matches_single(tmp_path, codec):
    from density_tpu_torch import container
    blob0, blob1 = _run_ranks(codec, tmp_path)
    assert blob0 == blob1, "every rank assembles the same container"
    data = _input(codec)
    assert blob0 == container.compress(data, codec, STREAM, device="cpu")
    assert container.decompress(blob0, device="cpu") == data
    if codec == "chameleon":
        from density_tpu import container as jcontainer
        assert blob0 == jcontainer.compress(data, codec, stream_size=STREAM)


def test_a_fault_in_one_rank_raises_on_both(tmp_path):
    """A malformed block in rank 0's part (the scan is rewritten: no
    valid stream makes one) raises DecodeError on rank 0 in its decode,
    and on rank 1 at the gather, which rank 0 still reaches: neither
    waits for the other."""
    got = _run_ranks("chameleon", tmp_path, BAD_STREAM="1")
    assert got[0].startswith(b"malformed block offset")
    assert got[1] == b"rank 0 failed: DecodeError: " + got[0]
