"""The protection FSM's step (`density_tpu_torch/kernels/fsm.py`) on the
CPU: its plain path against the JAX package's `replay_fsm_np`, masked to
real blocks, with both flags; the wrapper's argument checks; and the
fixed point of `layout.run_encode` and `stats.encode_stats`, which step
it, against the JAX package's native encoder and stats on a stream of
several passes, and at the cap of passes. Every comparison is exact;
inputs come from numpy seeds."""

import dataclasses

import numpy as np
import pytest
import torch

from density_tpu import native as jnative
from density_tpu import stats as jstats
from density_tpu.engine.protection import replay_fsm_np
from density_tpu_torch import stats as pstats
from density_tpu_torch.engine import layout
from density_tpu_torch.kernels import fsm
from tests.test_torch_gpu import (FSM_KINDS, FSM_SHAPES, _encode_counted,
                                  _fsm_inputs, _multipass)

torch.set_num_threads(1)

CODECS = ("chameleon", "cheetah", "lion")


def _max_start(row) -> int:
    """The largest copy_penalty_start the FSM reaches over `row`."""
    penalty, start, prev, top = 0, 1, False, 1
    for i, bit in enumerate(row):
        if (i & 15) == 0 and start > 1:
            start >>= 1
        if penalty > 0:
            penalty -= 1
            if penalty == 0:
                start += 1
        else:
            if bit and prev:
                penalty = start
            prev = bool(bit)
        top = max(top, start)
    return top


@pytest.mark.parametrize("kind", FSM_KINDS)
@pytest.mark.parametrize("S,nb,block", FSM_SHAPES)
def test_step_plain_matches_jax(S, nb, block, kind):
    bits, nbytes = _fsm_inputs(kind, S, nb, block, S * nb + len(kind))
    nbr = (nbytes.numpy().astype(np.int64) + block - 1) // block
    want = np.stack([replay_fsm_np(r) for r in bits.numpy()])
    want &= np.arange(nb)[None, :] < nbr[:, None]
    zeros = torch.zeros_like(bits)
    copy, flags = fsm.step(bits, nbytes, block, zeros)
    assert copy.dtype == torch.bool and copy.shape == (S, nb)
    np.testing.assert_array_equal(copy.numpy(), want)
    assert flags.dtype == torch.int32
    assert flags.tolist() == [int(want.any()), int(want.any())]
    # against itself nothing changes; one flipped real block does
    assert fsm.step(bits, nbytes, block, copy)[1].tolist() == [
        0, int(want.any())]
    flipped = copy.clone()
    flipped[-1, 0] = ~flipped[-1, 0]
    assert fsm.step(bits, nbytes, block, flipped)[1][0] == 1
    if kind in ("ones", "runs"):
        assert _max_start(bits[0].numpy()) > 2 and nb > 16


def _args():
    bits = torch.zeros((4, 64), dtype=torch.bool)
    nbytes = torch.full((4,), 64 * 64, dtype=torch.int32)
    return bits, nbytes, 64, torch.zeros_like(bits)


BAD_ARGS = {
    "bits uint8": lambda b, n, k, p: (b.to(torch.uint8), n, k, p),
    "copy set uint8": lambda b, n, k, p: (b, n, k, p.to(torch.uint8)),
    "nbytes int64": lambda b, n, k, p: (b, n.long(), k, p),
    "bits 1-d": lambda b, n, k, p: (b[0], n[:1], k, p[0]),
    "copy set shape": lambda b, n, k, p: (b, n, k, p[:, :32]),
    "nbytes shape": lambda b, n, k, p: (b, n[:3], k, p),
    "block 0": lambda b, n, k, p: (b, n, 0, p),
    "nbytes device": lambda b, n, k, p: (b, n.to("meta"), k, p),
    "copy set device": lambda b, n, k, p: (b, n, k, p.to("meta")),
    "bits strided": lambda b, n, k, p: (
        torch.zeros((4, 128), dtype=torch.bool)[:, ::2], n, k, p),
    "copy set strided": lambda b, n, k, p: (
        b, n, k, torch.zeros((64, 4), dtype=torch.bool).t()),
    "nbytes strided": lambda b, n, k, p: (
        b, torch.zeros(8, dtype=torch.int32)[::2], k, p),
}


@pytest.mark.parametrize("bad", list(BAD_ARGS))
def test_step_rejects_bad_args(bad):
    with pytest.raises(ValueError):
        fsm.step(*BAD_ARGS[bad](*_args()))
    fsm.step(*_args())  # the good arguments pass


@pytest.mark.parametrize("codec", CODECS)
def test_run_encode_fixed_point_matches_jax(codec):
    """A stream of three or more passes: `run_encode` converges with the
    JAX package's native encoder's bytes."""
    data = _multipass()
    (out, totals, converged), passes = _encode_counted(codec, data, "cpu")
    assert converged is True and passes >= 3
    total = int(totals[0])
    got = out[0, :(total + 1) // 2].numpy().astype("<u2").tobytes()[:total]
    assert got == jnative.encode(codec, data)


@pytest.mark.parametrize("codec", CODECS)
def test_run_encode_at_the_cap_does_not_converge(monkeypatch, codec):
    """Two passes of a stream that needs three or more: `run_encode`
    reports converged=False (the container then takes the native
    encoder)."""
    monkeypatch.setattr(layout, "MAX_FIXED_POINT_ITERS", 2)
    (_, _, converged), passes = _encode_counted(codec, _multipass(), "cpu")
    assert converged is False and passes == 2


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("codec", CODECS)
def test_encode_stats_fixed_point_matches_jax(monkeypatch, codec, capped):
    """`encode_stats` on the multi-pass stream gives the JAX package's
    stats of the native encoder's stream, through the device planner or,
    at a cap of two passes, through the native encoder."""
    data = _multipass()
    calls = []
    encode = pstats.native.encode
    monkeypatch.setattr(pstats.native, "encode",
                        lambda *a: calls.append(1) or encode(*a))
    if capped:
        monkeypatch.setattr(layout, "MAX_FIXED_POINT_ITERS", 2)
    got = pstats.encode_stats(codec, data, device="cpu")
    assert len(calls) == int(capped)
    want = jstats.stream_stats(codec, data, jnative.encode(codec, data))
    assert got.copy_blocks > 0
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _one_fixed_point(run):
    """`run()` with `layout.fixed_point`, `plan_masked` and `step_fsm`
    counted: (the copy set of each fixed point on the host, the calls of
    plan_masked, the calls of step_fsm)."""
    copies, counts = [], {"plan_masked": 0, "step_fsm": 0}
    with pytest.MonkeyPatch.context() as mp:
        for name in counts:
            def counted(*a, _fn=getattr(layout, name), _name=name):
                counts[_name] += 1
                return _fn(*a)
            mp.setattr(layout, name, counted)

        def fixed_point(*a, _fn=layout.fixed_point):
            got = _fn(*a)
            copies.append(got[0].cpu().numpy())
            return got
        mp.setattr(layout, "fixed_point", fixed_point)
        run()
    return copies, counts["plan_masked"], counts["step_fsm"]


def _run_encode(codec, data):
    from density_tpu_torch.parallel import sharding
    pipe = sharding.codec_module(codec).PIPELINE
    buf = np.frombuffer(data, np.uint8)
    _, _, converged = layout.run_encode(
        pipe, *layout.stage_stream(buf, pipe.BLOCK, "cpu"))
    assert converged is True


CALLERS = {
    "run_encode": _run_encode,
    "encode_stats": lambda codec, data: pstats.encode_stats(
        codec, data, device="cpu"),
}


@pytest.mark.parametrize("caller", list(CALLERS))
@pytest.mark.parametrize("codec", CODECS)
def test_one_fixed_point_counts_its_passes(codec, caller):
    """Each caller runs `layout.fixed_point` once on a stream of several
    passes: a pass is one `step_fsm`, and every pass after the first
    plans anew, so `plan_masked` runs passes - 1 times."""
    data = _multipass()
    copies, masked, passes = _one_fixed_point(
        lambda: CALLERS[caller](codec, data))
    assert len(copies) == 1 and copies[0].any()
    assert passes >= 2 and masked == passes - 1


@pytest.mark.parametrize("codec", CODECS)
def test_callers_reach_one_copy_set(codec):
    """`run_encode` and `encode_stats` reach the same copy-block set on a
    stream of several passes, in as many passes: the native encoder's
    copy blocks."""
    data = _multipass()
    got = [_one_fixed_point(lambda f=f: f(codec, data))
           for f in CALLERS.values()]
    (enc_copy,), enc_masked, enc_passes = got[0]
    (st_copy,), st_masked, st_passes = got[1]
    np.testing.assert_array_equal(enc_copy, st_copy)
    assert (enc_masked, enc_passes) == (st_masked, st_passes)
    _, _, is_copy = jnative.scan(codec, jnative.encode(codec, data))
    n_blocks = len(is_copy)
    np.testing.assert_array_equal(enc_copy[0, :n_blocks],
                                  np.asarray(is_copy, bool))
    assert not enc_copy[0, n_blocks:].any()
