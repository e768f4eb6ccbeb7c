"""The comparison that decides `correct`: sound runs pass; the control
and each fault the cells can have, planted under the timed path, fail.
The harness's look for a card is skipped: these runs take the program's
CPU path at a small size."""

import time

import pytest

from portbench_tiny import tiny
from portbench import check, control, faults, harness
from portbench.faults import (answer_altered, exchange_left_out,
                              half_left_out, state_unchanged, token_altered)


def run(cell, device="cpu", seed=11, seconds=1.0):
    m = harness.measure(cell, seed, seconds, False, time.perf_counter(),
                        device)
    harness.judge(m, seed)
    return m.numbers


@pytest.mark.parametrize("workload", ["chameleon-256k.bulk",
                                      "lion-256k.bulk",
                                      "chameleon-256k.objects"])
def test_a_sound_run_is_correct(workload):
    numbers = run(tiny(workload))
    assert check.correct(numbers), numbers


def test_a_sound_run_in_shares_is_correct():
    """A call in four shares, the program's path over a device list."""
    numbers = run(tiny("chameleon-256k.bulk"), device=["cpu"] * 4)
    assert check.correct(numbers), numbers


def test_the_control_is_not_correct():
    cell = tiny("chameleon-256k.bulk")
    numbers, ok = control.reading(control.control_cell(cell), cell, 11, 1.0,
                                  "cpu")
    assert not ok and numbers["container_bytes_wrong"][0] > 0
    assert numbers["roundtrip_bytes_wrong"][0] == 0  # lossless all the same


@pytest.mark.parametrize("fault,workload,device", [
    (half_left_out, "chameleon-256k.bulk", "cpu"),
    (half_left_out, "lion-256k.bulk", "cpu"),
    (token_altered, "chameleon-256k.bulk", "cpu"),
    (token_altered, "chameleon-256k.objects", "cpu"),
    (answer_altered, "chameleon-256k.bulk", "cpu"),
    (state_unchanged, "chameleon-256k.bulk", "cpu"),
    (exchange_left_out, "chameleon-256k.bulk", ["cpu"] * 4),
], ids=lambda v: getattr(v, "__name__", None) or str(v)[:20])
def test_a_fault_under_the_timed_path_is_not_correct(fault, workload, device,
                                                     monkeypatch):
    from density_tpu_torch.parallel import sharding
    cell = tiny(workload)
    # the warm-up's own check of the round trip would catch some faults
    # first: leave it out, so the window and the check meet them
    monkeypatch.setattr(harness, "warm", lambda system, objs: None)
    with fault(sharding):
        numbers = run(cell, device)
    assert not check.correct(numbers), numbers


def test_a_fault_in_one_stream_of_the_whole_object_is_caught(monkeypatch):
    """One stream past the first altered where the encode produces it,
    with no stream sampled beside the whole object: the whole object's
    streams meet it."""
    from density_tpu_torch.parallel import sharding
    monkeypatch.setattr(harness, "warm", lambda system, objs: None)
    cell = tiny("chameleon-256k.bulk", nbytes=60_001, distinct=1)
    cell.traffic = dict(cell.traffic, check={
        "whole_objects": 1, "reference_streams": 0, "outputs": 1})
    orig = sharding._encode_batch_to_parts
    monkeypatch.setattr(sharding, "_encode_batch_to_parts", lambda *a: [
        faults.flip(p) if i == 5 else p for i, p in enumerate(orig(*a))])
    numbers = run(cell)
    assert numbers["container_bytes_wrong"][0] > 0, numbers


def test_every_stream_of_the_whole_objects_is_sampled():
    import numpy as np
    objs = [b"x" * 10_000, b"y" * 30_000, b"z" * 5_000]
    counts = {0: 3, 1: 8, 2: 2}  # streams of 4096 bytes
    drawn = set()
    for seed in range(8):
        picks = check.sample_streams(objs, [0, 1, 2], 4096, 1, 0,
                                     np.random.default_rng(seed))
        whole = [o for o in counts if {s for p, s in picks if p == o}
                 == set(range(counts[o]))]
        assert whole
        # the whole object, and the longest object's last stream
        assert len(picks) == counts[whole[0]] + (whole[0] != 1)
        drawn.add(whole[0])
    assert len(drawn) > 1  # drawn from the seed


def test_bytes_wrong_counts_bytes_and_length():
    assert check.bytes_wrong(b"abcd", b"abcd") == 0
    assert check.bytes_wrong(b"abXd", b"abcd") == 1
    assert check.bytes_wrong(b"abc", b"abcd") == 1
