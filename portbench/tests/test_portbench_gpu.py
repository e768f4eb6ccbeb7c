"""On the card: one short run of the main cell from the command line is
correct and prints its result line; the control at the cell's size is
not correct. Skips without a card."""

import json
import subprocess
import sys

import pytest

from portbench_tiny import ROOT
from portbench import control, resolve


def need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    need_card()
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "chameleon-256k.bulk", "--seed", str(2**31 + 7), "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "compress_GBps",
                                      "decompress_GBps"}
    assert result["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_the_control_fails_on_the_card():
    need_card()
    cell = resolve.cell("chameleon-256k.bulk", ROOT)
    numbers, ok = control.reading(control.control_cell(cell), cell, 3, 2.0)
    assert not ok and numbers["container_bytes_wrong"][0] > 0
