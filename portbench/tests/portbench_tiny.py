"""Cells of the benchmark cut to a size the CPU tests can run: the
configuration's stream size and the mix's objects made small, all else
as `BENCHMARK.json` has it."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import resolve  # noqa: E402


def tiny(name: str, stream_size: int = 4096, nbytes: int = 50_001,
         distinct: int = 4) -> resolve.Cell:
    cell = resolve.cell(name, ROOT)
    cell.config = dict(cell.config, stream_size=stream_size)
    cell.traffic = dict(
        cell.traffic, distinct=distinct,
        object_bytes={"kind": "fixed", "bytes": nbytes},
        check={"whole_objects": 1, "reference_streams": 4, "outputs": 8})
    return cell
