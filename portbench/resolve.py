"""Finds a cell's pieces by name.

`BENCHMARK.json` (at the root of the checkout) names the cells. A cell's
configuration is the file its `configs` entry names, its traffic mix is
`traffic/<traffic>.json` in this folder (its size law and content kind
`sizes/<kind>.py` and `content/<kind>.py`), and each per-layer metric is
read by `metrics/<metric name>.py` in this folder, a module with
`read(ctx)`. Adding a configuration, a mix, a cell or a metric adds
files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    layer: str = ""
    moves: str = ""
    bound: float | None = None
    workloads: list | None = None

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _metric(entry: dict) -> Metric:
    return Metric(**{k: entry[k] for k in entry
                     if k in Metric.__dataclass_fields__})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: Path) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`, with its configuration,
    its traffic mix and the metrics it reports. Raises KeyError for a
    name the file does not hold."""
    bench = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / HERE.name / "traffic"
                        / f"{w['traffic']}.json")
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in map(_metric, bench["end_to_end"])
                    if m.applies(name)],
        per_layer=[m for m in map(_metric, bench["per_layer"])
                   if m.applies(name)])


def module(folder: str, name: str, root: Path):
    """The module `<folder>/<name>.py` of this folder under `root`."""
    path = root / HERE.name / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder}/{name}.py in {root / HERE.name}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    loaded = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loaded)
    return loaded


def reader(metric: str, root: Path):
    """The `read(ctx)` function of `metrics/<metric>.py`."""
    return module("metrics", metric, root).read
