"""BENCHMARK.json against the rules of its format, and every cell's
pieces found by name, also for a cell added as files alone."""

import hashlib
import json
import re
import shutil

import time

import pytest

from portbench_tiny import ROOT
from portbench import check, harness, objects, resolve

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    for kind in ("config", "workload", "end_to_end", "per_layer"):
        for entry in BENCH[kind + "s" if kind in ("config", "workload")
                           else kind]:
            assert set(entry) <= KEYS[kind], entry


def test_names_and_units_use_allowed_characters():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert len(names) == len(set(names))


def test_text_fields_are_single_lines():
    for c in BENCH["configs"]:
        assert line(c["source"]) and line(c["why"])
    for w in BENCH["workloads"]:
        assert line(w["why"])
    for m in BENCH["per_layer"]:
        assert line(m["layer"])
    assert all(line(word) for word in BENCH["command"])


def test_bounds_and_sources():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in names
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= cells


def test_files_lie_under_paths():
    paths = [ROOT / p for p in BENCH["paths"]]
    for c in BENCH["configs"]:
        f = (ROOT / c["file"]).resolve()
        assert any(p.resolve() in f.parents for p in paths), f
    for word in BENCH["command"][1:]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(workload):
    cell = resolve.cell(workload, ROOT)
    assert cell.config["codec"] in ("chameleon", "cheetah", "lion")
    assert cell.traffic["loop"] == "closed"
    assert {m.name for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(resolve.reader(m.name, ROOT))
        assert m.moves in {e.name for e in cell.end_to_end}


def digest(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_added_as_files_alone(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path / "portbench")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    # a configuration, a mix and a metric, each a new file, and entries
    (tmp_path / "portbench/configs/cheetah-64k.json").write_text(json.dumps(
        {"codec": "cheetah", "stream_size": 65536, "device": "cuda:0"}))
    (tmp_path / "portbench/traffic/pairs.json").write_text(json.dumps(
        {"loop": "closed", "distinct": 2, "content_seed": 1,
         "check": {"whole_objects": 1, "reference_streams": 2, "outputs": 2},
         "object_bytes": {"kind": "fixed", "bytes": 1 << 20},
         "content": {"kind": "stdlib_text"}}))
    (tmp_path / "portbench/metrics/calls.compress.py").write_text(
        "def read(ctx):\n    return ctx.halves['compress'].calls\n")
    bench["configs"].append({"name": "cheetah-64k", "source": "s",
                             "file": "portbench/configs/cheetah-64k.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "cheetah-64k.pairs",
                               "config": "cheetah-64k", "traffic": "pairs",
                               "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "calls.compress", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "container", "moves": "compress_GBps",
                               "workloads": ["cheetah-64k.pairs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digest(tmp_path / "portbench")
    assert all(after[k] == v for k, v in before.items())  # nothing edited
    cell = resolve.cell("cheetah-64k.pairs", tmp_path)
    assert cell.config["stream_size"] == 65536
    assert cell.traffic["object_bytes"]["bytes"] == 1 << 20
    assert [m.name for m in cell.per_layer] == ["calls.compress"]
    read = resolve.reader("calls.compress", tmp_path)

    class Half:
        calls = 7
    assert read(type("Ctx", (), {"halves": {"compress": Half}})) == 7
    # the old cells resolve as before
    assert resolve.cell("chameleon-256k.bulk", tmp_path).config == \
        resolve.cell("chameleon-256k.bulk", ROOT).config


def copy_of_the_benchmark(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return digest(tmp_path / "portbench")


def add_cell(tmp_path, name: str, traffic: str) -> None:
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": "chameleon-256k",
                               "traffic": traffic, "chips": 1, "why": "w"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))


def run_small(cell, root, monkeypatch):
    """The cell at a small size on the program's CPU path, its pieces
    found under `root`."""
    monkeypatch.setattr(harness, "ROOT", root)
    cell.config = dict(cell.config, stream_size=4096)
    m = harness.measure(cell, 2**31 + 3, 0.5, False, time.perf_counter(),
                        "cpu")
    harness.judge(m, 2**31 + 3)
    return m


def test_a_random_bytes_mix_added_as_a_data_file_alone(tmp_path, monkeypatch):
    """Incompressible input, the codecs' copy mode: a mix of the content
    kinds already there is one data file and a cell entry."""
    before = copy_of_the_benchmark(tmp_path)
    (tmp_path / "portbench/traffic/noise.json").write_text(json.dumps(
        {"loop": "closed", "distinct": 3, "content_seed": 5,
         "object_bytes": {"kind": "fixed", "bytes": 20_003},
         "content": {"kind": "quads"},
         "check": {"whole_objects": 1, "reference_streams": 2,
                   "outputs": 3}}))
    add_cell(tmp_path, "chameleon-256k.noise", "noise")
    after = digest(tmp_path / "portbench")
    assert all(after[k] == v for k, v in before.items())  # nothing edited
    m = run_small(resolve.cell("chameleon-256k.noise", tmp_path), tmp_path,
                  monkeypatch)
    assert check.correct(m.numbers), m.numbers
    blob = next(b for _, b in m.containers if b is not None)
    assert len(blob) > 20_003  # stored, not compressed


def test_a_content_kind_added_as_a_file_alone(tmp_path, monkeypatch):
    """A content kind the folder does not have is one new file in
    `content/`, found by the name a mix gives it."""
    before = copy_of_the_benchmark(tmp_path)
    (tmp_path / "portbench/content/zeros.py").write_text(
        "def make(spec, sizes, rng):\n"
        "    return [bytes(n) for n in sizes]\n")
    (tmp_path / "portbench/traffic/zeros.json").write_text(json.dumps(
        {"loop": "closed", "distinct": 2, "content_seed": 5,
         "object_bytes": {"kind": "fixed", "bytes": 9_000},
         "content": {"kind": "zeros"},
         "check": {"whole_objects": 1, "reference_streams": 2,
                   "outputs": 2}}))
    add_cell(tmp_path, "chameleon-256k.zeros", "zeros")
    after = digest(tmp_path / "portbench")
    assert all(after[k] == v for k, v in before.items())
    cell = resolve.cell("chameleon-256k.zeros", tmp_path)
    assert objects.make(cell.traffic, cell.config, 1, tmp_path)[0] == [
        bytes(9_000)] * 2
    m = run_small(cell, tmp_path, monkeypatch)
    assert check.correct(m.numbers), m.numbers
