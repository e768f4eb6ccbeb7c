"""The plain reference against the program's CPU path, and what the
reference and the harness load."""

import subprocess
import sys

import numpy as np
import pytest

from portbench_tiny import ROOT
from portbench.reference import density


def inputs():
    from portbench import resolve
    text_kind = resolve.module("content", "stdlib_text", ROOT)
    rng = np.random.default_rng(3)
    text = text_kind.text_object(text_kind.stdlib_sources(), 40_003, rng)
    noise = rng.integers(0, 256, 9000, dtype=np.uint8).tobytes()
    return {"text": text, "mixed": text[:15_000] + noise + text[15_000:]}


@pytest.mark.parametrize("codec", ["chameleon", "cheetah", "lion"])
@pytest.mark.parametrize("which", ["text", "mixed"])
def test_reference_equals_the_program_on_the_cpu(codec, which):
    from density_tpu_torch import container
    data = inputs()[which]
    got = container.compress(data, codec, 8192, device="cpu")
    assert got == density.compress(data, codec, 8192)
    assert container.decompress(got, device="cpu") == data


def loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(out.stdout.split())


def test_the_reference_loads_nothing_of_the_program():
    names = loaded("import portbench.check, portbench.reference.density")
    assert not names & {"density_tpu_torch", "density_tpu", "jax", "torch"}


def test_a_run_loads_no_jax_and_not_the_jax_package():
    names = loaded(
        "import sys, time\n"
        "sys.path.insert(0, 'portbench/tests')\n"
        "from portbench_tiny import tiny\n"
        "from portbench import harness\n"
        "cell = tiny('chameleon-256k.bulk', nbytes=9000)\n"
        "m = harness.measure(cell, 5, 0.5, False, time.perf_counter(),"
        " 'cpu')\n"
        "harness.judge(m, 5)\n"
        "assert harness.check.correct(m.numbers), m.numbers\n"
        "assert not harness.forbidden_modules()")
    assert "density_tpu_torch" in names  # the program ran ...
    assert not names & {"jax", "jaxlib", "flax", "density_tpu"}  # ... alone


def test_a_reader_that_loads_the_jax_package_stops_the_result(
        tmp_path, monkeypatch, capsys):
    """The look for JAX and the JAX package comes last: a per-layer
    reader or the check that loads one, after the window, still leaves
    the run without a result."""
    import time
    from portbench import harness, resolve
    from portbench_tiny import tiny
    for name in harness.FORBIDDEN:  # a test process may hold them already
        monkeypatch.delitem(sys.modules, name, raising=False)
    cell = tiny("chameleon-256k.bulk", nbytes=9000)
    cell.per_layer = [resolve.Metric(name="loads", unit="n", better="lower",
                                     source="program_counter")]
    (tmp_path / "portbench" / "metrics").mkdir(parents=True)
    (tmp_path / "portbench" / "metrics" / "loads.py").write_text(
        "import sys, types\n"
        "def read(ctx):\n"
        "    sys.modules['density_tpu'] = types.ModuleType('density_tpu')\n"
        "    return 1.0\n")
    m = harness.measure(cell, 5, 0.5, False, time.perf_counter(), "cpu")
    assert not harness.loaded_forbidden()  # the early look finds nothing
    monkeypatch.setattr(harness, "ROOT", tmp_path)  # the reader's folder
    rc = harness.finish(m, True, 5, {"platform": "cpu"})
    sys.modules.pop("density_tpu")
    out, err = capsys.readouterr()
    assert rc != 0
    assert not any(line.startswith("{") for line in out.splitlines())
    assert "density_tpu" in err.splitlines()[-1]
    # the same run without the reader prints its result
    cell.per_layer = []
    assert harness.finish(m, True, 5, {"platform": "cpu"}) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith('{"correct"')
