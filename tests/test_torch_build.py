"""The port's kernel build cache (density_tpu_torch.kernels._build): a
library is named by a digest of everything its source compiles with, so
an edit to a shared header under `csrc/` brings a rebuild instead of a
stale library. Runs on any machine: nothing is compiled."""

import pytest

from density_tpu_torch.kernels import _build


@pytest.fixture
def src_dir(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "levels.cuh"\n')
    (tmp_path / "b.cu").write_text("// no header\n")
    (tmp_path / "levels.cuh").write_text("// level 1\n")
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edit", [
    lambda d: (d / "levels.cuh").write_text("// level 2\n"),
    lambda d: (d / "other.cuh").write_text("// a new header\n"),
    lambda d: (d / "levels.cuh").rename(d / "renamed.cuh"),
    lambda d: (d / "a.cu").write_text('#include "levels.cuh"\n// edit\n'),
], ids=["header edited", "header added", "header renamed", "source edited"])
def test_lib_path_follows_sources_and_headers(src_dir, edit):
    before = _build.lib_path("a")
    assert _build.lib_path("a") == before  # stable while nothing changes
    edit(src_dir)
    after = _build.lib_path("a")
    assert after != before
    assert after.parent == _build.BUILD_DIR and after.name.startswith("liba-")


def test_lib_path_differs_between_sources(src_dir):
    assert _build.lib_path("a") != _build.lib_path("b")
