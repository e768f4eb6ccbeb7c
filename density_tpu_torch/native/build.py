"""Build the port's native host runtime (`libdensity.cpp`).

`g++` compiles it into a shared library under the git-ignored
`density_tpu_torch/build/`, named by a digest of the source and the
flags, at first use. The build writes a temporary file and `os.replace`s
it into place, so processes that build at the same time (test workers)
never load a half-written library and never write next to the source.
No `-march=native`: the name does not record the host, so a cached
library must run on any x86-64 machine that finds it.

    python3 -m density_tpu_torch.native.build   # prints the library path
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parent / "libdensity.cpp"
BUILD_DIR = SRC.parent.parent / "build"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libdensity-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The library's path, compiled first if it is missing. Raises
    `subprocess.CalledProcessError` (or `OSError` without `g++`) when
    the build fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libdensity-", suffix=".so",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, "-o", tmp, str(SRC)], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


if __name__ == "__main__":
    print(build())
