"""Build and load the port's CUDA kernels.

Each source under `density_tpu_torch/csrc/` is compiled by `nvcc` into
its own shared library with a plain C interface and loaded with ctypes
(no PyTorch headers, so a build takes seconds). Libraries go to
`density_tpu_torch/build/` (git-ignored), named by a digest of the
source, every header under `csrc/` (`*.cuh`) and the flags, and are
built at first use. Each build writes a temporary file and
`os.replace`s it into place, so processes that build at the same time
never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
KERNELS = ("bigsort", "packroute", "unpack", "pack", "bitonic")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def lib_path(name: str) -> Path:
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for hdr in sorted(SRC_DIR.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every missing library of `names`, one `nvcc` per source,
    all started together. Returns each new build's compiler output
    (register and shared-memory use from `-Xptxas -v`)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so",
                                   dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
        jobs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for name, (out, tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            os.unlink(tmp)
            failed.append(f"{name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def function(lib_name: str, fn_name: str, n_args: int, int_args):
    """The C entry point `fn_name` with its ctypes signature: pointers
    (and the stream) as c_void_p, the argument positions in `int_args`
    as c_int; it returns the CUDA error code."""
    fn = getattr(load(lib_name), fn_name)
    fn.argtypes = [ctypes.c_int if i in int_args else ctypes.c_void_p
                   for i in range(n_args)]
    fn.restype = ctypes.c_int
    return fn


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on `device`, for a kernel launch."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch(fn, what: str, device, *args) -> None:
    """Calls the C entry point `fn(*args, stream)` on PyTorch's current
    stream of `device`, with `device` made current for the call: the
    CUDA runtime launches on the current device, and a kernel's
    attributes and occupancy are the current device's. Raises on a CUDA
    error."""
    import torch
    with torch.cuda.device(device):
        rc = fn(*args, stream_ptr(device))
    check(rc, what)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
