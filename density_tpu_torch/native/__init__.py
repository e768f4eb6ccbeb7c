"""ctypes bindings to the port's native host runtime (`libdensity.cpp`).

The port's counterpart of the JAX package's `native/__init__.py`: the
density-compatible one-shot encode and decode of the three codecs, the
block scanner that the device decode needs, and the thread pool over
independent streams (`*_many`). The library is built with `g++` at first
use (`build.py`). Where it cannot be built or loaded, or where
`DENSITY_TPU_NO_NATIVE=1` is set (read at every call), every entry point
runs its pure-Python twin in `host_scan` instead, with the same results.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from density_tpu_torch import host_scan
from density_tpu_torch.constants import SPECS
from density_tpu_torch.container import CODEC_IDS
from density_tpu_torch.errors import DecodeError, EncodeError

N_THREADS = os.cpu_count() or 1

_lib = None
_load_error: Exception | None = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    size_t, vp, i64p = ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p
    for codec in CODEC_IDS:
        for op in ("encode", "decode"):
            fn = getattr(lib, f"{codec}_{op}")
            fn.restype = size_t
            fn.argtypes = [ctypes.c_char_p, size_t, vp, size_t]
        fn = getattr(lib, f"{codec}_scan")
        fn.restype = size_t
        fn.argtypes = [ctypes.c_char_p, size_t, vp, vp, vp, size_t]
    for op in ("decode_many", "encode_many"):
        fn = getattr(lib, f"dtpu_{op}")
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_int, ctypes.c_char_p, i64p, i64p, vp, i64p,
                       i64p, i64p, ctypes.c_int64, ctypes.c_int]
    lib.dtpu_scan_many.restype = ctypes.c_int64
    lib.dtpu_scan_many.argtypes = [
        ctypes.c_int, ctypes.c_char_p, i64p, i64p, i64p, i64p, vp, i64p,
        i64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
    # the chunked sessions of `stream.py`
    lib.dtpu_stream_new.restype = vp
    lib.dtpu_stream_new.argtypes = [ctypes.c_int]
    for op in ("free", "reset"):
        fn = getattr(lib, f"dtpu_stream_{op}")
        fn.restype = None
        fn.argtypes = [vp]
    for op in ("encode", "decode"):
        fn = getattr(lib, f"dtpu_stream_{op}")
        fn.restype = size_t
        fn.argtypes = [vp, ctypes.c_char_p, size_t, vp, size_t, ctypes.c_int]
    lib.dtpu_stream_held.restype = size_t
    lib.dtpu_stream_held.argtypes = [vp, ctypes.c_int]
    for op in ("compress", "decompress"):
        fn = getattr(lib, f"dtpu_lz4_{op}")
        fn.restype = size_t
        fn.argtypes = [ctypes.c_char_p, size_t, vp, size_t]
    return lib


def _load():
    """The bound library, or None (disabled, or the build or load
    failed: the error is kept in `_load_error`)."""
    global _lib, _load_error
    if os.environ.get("DENSITY_TPU_NO_NATIVE") == "1":
        return None
    if _lib is None and _load_error is None:
        from density_tpu_torch.native.build import build
        try:
            _lib = _bind(ctypes.CDLL(str(build())))
        except (OSError, AttributeError, subprocess.CalledProcessError) as e:
            _load_error = e
    return _lib


def is_available() -> bool:
    return _load() is not None


def safe_encode_buffer_size(codec: str, size: int) -> int:
    """Worst-case encoded size (reference: codec.rs:18-21)."""
    return SPECS[codec].safe_encode_buffer_size(size)


def encode(codec: str, data: bytes) -> bytes:
    """One-shot encode (fresh state), density-compatible bytes."""
    lib = _load()
    if lib is None:
        return host_scan.encode_scalar(bytes(data), codec)
    data = bytes(data)
    cap = safe_encode_buffer_size(codec, len(data)) + 16
    out = ctypes.create_string_buffer(cap)
    n = getattr(lib, f"{codec}_encode")(data, len(data), out, cap)
    return out.raw[:n]


def decode(codec: str, data: bytes,
           decoded_size_hint: int | None = None) -> bytes:
    """One-shot decode (fresh state). Without a hint the output may be
    up to 64 times the input: a block of predicted tokens stores its
    signature alone."""
    lib = _load()
    if lib is None:
        return host_scan.decode_scalar(bytes(data), codec)
    data = bytes(data)
    cap = (decoded_size_hint if decoded_size_hint is not None
           else max(64, len(data) * 64))
    out = ctypes.create_string_buffer(cap + 16)
    n = getattr(lib, f"{codec}_decode")(data, len(data), out, cap)
    return out.raw[:n]


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def _offsets(lengths) -> np.ndarray:
    lengths = np.asarray(lengths, np.int64)
    return np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)


def _many(lib, fn_name: str, codec: str, inputs, out_caps,
          error: type) -> list:
    """One pooled call of `dtpu_{encode,decode}_many` over independent
    inputs; raises `error` if any of them fails."""
    n = len(inputs)
    in_len = np.array([len(s) for s in inputs], np.int64)
    in_off = _offsets(in_len)
    out_cap = np.asarray(out_caps, np.int64)
    out_off = _offsets(out_cap)
    out = np.empty(int(out_cap.sum()) + 16, np.uint8)
    out_len = np.zeros(n, np.int64)
    fails = getattr(lib, fn_name)(
        CODEC_IDS[codec], b"".join(inputs), _ptr(in_off), _ptr(in_len),
        _ptr(out), _ptr(out_off), _ptr(out_cap), _ptr(out_len), n,
        N_THREADS)
    if fails:
        raise error(f"{fails} of {n} stream(s) failed")
    return [out[out_off[i]:out_off[i] + out_len[i]].tobytes()
            for i in range(n)]


def decode_many(codec: str, streams, out_caps) -> list:
    """Decode independent streams on the thread pool; `out_caps` bounds
    each one's decoded size. Raises DecodeError on a malformed stream or
    one that decodes past its bound."""
    streams = [bytes(s) for s in streams]
    lib = _load()
    if lib is None:
        outs = [host_scan.decode_scalar(s, codec) for s in streams]
        if any(len(o) > cap for o, cap in zip(outs, out_caps)):
            raise DecodeError("decoded stream exceeds declared capacity")
        return outs
    if not streams:
        return []
    return _many(lib, "dtpu_decode_many", codec, streams, out_caps,
                 DecodeError)


def encode_many(codec: str, chunks) -> list:
    """Encode independent chunks on the thread pool."""
    chunks = [bytes(c) for c in chunks]
    lib = _load()
    if lib is None:
        return [host_scan.encode_scalar(c, codec) for c in chunks]
    if not chunks:
        return []
    caps = [safe_encode_buffer_size(codec, len(c)) + 16 for c in chunks]
    return _many(lib, "dtpu_encode_many", codec, chunks, caps,
                 EncodeError)


def scan_many(codec: str, streams, max_blocks: int):
    """Scan independent streams on the thread pool. Returns (in_offsets,
    out_offsets, is_copy) as (n, max_blocks) arrays, and the block,
    predicted-token and token counts per stream. Raises DecodeError on a
    malformed stream or one of more than `max_blocks` blocks."""
    streams = [bytes(s) for s in streams]
    lib = _load()
    if lib is None:
        return host_scan.scan_many(streams, max_blocks, codec)
    n = len(streams)
    in_len = np.array([len(s) for s in streams], np.int64)
    bio = np.zeros((n, max_blocks), np.int64)
    boo = np.zeros((n, max_blocks), np.int64)
    bcp = np.zeros((n, max_blocks), np.uint8)
    nb, pred, tot = (np.zeros(n, np.int64) for _ in range(3))
    fails = lib.dtpu_scan_many(
        CODEC_IDS[codec], b"".join(streams), _ptr(_offsets(in_len)),
        _ptr(in_len), _ptr(bio), _ptr(boo), _ptr(bcp), _ptr(nb), _ptr(pred),
        _ptr(tot), n, max_blocks, N_THREADS)
    if fails:
        raise DecodeError(f"{fails} malformed {codec} stream(s)")
    return bio, boo, bcp, nb, pred, tot


def scan(codec: str, data: bytes):
    """Per-block (in_offsets, out_offsets, is_copy) of one stream; raises
    DecodeError on malformed input."""
    lib = _load()
    if lib is None:
        return host_scan.scan_with_counts(bytes(data), codec)[:3]
    data = bytes(data)
    # a block takes at least its signature (6 or 8 bytes)
    max_blocks = len(data) // SPECS[codec].sig_bytes + 2
    in_off = np.zeros(max_blocks, np.int64)
    out_off = np.zeros(max_blocks, np.int64)
    is_copy = np.zeros(max_blocks, np.uint8)
    n = getattr(lib, f"{codec}_scan")(data, len(data), _ptr(in_off),
                                       _ptr(out_off), _ptr(is_copy),
                                       max_blocks)
    if n == ctypes.c_size_t(-1).value:
        raise DecodeError(f"malformed {codec} stream")
    return in_off[:n], out_off[:n], is_copy[:n]


def _require():
    """The bound library; raises where there is none (the entry points
    below have no pure-Python twin)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable: " + (
            str(_load_error) if _load_error is not None
            else "disabled by DENSITY_TPU_NO_NATIVE=1"))
    return lib


def lz4_compress(data: bytes) -> bytes:
    """The runtime's LZ4 block compress (a yardstick beside the density
    codecs, not part of their format). Raises without the runtime."""
    lib = _require()
    data = bytes(data)
    cap = len(data) + len(data) // 128 + 64
    out = ctypes.create_string_buffer(cap)
    n = lib.dtpu_lz4_compress(data, len(data), out, cap)
    if n == 0 and len(data):
        raise RuntimeError("lz4 compress overflow")
    return out.raw[:n]


def lz4_decompress(data: bytes, decoded_size: int) -> bytes:
    """LZ4 block decompress of at most `decoded_size` bytes; raises
    RuntimeError on a malformed block."""
    lib = _require()
    data = bytes(data)
    out = ctypes.create_string_buffer(decoded_size + 16)
    n = lib.dtpu_lz4_decompress(data, len(data), out, decoded_size + 16)
    if n == ctypes.c_size_t(-1).value:
        raise RuntimeError("malformed lz4 block")
    return out.raw[:n]
