"""Framed multi-stream container ("DTPU" v1), the port's own copy.

The input is cut into S independent streams; each is compressed exactly
as a bare density stream with fresh state, and a small header records
the geometry (the JAX package's `container.py`, byte for byte):

    magic    "DTPU"            4 bytes
    version  u8 = 1
    codec_id u8 (0 chameleon / 1 cheetah / 2 lion)
    reserved u16
    original_len u64 LE
    stream_size  u32 LE        (bytes per stream; last may be short)
    n_streams    u32 LE
    lengths      u32 LE * n_streams (compressed bytes per stream)
    payload: concatenated bare streams, in order

The port encodes and decodes the containers of all three codecs on the
device.
"""

from __future__ import annotations

import struct

import numpy as np

from density_tpu_torch.errors import DecodeError, EncodeError

MAGIC = b"DTPU"
VERSION = 1
CODEC_IDS = {"chameleon": 0, "cheetah": 1, "lion": 2}
CODEC_NAMES = {v: k for k, v in CODEC_IDS.items()}
DEFAULT_STREAM_SIZE = 8 << 20  # 8 MiB
# the JAX package's defaults: 32 MiB streams give the reference's
# single-stream ratio on any input up to 32 MiB
DEFAULT_STREAM_SIZES = {"chameleon": 32 << 20, "cheetah": 32 << 20,
                        "lion": 32 << 20}

_HDR = struct.Struct("<4sBBHQII")


def default_stream_size(codec: str) -> int:
    return DEFAULT_STREAM_SIZES.get(codec, DEFAULT_STREAM_SIZE)


def build_header(codec: str, original_len: int, stream_size: int,
                 lengths: list[int]) -> bytes:
    head = _HDR.pack(MAGIC, VERSION, CODEC_IDS[codec], 0,
                     original_len, stream_size, len(lengths))
    return head + np.asarray(lengths, dtype="<u4").tobytes()


def parse_header(data: bytes):
    """Returns (codec, original_len, stream_size, lengths, payload_off)."""
    if len(data) < _HDR.size:
        raise DecodeError("container too short")
    magic, version, codec_id, _, original_len, stream_size, n_streams = (
        _HDR.unpack_from(data, 0))
    if magic != MAGIC:
        raise DecodeError("bad magic")
    if version != VERSION:
        raise DecodeError(f"unsupported container version {version}")
    if codec_id not in CODEC_NAMES:
        raise DecodeError(f"unknown codec id {codec_id}")
    off = _HDR.size
    end = off + 4 * n_streams
    if len(data) < end:
        raise DecodeError("truncated stream table")
    lengths = np.frombuffer(data[off:end], dtype="<u4").astype(np.int64)
    return CODEC_NAMES[codec_id], original_len, stream_size, lengths, end


def split_streams(n: int, stream_size: int) -> int:
    if stream_size <= 0:
        raise EncodeError("stream_size must be positive")
    return max(1, -(-n // stream_size))


def compress(data: bytes, codec: str = "chameleon",
             stream_size: int | None = None, device=None) -> bytes:
    """Compress into a framed container on `device` (default: the CUDA
    card; raises when there is none and `device="cpu"` was not given)."""
    if codec not in CODEC_IDS:
        raise EncodeError(f"unknown codec {codec!r}")
    if stream_size is None:
        stream_size = default_stream_size(codec)
    from density_tpu_torch.parallel import sharding
    return sharding.compress(data, codec, stream_size, device)


def decompress(data: bytes, device=None) -> bytes:
    """Decompress a framed container on `device` (default: the card). A
    cheetah or lion container of many predicted tokens decodes on the
    native runtime's thread pool instead (`sharding.route`)."""
    from density_tpu_torch.parallel import sharding
    return sharding.decompress(data, device)
