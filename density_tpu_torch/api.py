"""Public API: one-shot raw-stream encode/decode.

Counterpart of the JAX package's `api.py`: `encode_raw`/`decode_raw`
produce and consume *bare density streams*, byte-identical to the
reference implementation's output for the same input (reference:
chameleon.rs:45-53, cheetah.rs:57-65, lion.rs:74-82). The framed
multi-stream container is in `container.py`.

Backends, each for all three codecs: "torch" (the JAX package's "jax")
runs the device path on `device` (the CUDA card by default,
`device="cpu"` for the plain PyTorch versions); "native" runs the port's
C++ host runtime (`native/`) and "scalar" the reference loops of
`host_scan`.
"""

from __future__ import annotations

from density_tpu_torch.constants import SPECS
from density_tpu_torch.errors import DecodeError, EncodeError

BACKENDS = ("torch", "scalar", "native")


def safe_encode_buffer_size(codec: str, size: int) -> int:
    """Worst-case encoded size (reference: codec.rs:18-21)."""
    if codec not in SPECS:
        raise EncodeError(f"unknown codec {codec!r}")
    return SPECS[codec].safe_encode_buffer_size(size)


def _check(codec: str, backend: str, error: type) -> None:
    if codec not in SPECS:
        raise error(f"unknown codec {codec!r}")
    if backend not in BACKENDS:
        raise error(f"unknown backend {backend!r}")


def encode_raw(data: bytes, codec: str = "chameleon",
               backend: str = "torch", device=None) -> bytes:
    """Encode `data` into a bare density stream."""
    _check(codec, backend, EncodeError)
    if backend == "native":
        from density_tpu_torch import native
        return native.encode(codec, bytes(data))
    if backend == "scalar":
        from density_tpu_torch import host_scan
        return host_scan.encode_scalar(bytes(data), codec)
    from density_tpu_torch.parallel.sharding import codec_module
    return codec_module(codec).encode(data, device)


def decode_raw(data: bytes, codec: str = "chameleon",
               decoded_size_hint: int | None = None,
               backend: str = "torch", device=None) -> bytes:
    """Decode a bare density stream. The "native" backend bounds its
    output by `decoded_size_hint`, as the JAX package's does; the others
    take the decoded length from the block scan."""
    _check(codec, backend, DecodeError)
    if backend == "native":
        from density_tpu_torch import native
        return native.decode(codec, bytes(data), decoded_size_hint)
    if backend == "scalar":
        from density_tpu_torch import host_scan
        return host_scan.decode_scalar(bytes(data), codec)
    from density_tpu_torch.parallel.sharding import codec_module
    return codec_module(codec, DecodeError).decode(data, device)
