"""Public API: one-shot raw-stream encode/decode.

Counterpart of the JAX package's `api.py`: `encode_raw`/`decode_raw`
produce and consume *bare density streams*, byte-identical to the
reference implementation's output for the same input (reference:
chameleon.rs:45-53). The framed multi-stream container is in
`container.py`.

Backends: "torch" (the JAX package's "jax") runs the device path on
`device` (the CUDA card by default, `device="cpu"` for the plain PyTorch
versions); "scalar" runs the reference loops of `host_scan`. The
"native" backend and the codecs cheetah and lion are not ported yet and
raise.
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
    if codec != "chameleon" or backend == "native":
        raise error(f"codec {codec!r} with backend {backend!r} is not "
                    "ported yet")


def encode_raw(data: bytes, codec: str = "chameleon",
               backend: str = "torch", device=None) -> bytes:
    """Encode `data` into a bare density stream."""
    _check(codec, backend, EncodeError)
    if backend == "scalar":
        from density_tpu_torch import host_scan
        return host_scan.encode_scalar(bytes(data))
    from density_tpu_torch.codecs import chameleon
    return chameleon.encode(data, device)


def decode_raw(data: bytes, codec: str = "chameleon",
               decoded_size_hint: int | None = None,
               backend: str = "torch", device=None) -> bytes:
    """Decode a bare density stream. `decoded_size_hint` is accepted as
    the JAX package accepts it; the decoded length comes from the block
    scan."""
    _check(codec, backend, DecodeError)
    if backend == "scalar":
        from density_tpu_torch import host_scan
        return host_scan.decode_scalar(bytes(data))
    from density_tpu_torch.codecs import chameleon
    return chameleon.decode(data, device)
