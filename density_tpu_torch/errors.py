"""Error types (the same hierarchy as the JAX package's)."""


class DensityError(Exception):
    """Base class for density errors."""


class EncodeError(DensityError):
    """Raised on encode-side misuse (unknown codec, bad buffer)."""


class DecodeError(DensityError):
    """Raised on malformed or truncated compressed input."""
