"""density_tpu_torch: the density codecs in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

The port of the JAX package `density_tpu`, slice by slice; this slice
runs chameleon container compress and decompress, encode and decode
both on the card. It imports neither JAX nor `density_tpu`. Entry
points take `device=` and default to the CUDA card; `device="cpu"`
runs each kernel's plain PyTorch version instead.
"""

from density_tpu_torch.container import compress, decompress  # noqa: F401
from density_tpu_torch.errors import (  # noqa: F401
    DecodeError, DensityError, EncodeError)
