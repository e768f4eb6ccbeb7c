"""density_tpu_torch: the density codecs in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

The port of the JAX package `density_tpu`, slice by slice: container
compress and decompress of all three codecs (chameleon, cheetah, lion)
at any stream size, and the one-shot `encode_raw`/`decode_raw`, encode
and decode on the card, over its own copy of the C++ host runtime
(`native/`). It imports neither JAX nor `density_tpu`. Entry points
take `device=` and default to the CUDA card; `device="cpu"` runs each
kernel's plain PyTorch version instead.
"""

from density_tpu_torch.api import (  # noqa: F401
    decode_raw, encode_raw, safe_encode_buffer_size)
from density_tpu_torch.container import compress, decompress  # noqa: F401
from density_tpu_torch.errors import (  # noqa: F401
    DecodeError, DensityError, EncodeError)
