"""density_tpu_torch: the density codecs in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

The port of the JAX package `density_tpu`: container compress and
decompress of all three codecs (chameleon, cheetah, lion) at any stream
size, sharded over a list of devices and over `torch.distributed`
processes (`parallel/`); the one-shot `encode_raw`/`decode_raw`;
chunked sessions (`StreamEncoder`, `StreamDecoder`); statistics
(`stats`); host buffers (`io.buffer`); all over its own copy of the C++
host runtime (`native/`, with LZ4 beside the codecs). It imports
neither JAX nor `density_tpu`. Entry points take `device=` and default
to the CUDA cards; `device="cpu"` runs each kernel's plain PyTorch
version instead.
"""

from density_tpu_torch.api import (  # noqa: F401
    decode_raw, encode_raw, safe_encode_buffer_size)
from density_tpu_torch.constants import SPECS, CodecSpec  # noqa: F401
from density_tpu_torch.container import compress, decompress  # noqa: F401
from density_tpu_torch.errors import (  # noqa: F401
    DecodeError, DensityError, EncodeError)
from density_tpu_torch.stream import StreamDecoder, StreamEncoder  # noqa: F401
