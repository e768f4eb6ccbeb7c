"""Device selection (the one-device counterpart of the JAX package's
`parallel/mesh.py`).

Entry points run on the CUDA card unless the caller passes
`device="cpu"`; they never fall back to the CPU on their own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card. Raises when a CUDA device is asked for
    and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
