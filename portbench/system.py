"""The system under test: `density_tpu_torch`'s public entry points.

The window drives `container.compress(data, codec, stream_size, device)`
and `container.decompress(blob, device)`, bytes in host memory to bytes
in host memory, as a configuration (`configs/<name>.json`) sets them:
`device` is one card by name (`"cuda:0"`) or null, which takes the
program's default, every card of the host. The program is imported when
a `PortSystem` is made, never when this module is.
"""

from __future__ import annotations


class PortSystem:
    def __init__(self, config: dict, device=None):
        """`device` overrides the configuration's (the CPU tests pass
        "cpu" or a list of "cpu" devices)."""
        from density_tpu_torch import container
        self.container = container
        self.codec = config["codec"]
        self.stream_size = int(config["stream_size"])
        self.device = device if device is not None else config["device"]

    def compress(self, data: bytes) -> bytes:
        return self.container.compress(data, self.codec, self.stream_size,
                                       self.device)

    def decompress(self, blob: bytes) -> bytes:
        return self.container.decompress(blob, self.device)

    def cuda_indices(self) -> list[int]:
        """The CUDA cards the configuration runs on."""
        import torch
        from density_tpu_torch.parallel import mesh
        return sorted({d.index or 0 for d in mesh.resolve_devices(self.device)
                       if isinstance(d, torch.device) and d.type == "cuda"})

    def prepare(self) -> None:
        """Loads the port's native runtime (built at first use) and
        fails where it cannot: without it the pool decode and the encode's
        fallback run interpreted, which no deployment does."""
        from density_tpu_torch import native
        if not native.is_available():
            raise RuntimeError("the port's native runtime did not load")
