"""Host byte buffers (the port's copy of the JAX package's
`io/buffer.py`).

The reference's host IO surface, for host code paths (container framing,
tests, streaming adapters):

  * Buffer      -- fixed-capacity push buffer (reference:
                   src/buffer.rs:1-35, public but unused by the codecs).
  * ReadBuffer  -- cursored little-endian reader (reference:
                   src/io/read_buffer.rs:1-45).
  * WriteBuffer -- cursored writer with reserve and backpatch (reference:
                   src/io/write_buffer.rs:3-42).

The device counterparts are the word lattices of
`density_tpu_torch.engine.layout`; these classes serve the scalar host
paths, where cursored byte IO is the right tool.
"""

from __future__ import annotations


class Buffer:
    """Fixed-capacity push buffer (reference: buffer.rs:1-35)."""

    def __init__(self, capacity: int):
        self._data = bytearray(capacity)
        self._len = 0

    @property
    def capacity(self) -> int:
        return len(self._data)

    def __len__(self) -> int:
        return self._len

    def is_empty(self) -> bool:
        return self._len == 0

    def remaining_space(self) -> int:
        return len(self._data) - self._len

    def push(self, chunk: bytes) -> int:
        """Append up to remaining_space bytes; returns bytes consumed."""
        n = min(len(chunk), self.remaining_space())
        self._data[self._len:self._len + n] = chunk[:n]
        self._len += n
        return n

    def reset(self) -> None:
        self._len = 0

    def view(self) -> memoryview:
        return memoryview(self._data)[: self._len]


class ReadBuffer:
    """Cursored little-endian reader (reference: read_buffer.rs)."""

    def __init__(self, data: bytes):
        self.data = data
        self.index = 0

    def remaining(self) -> int:
        return len(self.data) - self.index

    def read(self, n: int) -> bytes:
        out = self.data[self.index:self.index + n]
        if len(out) != n:
            raise IndexError("read past end of buffer")
        self.index += n
        return out

    def rewind(self, n: int) -> None:
        self.index -= n

    def read_u16_le(self) -> int:
        return int.from_bytes(self.read(2), "little")

    def read_u32_le(self) -> int:
        return int.from_bytes(self.read(4), "little")

    def read_u64_le(self) -> int:
        return int.from_bytes(self.read(8), "little")


class WriteBuffer:
    """Cursored writer with reserve/backpatch (reference:
    write_buffer.rs); `skip` reserves a slot, `write_at` backpatches
    it -- the host-side analogue of the signature reserve/ink pattern
    (reference: codec.rs:41,67)."""

    def __init__(self, capacity: int):
        self.data = bytearray(capacity)
        self.index = 0

    def push(self, chunk: bytes) -> None:
        end = self.index + len(chunk)
        self.data[self.index:end] = chunk
        self.index = end

    def skip(self, n: int) -> int:
        """Reserve n bytes; returns the reserved position."""
        pos = self.index
        self.index += n
        return pos

    def rewind(self, n: int) -> None:
        self.index -= n

    def write_at(self, pos: int, chunk: bytes) -> None:
        self.data[pos:pos + len(chunk)] = chunk

    def getvalue(self) -> bytes:
        return bytes(self.data[: self.index])
