"""Chunked codec sessions with carried state (the port of the JAX
package's `stream.py`).

The reference keeps reusable codec instances whose dictionaries persist
across calls, cleared with `clear_state()` (reference:
src/codec/codec.rs:16, src/algorithms/chameleon/chameleon.rs:148-150).
Here that is a chunked API: feeding an input in any chunks gives exactly
the bytes of a one-shot encode of the whole input (partial blocks are
held inside the session; the dictionaries and the blowup-protection FSM
carry across chunks), and the same for decode.

The chunk loop is host byte work, so it runs in the port's native
runtime (`native/libdensity.cpp`: `DtpuStream`); the device path stays
one-shot and batched (`container.compress`). Without the runtime a
session raises.

    enc = StreamEncoder("cheetah")
    out = enc.update(chunk1) + enc.update(chunk2) + enc.finish()
    assert out == density_tpu_torch.encode_raw(chunk1 + chunk2, "cheetah",
                                               backend="native")
"""

from __future__ import annotations

import ctypes

from density_tpu_torch import native
from density_tpu_torch.constants import SPECS
from density_tpu_torch.container import CODEC_IDS
from density_tpu_torch.errors import DecodeError, EncodeError

_FAILED = ctypes.c_size_t(-1).value


class _Session:
    def __init__(self, codec: str):
        if codec not in CODEC_IDS:
            raise EncodeError(f"unknown codec {codec!r}")
        self._lib = native._require()
        self.codec = codec
        self.spec = SPECS[codec]
        self._st = self._lib.dtpu_stream_new(CODEC_IDS[codec])
        self._held = 0       # bytes held inside the native session
        self._finished = False

    def reset(self):
        """The reference's clear_state(): zero the dictionaries and the
        FSM, and lift a decode failure's poison."""
        self._lib.dtpu_stream_reset(self._st)
        self._held = 0
        self._finished = False

    def close(self):
        if self._st:
            self._lib.dtpu_stream_free(self._st)
            self._st = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


class StreamEncoder(_Session):
    """Chunked density encoder with carried dictionary state."""

    def _call(self, data: bytes, final: bool) -> bytes:
        if self._finished:
            raise EncodeError("stream already finished; call reset()")
        data = bytes(data)
        cap = self.spec.safe_encode_buffer_size(self._held + len(data)) + 16
        out = ctypes.create_string_buffer(cap)
        w = self._lib.dtpu_stream_encode(self._st, data, len(data), out, cap,
                                         int(final))
        if w == _FAILED:
            raise EncodeError("output buffer too small (internal)")
        if final:
            self._held = 0
            self._finished = True
        else:
            # the held count comes from the session: a cap-limited partial
            # take may consume fewer bytes than whole blocks of the input
            self._held = int(self._lib.dtpu_stream_held(self._st, 0))
        return out.raw[:w]

    def update(self, data: bytes) -> bytes:
        """Feed bytes; returns the encoded bytes of completed blocks."""
        return self._call(data, final=False)

    def finish(self) -> bytes:
        """Flush the held partial block; ends the stream."""
        return self._call(b"", final=True)


class StreamDecoder(_Session):
    """Chunked density decoder with carried dictionary state. A failed
    call poisons the session until `reset()`: a retry would resolve map
    tokens against state the failed call already advanced."""

    def _call(self, data: bytes, final: bool) -> bytes:
        if self._finished:
            raise DecodeError("stream already finished; call reset()")
        data = bytes(data)
        spec = self.spec
        # each block takes >= sig_bytes of input and gives <= block_size
        total = self._held + len(data)
        cap = (total // (2 * spec.sig_words) + 2) * spec.block_size + 16
        out = ctypes.create_string_buffer(cap)
        w = self._lib.dtpu_stream_decode(self._st, data, len(data), out, cap,
                                         int(final))
        if w == _FAILED:
            raise DecodeError(
                "stream decode failed (output overflow or malformed "
                "input); session is poisoned until reset()")
        if final:
            self._held = 0
            self._finished = True
        else:
            # the session holds back bytes not yet provably complete
            self._held = int(self._lib.dtpu_stream_held(self._st, 1))
        return out.raw[:w]

    def update(self, data: bytes) -> bytes:
        """Feed compressed bytes; returns the decoded bytes so far."""
        return self._call(data, final=False)

    def finish(self, data: bytes = b"") -> bytes:
        """Feed the last compressed bytes and end the stream."""
        return self._call(data, final=True)
