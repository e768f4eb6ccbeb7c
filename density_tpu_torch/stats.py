"""Per-stream compression statistics (the port of the JAX package's
`stats.py`).

The reference reports nothing beyond a bench's ratio print (reference:
benches/density.rs:26). `stream_stats` walks a compressed stream on the
host; `encode_stats` runs the device planner and reduces the flag
histogram and the payload bytes on the device, so that only a few
scalars and the copy-block set cross to the host (the set is decided by
`layout.fixed_point` on the device, as in `layout.run_encode`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from density_tpu_torch import native
from density_tpu_torch.constants import SPECS
from density_tpu_torch.engine import layout
from density_tpu_torch.errors import EncodeError
from density_tpu_torch.parallel.mesh import resolve_device


@dataclasses.dataclass
class StreamStats:
    codec: str
    original_bytes: int
    compressed_bytes: int
    n_blocks: int
    copy_blocks: int
    flag_histogram: dict[str, int]

    @property
    def ratio(self) -> float:
        return (self.original_bytes / self.compressed_bytes
                if self.compressed_bytes else 0.0)


_FLAG_NAMES = {
    "chameleon": {0: "plain", 1: "map"},
    "cheetah": {0: "plain", 1: "map_a", 2: "map_b", 3: "predicted"},
    "lion": {0: "plain", 1: "pred_a", 2: "pred_b", 3: "pred_c",
             4: "pred_d", 5: "pred_e", 6: "map_a", 7: "map_b"},
}


def _check(codec: str) -> None:
    if codec not in SPECS:
        raise EncodeError(f"unknown codec {codec!r}")


def stream_stats(codec: str, data: bytes, compressed: bytes) -> StreamStats:
    """Statistics of a compressed bare stream from the native block scan
    and a walk of its signatures (host; for reports, not the hot path)."""
    _check(codec)
    spec = SPECS[codec]
    in_off, out_off, is_copy = native.scan(codec, compressed)
    names = _FLAG_NAMES[codec]
    hist = {name: 0 for name in names.values()}
    mask = (1 << spec.flag_bits) - 1
    for b, off in enumerate(in_off):
        if is_copy[b]:
            continue
        sig = int.from_bytes(
            compressed[off:off + spec.sig_bytes].ljust(8, b"\x00"), "little")
        end_out = out_off[b + 1] if b + 1 < len(out_off) else len(data)
        n_tokens = min(spec.quads_per_block,
                       max(0, (end_out - out_off[b]) // 4))
        for _ in range(n_tokens):
            hist[names[sig & mask]] += 1
            sig >>= spec.flag_bits
    return StreamStats(
        codec=codec,
        original_bytes=len(data),
        compressed_bytes=len(compressed),
        n_blocks=len(in_off),
        copy_blocks=int(np.asarray(is_copy).sum()),
        flag_histogram=hist,
    )


def encode_stats(codec: str, data: bytes, device=None) -> StreamStats:
    """Encode-side statistics of `data` as one stream, from the device
    planner: the codec's copy-free plan, then `layout.fixed_point` (as in
    `layout.run_encode`), and the flag histogram and payload bytes of
    the plan under its copy set reduced on the device.
    Equals `stream_stats(codec, data, native.encode(codec, data))`; a
    stream whose fixed point does not converge is encoded natively and
    walked instead, as `run_encode` leaves it to the native encoder."""
    from density_tpu_torch.parallel.sharding import codec_module
    _check(codec)
    dev = resolve_device(device)
    pipe = codec_module(codec).PIPELINE
    spec = SPECS[codec]
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    n = buf.size
    if n == 0:
        return StreamStats(codec, 0, 0, 0, 0,
                           {v: 0 for v in _FLAG_NAMES[codec].values()})
    quads, nbytes = layout.stage_stream(buf, spec.block_size, dev)
    copy, (flags, pw, _, _, valid, _), converged, _ = layout.fixed_point(
        pipe, quads, nbytes, pipe.plan_fast(quads, nbytes))
    if not converged:
        return stream_stats(codec, data, native.encode(codec, data))

    # the plan in hand was made under `copy`: reduce it on the device
    n_flags = 1 << spec.flag_bits
    live = (valid & ~copy.repeat_interleave(pipe.Q, dim=1)).reshape(-1)
    hist = torch.zeros(n_flags, dtype=torch.int64, device=dev).scatter_add_(
        0, torch.where(live, flags.reshape(-1), 0).long(), live.long())
    pay_bytes = 2 * torch.where(live, pw.reshape(-1), 0).long().sum()
    host = torch.cat([hist, pay_bytes[None]]).cpu().numpy()
    copy = copy.cpu().numpy()

    n_blocks = -(-n // spec.block_size)
    copies = np.flatnonzero(copy[0])
    # the ragged tail is written raw after the last block unless that
    # block is a copy block, which holds it already
    last_is_copy = bool(copy[0, n_blocks - 1])
    comp = (int(host[-1]) + (n_blocks - copies.size) * spec.sig_bytes
            + sum(min(spec.block_size, n - b * spec.block_size)
                  for b in copies)
            + (0 if last_is_copy else n % 4))
    return StreamStats(
        codec=codec,
        original_bytes=n,
        compressed_bytes=comp,
        n_blocks=n_blocks,
        copy_blocks=int(copies.size),
        flag_histogram={name: int(host[k])
                        for k, name in _FLAG_NAMES[codec].items()},
    )
