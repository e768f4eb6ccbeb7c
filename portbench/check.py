"""The comparison that decides `correct`.

After the window, what the timed path produced is held to the plain
reference (`reference/density.py`) and to the objects themselves:

- `failed`: requests that raised, in either half;
- `containers_unlike_first`: containers of the window that differ from
  the first container made of the same object (every container made);
- `container_bytes_wrong`: in the first container of each object, the
  header's fixed fields against the reference header, the stream table's
  total against the payload, and streams against the reference
  encoder's, each stream's bytes and its table entry, counted in bytes
  that differ (a length difference counts its bytes). The streams are
  every stream of `whole_objects` objects drawn from the seed (every
  batch and every card's share of a call), a seeded sample of
  `reference_streams` streams of the others, and the longest object's
  last stream;
- `roundtrip_bytes_wrong`: a seeded sample of the decompressed objects
  against the originals, in bytes that differ.

Each is exact, so each limit is 0: the containers must equal the density
format byte for byte and the round trip must be lossless.
"""

from __future__ import annotations

import struct

import numpy as np

from portbench.reference import density

LIMITS = {"failed": 0, "containers_unlike_first": 0,
          "container_bytes_wrong": 0, "roundtrip_bytes_wrong": 0}


def bytes_wrong(got: bytes, want: bytes) -> int:
    """Bytes that differ, plus the difference in length."""
    n = min(len(got), len(want))
    a = np.frombuffer(got, np.uint8, n)
    b = np.frombuffer(want, np.uint8, n)
    return int(np.count_nonzero(a != b)) + abs(len(got) - len(want))


def _table(blob: bytes):
    """(fixed header bytes, lengths, payload offset) of a container, or
    None where it is too short to hold its stream table."""
    if len(blob) < density.HEADER.size:
        return None
    S = struct.unpack_from("<I", blob, density.HEADER.size - 4)[0]
    off = density.HEADER.size + 4 * S
    if len(blob) < off:
        return None
    lengths = np.frombuffer(blob, "<u4", S, density.HEADER.size)
    return blob[:density.HEADER.size], lengths.astype(np.int64), off


def sample_streams(objects: list, made: list, stream_size: int, whole: int,
                   k: int, rng: np.random.Generator) -> list[tuple[int, int]]:
    """(object, stream) pairs of the objects `made` (those the window
    compressed): every stream of `whole` of them drawn from the seed, k
    more drawn from the seed over the others' streams, and the longest
    one's last stream."""
    counts = {o: len(density.stream_bounds(len(objects[o]), stream_size))
              for o in made}
    whole_objs = {made[i] for i in rng.choice(len(made), min(whole, len(made)),
                                              replace=False)}
    chosen = {(o, s) for o in whole_objs for s in range(counts[o])}
    rest = [(o, s) for o in made if o not in whole_objs
            for s in range(counts[o])]
    chosen |= {rest[i] for i in rng.choice(len(rest), min(k, len(rest)),
                                           replace=False)}
    if made:
        longest = max(made, key=lambda o: len(objects[o]))
        chosen.add((longest, counts[longest] - 1))
    return sorted(chosen)


def container_errors(blob: bytes, data: bytes, codec: str, stream_size: int,
                     streams: list[int]) -> int:
    """Bytes by which `blob`, the container of `data`, departs from the
    reference: its fixed header, its table's total and the streams
    `streams`."""
    bounds = density.stream_bounds(len(data), stream_size)
    parsed = _table(blob)
    if parsed is None:
        return len(density.header(codec, len(data), stream_size,
                                   [0] * len(bounds)))
    fixed, lengths, off = parsed
    want_fixed = density.HEADER.pack(b"DTPU", 1, density.CODEC_IDS[codec], 0,
                                     len(data), stream_size, len(bounds))
    wrong = bytes_wrong(fixed, want_fixed)
    wrong += abs(int(lengths.sum()) - (len(blob) - off))
    ends = off + np.cumsum(lengths)
    for s in streams:
        a, b = bounds[s]
        want = density.encode_stream(data[a:b], codec)
        if s >= len(lengths):
            wrong += len(want) + 4
            continue
        got = blob[int(ends[s] - lengths[s]):int(ends[s])]
        wrong += bytes_wrong(got, want)
        wrong += bytes_wrong(struct.pack("<I", int(lengths[s])),
                             struct.pack("<I", len(want)))
    return wrong


def judge(objects: list, containers: list, outputs: list, failed: int,
          codec: str, stream_size: int, spec: dict,
          rng: np.random.Generator) -> dict:
    """{number: (value, limit)} for the window's results: `containers`
    [(object, container or None)] of every compress request, `outputs`
    [(object, bytes)] the sampled decompress results; `spec` the mix's
    `check` (`whole_objects`, `reference_streams`)."""
    first: dict = {}
    unlike = 0
    for obj, blob in containers:
        if blob is None:
            continue
        if obj not in first:
            first[obj] = blob
        elif blob != first[obj]:
            unlike += 1
    wrong = 0
    picks = sample_streams(objects, sorted(first), stream_size,
                           int(spec.get("whole_objects", 0)),
                           int(spec["reference_streams"]), rng)
    for obj in sorted({o for o, _ in picks}):
        wrong += container_errors(first[obj], objects[obj], codec,
                                  stream_size,
                                  [s for o, s in picks if o == obj])
    roundtrip = sum(bytes_wrong(out, objects[obj]) for obj, out in outputs)
    values = {"failed": failed, "containers_unlike_first": unlike,
              "container_bytes_wrong": wrong,
              "roundtrip_bytes_wrong": roundtrip}
    return {k: (v, LIMITS[k]) for k, v in values.items()}


def correct(numbers: dict) -> bool:
    return all(v <= limit for v, limit in numbers.values())
