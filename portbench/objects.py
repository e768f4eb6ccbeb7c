"""The general traffic generator: a mix file's parameters -> the objects.

A mix (`traffic/<name>.json`) gives:

- `object_bytes`: the size law, `{"kind": <law>, ...}`, read by
  `sizes/<law>.py` (`sizes(spec, config, count)`): `fixed` (`bytes`
  each) or `call` (the configuration's `call_bytes` each);
- `content`: what the objects hold, `{"kind": <kind>, ...}`, made by
  `content/<kind>.py` (`make(spec, sizes, rng)`): `stdlib_text` (the
  Python standard library's sources, a stand-in for Silesia's
  *dickens*) or `quads` (4-byte values drawn from a seeded set);
- `distinct`: how many distinct objects the requests cycle over;
- `content_seed`: the objects and the cycle of the requests are drawn
  from it, and the run's seed draws only where the cycle starts, so
  that every seed does the same work (the text sets how many plans the
  encode's fixed point takes);
- `loop`: `"closed"`, one writer that waits for each result;
- `check`: `whole_objects`, the objects whose first container is held
  to the reference stream by stream, whole; `reference_streams`, the
  streams of the others sampled for it; `outputs`, the decompressed
  objects compared with their originals; all drawn from the run's seed.

A new size law or content kind is a new file in `sizes/` or `content/`;
a new mix of the laws and kinds there is a data file alone.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from portbench import resolve

ROOT = Path(__file__).resolve().parent.parent


def sizes(mix: dict, config: dict, root: Path = ROOT) -> list[int]:
    """The distinct objects' sizes, in the mix's own order."""
    spec = mix["object_bytes"]
    law = resolve.module("sizes", spec["kind"], root)
    return [int(n) for n in law.sizes(spec, config, int(mix["distinct"]))]


def make(mix: dict, config: dict, seed: int, root: Path = ROOT):
    """(objects, order): the distinct objects and the order in which the
    requests cycle over them. The objects and the cycle are drawn from
    the mix's `content_seed` and the run's seed draws where the cycle
    starts: every seed sends the same requests in the same pattern."""
    if mix.get("loop") != "closed":
        raise ValueError("only a closed loop is generated")
    content = np.random.default_rng(mix["content_seed"])
    spec = mix["content"]
    kind = resolve.module("content", spec["kind"], root)
    objects = [bytes(o) for o in kind.make(spec, sizes(mix, config, root),
                                           content)]
    cycle = [int(i) for i in content.permutation(len(objects))]
    start = int(np.random.default_rng(seed).integers(len(objects)))
    return objects, cycle[start:] + cycle[:start]
