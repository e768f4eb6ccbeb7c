"""Text: the Python standard library's `.py` sources, a stand-in for
Silesia's *dickens* (English text, 10,192,446 bytes), whose file the
repository does not hold. Each object is the sources in an order drawn
from the rng, cut to its size, a fresh order each time they run out.
The spec takes no parameters."""

from __future__ import annotations

import os


def stdlib_sources() -> list[bytes]:
    """The standard library's `.py` files, in sorted order."""
    root = os.path.dirname(os.__file__)
    parts = []
    for dirpath, dirnames, filenames in sorted(os.walk(root),
                                               key=lambda t: t[0]):
        dirnames.sort()
        if "site-packages" in dirpath or "__pycache__" in dirpath:
            continue
        for name in sorted(filenames):
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name), "rb") as f:
                    parts.append(f.read())
    return [p for p in parts if p]


def text_object(sources: list[bytes], nbytes: int, rng) -> bytes:
    """`nbytes` of the sources in seeded order."""
    out, size = [], 0
    while size < nbytes:
        for i in rng.permutation(len(sources)):
            out.append(sources[i])
            size += len(sources[i])
            if size >= nbytes:
                break
    return b"".join(out)[:nbytes]


def make(spec: dict, sizes: list[int], rng) -> list[bytes]:
    sources = stdlib_sources()
    return [text_object(sources, n, rng) for n in sizes]
