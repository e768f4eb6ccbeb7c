"""The reader of cheetah's cell, `mtf2_ms.compress`, on events made by
hand: the self time of the scans less their child spans, per compress
call, and nothing where the program emits no such span (as a tree
without it does) or the run spans several cards."""

import pytest

from portbench_tiny import ROOT
from portbench import resolve
from portbench.trace import Trace

# two compress calls and one decompress call; ns
EVENTS = [
    ("portbench.half.compress", 0, 1000, None),
    ("portbench.half.decompress", 1000, 2000, None),
    ("portbench.compress", 10, 400, None),
    ("density.container.compress", 20, 390, None),
    ("density.engine.encode", 100, 300, None),
    ("density.engine.plan", 110, 200, None),
    ("density.engine.mtf2", 120, 160, None),
    ("aten::cummax", 121, 159, None),  # an op: no child span
    ("density.engine.plan_masked", 210, 290, None),
    ("density.engine.mtf2", 220, 280, None),
    ("density.wait.read", 230, 240, None),
    ("portbench.compress", 500, 900, None),
    ("density.container.compress", 500, 880, None),
    ("density.engine.plan", 600, 700, None),
    ("density.engine.mtf2", 610, 640, None),
    ("portbench.decompress", 1100, 1500, None),
    ("density.container.decompress", 1100, 1500, None),
    ("density.native.scan", 1150, 1250, None),
    ("density.native.pool", 1300, 1450, None),
    ("density.engine.mtf2", 2500, 2600, None),  # a probe's, after both
    ("k1", 120, 140, 0),
]
# the same calls from a tree without the spans: the pool route was
# `native.decode`, and no scan had a span
PARENT = [("density.native.decode",) + e[1:] if e[0] == "density.native.pool"
          else e for e in EVENTS if e[0] != "density.engine.mtf2"]


class Half:
    def __init__(self, calls):
        self.calls = calls


class Ctx:
    def __init__(self, events=EVENTS, cards=(0,)):
        self.trace = Trace(events, list(cards))
        self.cards = list(cards)
        self.halves = {"compress": Half(2), "decompress": Half(1)}
        self.lines = []

    def log(self, *parts):
        self.lines.append(" ".join(map(str, parts)))


def read(name: str, ctx):
    return resolve.reader(name, ROOT)(ctx)


def test_mtf2_ms_is_the_scans_self_time_per_call():
    # 40 + (60 - 10, the read inside) + 30 ns over 2 calls
    assert read("mtf2_ms.compress", Ctx()) == pytest.approx(60e-6)


def test_nothing_without_the_span_untraced_or_over_several_cards():
    name = "mtf2_ms.compress"
    assert read(name, Ctx(PARENT)) is None
    bare = Ctx([e for e in EVENTS if not e[0].startswith("density.")])
    assert read(name, bare) is None
    untraced = Ctx()
    untraced.trace = None
    assert read(name, untraced) is None
    assert read(name, Ctx(cards=(0, 1))) is None
