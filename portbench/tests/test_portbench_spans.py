"""The readers of the program's spans (`portbench/spans.py`) on events
made by hand: self time by layer, the per-call division, the half's
bounds, the counts, and no reading over several cards or without
spans."""

import pytest

from portbench_tiny import ROOT
from portbench import resolve, spans
from portbench.trace import Trace

# two compress calls and one decompress call; ns
EVENTS = [
    ("portbench.half.compress", 0, 1000, None),
    ("portbench.half.decompress", 1000, 2000, None),
    ("portbench.compress", 10, 400, None),
    ("density.container.compress", 20, 390, None),
    ("density.sharding.share", 30, 380, None),
    ("density.sharding.stage", 40, 100, None),
    ("density.wait.to_card", 60, 90, None),
    ("aten::copy_", 61, 89, None),  # an op: no child span
    ("density.engine.encode", 100, 300, None),
    ("density.engine.plan", 110, 200, None),
    ("density.wait.read", 200, 250, None),
    ("density.engine.plan_masked", 250, 290, None),
    ("density.sharding.fetch", 300, 370, None),
    ("density.wait.read", 310, 330, None),
    ("portbench.compress", 500, 900, None),
    ("density.container.compress", 500, 880, None),
    ("density.engine.plan", 600, 700, None),
    ("portbench.decompress", 1100, 1500, None),
    ("density.container.decompress", 1100, 1500, None),
    ("density.native.scan", 1150, 1250, None),
    ("density.native.decode", 1300, 1450, None),
    ("density.engine.plan", 2500, 2600, None),  # a probe's, after both
    ("k1", 120, 140, 0),
]


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


def test_self_time_less_the_child_spans():
    got = dict(spans.self_times(spans.in_bounds(EVENTS, 0, 400)))
    assert got["container.compress"] == 370 - 350  # the share covers 350
    assert got["sharding.share"] == 350 - 60 - 200 - 70
    assert got["sharding.stage"] == 60 - 30
    assert got["wait.to_card"] == 30  # the op inside is not a span
    assert got["engine.encode"] == 200 - 90 - 50 - 40
    assert got["sharding.fetch"] == 70 - 20


def test_layers_per_call_over_the_half():
    ctx = Ctx()
    # container: (20 + 280) ns over 2 calls
    assert spans.layer_ms(ctx, "compress", "container") == \
        pytest.approx(150e-6)
    assert spans.layer_ms(ctx, "compress", "wait") == pytest.approx(50e-6)
    assert spans.layer_ms(ctx, "compress", "engine") == \
        pytest.approx((20 + 90 + 40 + 100) / 2 / 1e6)
    assert spans.layer_ms(ctx, "compress", "native") == 0
    # the layers add up to the roots, 370 + 380 ns
    half = spans.half_spans(ctx, "compress")
    assert sum(spans.by_layer(half).values()) == 750
    # the decompress half: its own spans only, the probe's left out
    assert spans.layer_ms(ctx, "decompress", "native") == \
        pytest.approx(250e-6)
    assert spans.layer_ms(ctx, "decompress", "container") == \
        pytest.approx(150e-6)


def test_counts_per_call():
    ctx = Ctx()
    assert spans.count(ctx, "compress", ("engine.plan",)) == 1.5
    assert spans.count(ctx, "compress", ("wait.",)) == 1.5
    assert spans.count(ctx, "decompress", ("engine.plan",)) == 0
    assert spans.root_share(ctx, "compress") == pytest.approx(750 / 790)


def test_no_reading_over_several_cards_or_without_spans():
    ctx = Ctx(cards=(0, 1))
    assert spans.layer_ms(ctx, "compress", "container") is None
    assert spans.count(ctx, "compress", ("wait.",)) is None
    assert "thread id" in ctx.lines[0]
    bare = Ctx([e for e in EVENTS if not e[0].startswith("density.")])
    assert spans.layer_ms(bare, "compress", "engine") is None
    assert spans.root_share(bare, "compress") is None
    untraced = Ctx()
    untraced.trace = None
    assert spans.layer_ms(untraced, "compress", "engine") is None


@pytest.mark.parametrize("name", [
    "host_ms.container.compress", "host_ms.sharding.compress",
    "host_ms.engine.compress", "wait_ms.compress", "plans_per_call.compress",
    "waits_per_call.compress", "host_ms.container.decompress",
    "host_ms.sharding.decompress", "host_ms.engine.decompress",
    "host_ms.native.decompress", "wait_ms.decompress"])
def test_each_reader_reads_its_layer_and_nothing_without_spans(name):
    read = resolve.reader(name, ROOT)
    assert read(Ctx()) is not None
    bare = Ctx([e for e in EVENTS if not e[0].startswith("density.")])
    assert read(bare) is None


def test_the_summary_line():
    line = spans.summary(Ctx(), "compress")
    assert "cover 94.94%" in line and "sum to 100.000%" in line
    assert line.endswith("ms a call: container 0.0001, engine 0.0001, "
                         "sharding 0.0001, wait 0.0001")
    assert spans.summary(Ctx(cards=(0, 1)), "compress") is None
