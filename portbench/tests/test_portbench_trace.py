"""The trace reduction on events made by hand: busy and idle shares,
overlap across cards, kernel counts, and idle gaps named by the host op
open at their middle."""

import pytest

from portbench_tiny import ROOT  # noqa: F401 - puts the checkout on the path
from portbench.trace import Trace

EVENTS = [
    ("portbench.half.compress", 0, 100, None),
    ("portbench.half.decompress", 100, 200, None),
    ("portbench.compress", 5, 95, None),
    ("aten::copy_", 20, 60, None),
    ("k1", 10, 20, 0), ("k1", 15, 30, 0), ("Memcpy HtoD", 40, 50, 0),
    ("k2", 12, 45, 1), ("k2", 150, 160, 0),
]


def test_idle_overlap_and_kernels():
    t = Trace(EVENTS, [0, 1])
    assert t.window() == (0, 200)
    # card 0 busy 30 of 100, card 1 busy 33 of 100 in the compress half
    assert t.idle_pct("compress") == pytest.approx(68.5)
    assert t.idle_pct("decompress") == pytest.approx(95.0)
    assert t.overlap_pct("compress") == pytest.approx(23.0)
    assert t.kernel_events("compress") == 3  # the copy left out
    assert t.kernels_named(["k2"], 0, 200) == 2
    assert t.busy_s(0, 0, 200) == pytest.approx(40e-9)


def test_breakdown():
    t = Trace(EVENTS, [0, 1])
    ops = dict(t.device_ops())
    assert ops["k2"] == pytest.approx(43e-9)
    gaps = dict(t.idle_gaps())
    # card 0's gap 30-40 lies inside aten::copy_ (20-60)
    assert gaps["compress: aten::copy_"] == pytest.approx(10e-9)
    # gaps whose middle lies inside only the request's span (5-95) are
    # the port's own code: card 0's 0-10 and card 1's 0-12
    assert gaps["compress: no op open"] == pytest.approx(22e-9)
    assert "decompress: no span" in gaps


def test_a_card_without_events_is_idle_throughout():
    t = Trace(EVENTS, [0, 1, 2])
    assert t.idle_pct("decompress") == pytest.approx((90 + 100 + 100) / 3)


def test_a_probe_is_read_from_its_span():
    from portbench import probes
    span = probes.PROBE_SPAN + "k"
    probe = [(span, 300, 400, None),
             ("k_kernel", 310, 320, 0), ("k_kernel", 320, 334, 0),
             ("Memset", 334, 336, 0), ("k_kernel", 390, 450, 0)]
    t = Trace(EVENTS + probe, [0, 1])
    assert t.window() == (0, 200)  # the probe lies outside the window
    # ... and leaves the window's breakdown as it was
    assert t.idle_gaps() == Trace(EVENTS, [0, 1]).idle_gaps()
    # 3 kernels and a memset in the span, over 3 calls: 86 ns, in ms
    assert probes.probe_ms(t, "k", ("k_kernel",), 3, 3) == pytest.approx(
        86e-6 / 3)
    # a launch the trace lost: no reading
    assert probes.probe_ms(t, "k", ("k_kernel",), 3, 4) is None
    assert probes.probe_ms(t, "k", ("k_kernel",), 2, 2) is None
