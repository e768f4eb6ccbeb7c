"""The port's spans (`density_tpu_torch/tracing.py`) on the CPU: their
names and nesting under a `torch.profiler` session, the layers' self
times against each call's root, nothing entered while no session
records, the share workers' spans in the caller's session, and the
plans they count. Inputs of 64-256 KiB on `device="cpu"`."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from density_tpu_torch import container, tracing
from density_tpu_torch.engine import layout
from density_tpu_torch.parallel import sharding
from portbench import spans as span_reader

STREAM = 65536
CODECS = ("chameleon", "cheetah", "lion")


def _text(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"the quick brown fox ", b"jumps over ", b"lazy dog ",
             b"lorem ipsum "]
    return b"".join(words[i] for i in rng.integers(0, 4, n // 8 + 1))[:n]


def _mixed(seed: int, n: int) -> bytes:
    """Text and random bytes in turns of 5000: adjacent incompressible
    blocks, so the encode's certificate fails and the fixed point runs
    masked plans."""
    rng = np.random.default_rng(seed)
    text = _text(seed, n)
    rand = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    return b"".join(text[i:i + 5000] + rand[i:i + 5000]
                    for i in range(0, n, 10000))[:n]


def _spans(prof) -> list:
    """(name without `density.`, start, end, thread) of the session's
    spans, in order of start."""
    return sorted(((e.name()[len(tracing.PREFIX):], e.start_ns(),
                    e.start_ns() + e.duration_ns(), e.start_thread_id())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(tracing.PREFIX)),
                  key=lambda x: (x[1], -x[2]))


def _calls(spans: list) -> dict:
    """Each root (`container.*`) with the spans inside it: {root: [...]}."""
    return {r: [s for s in spans if r[1] <= s[1] and s[2] <= r[2]
                and s is not r]
            for r in spans if r[0].startswith("container.")}


@pytest.fixture(scope="module")
def traced():
    """Per codec, the spans of one compress and one decompress of a text
    in one profiler session."""
    out = {}
    for codec in CODECS:
        data = _text(5, 2 * STREAM + 1000)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            blob = container.compress(data, codec, STREAM, device="cpu")
            back = container.decompress(blob, device="cpu")
        assert back == data
        assert blob == container.compress(data, codec, STREAM, device="cpu")
        out[codec] = _spans(prof)
    return out


# chameleon decodes on the card; cheetah's and lion's text, of many
# predicted tokens, on the native runtime's pool (`sharding.route`)
DECODE = {"chameleon": {"native.scan", "sharding.share", "sharding.stage",
                        "engine.decode", "sharding.fetch", "sharding.join",
                        "wait.to_card", "wait.read"},
          "cheetah": {"native.scan", "native.pool"},
          "lion": {"native.scan", "native.pool"}}
# cheetah's planner scans its MTF-2 dictionaries in a span of their own
PLAN = {"cheetah": {"engine.mtf2"}}


@pytest.mark.parametrize("codec", CODECS)
def test_calls_emit_their_spans_under_their_roots(traced, codec):
    spans = traced[codec]
    calls = _calls(spans)
    assert sorted(r[0] for r in calls) == ["container.compress",
                                           "container.decompress"]
    inside = {s for got in calls.values() for s in got}
    assert inside | set(calls) == set(spans)  # no span outside a call
    names = {r[0]: {s[0] for s in got} for r, got in calls.items()}
    # two batches: the full streams and the ragged tail
    assert names["container.compress"] == {
        "sharding.share", "sharding.stage", "sharding.fetch",
        "engine.encode", "engine.plan", "wait.to_card",
        "wait.read"} | PLAN.get(codec, set())
    assert names["container.decompress"] == DECODE[codec]
    compress = calls[next(r for r in calls if r[0] == "container.compress")]
    plans = [s for s in compress if s[0] == "engine.plan"]
    assert len(plans) == 2
    # one MTF-2 scan inside each copy-free plan
    scans = [s for s in compress if s[0] == "engine.mtf2"]
    assert len(scans) == (2 if PLAN.get(codec) else 0)
    assert all(sum(p[1] <= s[1] and s[2] <= p[2] for p in plans) == 1
               for s in scans)
    assert len({s[3] for s in spans}) == 1  # one device: one thread


@pytest.mark.parametrize("codec", CODECS)
def test_layer_self_times_add_up_to_the_root(traced, codec):
    for root, got in _calls(traced[codec]).items():
        flat = [(n, s, e) for n, s, e, _ in [root] + got]
        layers = span_reader.by_layer(flat)
        assert sum(layers.values()) == root[2] - root[1]
        assert set(layers) <= {"container", "sharding", "engine", "native",
                               "wait"}
        assert all(t >= 0 for _, t in span_reader.self_times(flat))
        # the waits are leaves: no span below a `wait.*` span
        for n, s, e, _ in got:
            if n.startswith("wait."):
                assert not [x for x in got
                            if x[1] >= s and x[2] <= e and x[1:3] != (s, e)]


@pytest.mark.parametrize("device", ["cpu", ["cpu", "cpu"]])
def test_no_session_enters_no_record_function(monkeypatch, device):
    """While no profiler records, a span enters nothing: the no-op
    context comes back after one check."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no session")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not tracing.recording()
    assert tracing.span("wait.read") is tracing.span("engine.plan")
    data = _mixed(6, 2 * STREAM + 1000)
    for codec in CODECS:
        blob = container.compress(data, codec, STREAM, device=device)
        assert container.decompress(blob, device=device) == data


def test_share_workers_spans_reach_the_session():
    """Over several devices each share's task runs in a worker; the
    caller's profiler session records the workers' spans and ops."""
    data = _text(7, 3 * STREAM + 1000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        blob = container.compress(data, "chameleon", STREAM,
                                  device=["cpu", "cpu"])
        assert container.decompress(blob, device=["cpu", "cpu"]) == data
    assert blob == container.compress(data, "chameleon", STREAM,
                                      device="cpu")
    spans = _spans(prof)
    roots = [s for s in spans if s[0].startswith("container.")]
    shares = [s for s in spans if s[0] == "sharding.share"]
    # compress: two shares of the full streams and the tail's batch;
    # decompress: two shares
    assert len(shares) == 5
    caller = {r[3] for r in roots}
    assert len(caller) == 1 and not caller & {s[3] for s in shares}
    assert len({s[3] for s in shares}) >= 2
    for share in shares:
        assert any(r[1] <= share[1] and share[2] <= r[2] for r in roots)
        below = [s for s in spans if s[3] == share[3]
                 and share[1] <= s[1] and s[2] <= share[2] and s is not share]
        assert {"sharding.stage", "wait.to_card"} <= {s[0] for s in below}
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.start_thread_id() in {s[3] for s in shares}
           and e.name().startswith("aten::")]
    assert ops


def test_plans_per_call_counts_the_masked_plans(monkeypatch):
    """Lion on text and random bytes in turns: the fixed point re-plans
    under a copy-block hypothesis; the spans count every copy-free and
    masked plan that ran."""
    ran = {"fused": 0, "plan_masked": 0}
    for name in ran:
        fn = getattr(layout, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            ran[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(layout, name, counted)
    data = _mixed(8, 2 * STREAM + 1000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        container.compress(data, "lion", STREAM, device="cpu")
    flat = [(n, s, e) for n, s, e, _ in _spans(prof)]
    assert ran["plan_masked"] > 0
    assert sum(n.startswith(("engine.plan",)) for n, _, _ in flat) == \
        ran["fused"] + ran["plan_masked"]
    assert sum(n == "engine.plan_masked" for n, _, _ in flat) == \
        ran["plan_masked"]


def test_resolve_rounds_are_spans_of_the_device_decode(monkeypatch):
    """Lion's device decode (the route forced): each round of the resolve
    fixpoint is an `engine.resolve_round` span inside `engine.decode`."""
    from density_tpu_torch.codecs import lion
    rounds = []
    resolve = lion.resolve

    def counted(*args, **kwargs):
        got = resolve(*args, **kwargs)
        rounds.append(got[2])
        return got
    monkeypatch.setattr(lion, "resolve", counted)
    monkeypatch.setattr(sharding, "PREDICTED_DEVICE_CUTOFF", 1.0)
    data = _mixed(9, 16384)
    blob = container.compress(data, "lion", 16384, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert container.decompress(blob, device="cpu") == data
    spans = _spans(prof)
    (decode,) = [s for s in spans if s[0] == "engine.decode"]
    got = [s for s in spans if s[0] == "engine.resolve_round"]
    assert rounds and len(got) == sum(rounds)
    assert all(decode[1] <= s[1] and s[2] <= decode[2] for s in got)


def test_cheetah_scans_its_dictionaries_once_in_every_plan():
    """Cheetah on text and random bytes in turns: each copy-free plan and
    each masked plan of the fixed point holds one `engine.mtf2` span."""
    data = _mixed(10, 2 * STREAM + 1000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        container.compress(data, "cheetah", STREAM, device="cpu")
    spans = _spans(prof)
    plans = [s for s in spans if s[0].startswith("engine.plan")]
    scans = [s for s in spans if s[0] == "engine.mtf2"]
    assert any(p[0] == "engine.plan_masked" for p in plans)
    assert len(scans) == len(plans)
    for p in plans:
        assert sum(p[1] <= s[1] and s[2] <= p[2] for s in scans) == 1
