"""The seeded objects: the same seed gives the same requests, seeds
differ in order, and the mixes' sizes and contents follow their specs."""

import json

import numpy as np

from portbench_tiny import ROOT
from portbench import objects, resolve

MIX = {"loop": "closed", "distinct": 5, "content_seed": 99, "check": {},
       "object_bytes": {"kind": "fixed", "bytes": 30_000},
       "content": {"kind": "stdlib_text"}}
CONFIG = {"call_bytes": 1000}


def test_a_seed_repeats_its_objects_and_order():
    big = 2**31 + 12345
    assert objects.make(MIX, CONFIG, big) == objects.make(MIX, CONFIG, big)


def test_seeds_differ_in_where_the_cycle_starts():
    assert objects.make(MIX, CONFIG, 1)[0] == objects.make(MIX, CONFIG, 2)[0]
    # the same work for every seed ...
    orders = {tuple(objects.make(MIX, CONFIG, s)[1]) for s in range(6)}
    assert len(orders) > 1  # ... from another start of one cycle
    cycle = orders.pop()
    for order in orders:
        k = order.index(cycle[0])
        assert order[k:] + order[:k] == cycle


def test_call_objects_take_the_configurations_call():
    """The `call` law takes the configuration's call, which a sharded
    configuration states for all its cards."""
    mix = dict(MIX, object_bytes={"kind": "call"})
    assert objects.sizes(mix, {"call_bytes": 4000}) == [4000] * 5


def test_the_content_seed_draws_the_text():
    other = dict(MIX, content_seed=100)
    assert objects.make(MIX, CONFIG, 1)[0] != objects.make(other, CONFIG, 1)[0]


def test_the_mixes_sizes():
    def config(name):
        return resolve.load_json(ROOT / f"portbench/configs/{name}.json")
    bulk = json.loads((ROOT / "portbench/traffic/bulk.json").read_text())
    assert set(objects.sizes(bulk, config("chameleon-256k"))) == {10_192_446}
    assert set(objects.sizes(bulk, config("lion-256k"))) == {10_192_446}
    assert set(objects.sizes(bulk, config("chameleon-256k-x4"))) == {
        40_769_784}
    mix = json.loads((ROOT / "portbench/traffic/objects.json").read_text())
    assert objects.sizes(mix, config("chameleon-256k")) == [128 << 10] * 64


def test_objects_are_text_of_their_size():
    objs, order = objects.make(MIX, CONFIG, 7)
    assert sorted(order) == list(range(5))
    assert all(len(o) == 30_000 for o in objs)
    text = resolve.module("content", "stdlib_text", ROOT)
    starts = {src[:64] for src in text.stdlib_sources()}
    assert all(o[:64] in starts for o in objs)  # whole sources, in order


def test_quads_are_drawn_from_their_values():
    mix = dict(MIX, object_bytes={"kind": "fixed", "bytes": 4002},
               content={"kind": "quads", "values": 16})
    objs, _ = objects.make(mix, CONFIG, 3)
    assert all(len(o) == 4002 for o in objs)
    quads = np.frombuffer(b"".join(o[:4000] for o in objs), "<u4")
    assert len(np.unique(quads)) == 16
    noise = dict(mix, content={"kind": "quads"})
    quads = np.frombuffer(objects.make(noise, CONFIG, 3)[0][0][:4000], "<u4")
    assert len(np.unique(quads)) == 1000  # no value repeats
