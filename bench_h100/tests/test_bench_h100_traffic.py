"""The traffic generator: a seed fixes the requests, and every seed gets the
same sizes in another order."""

import json
import os

import numpy as np
import pytest

from conftest import BENCH, tiny
from h100bench.traffic import Traffic, size_grid


def _spec(name):
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("mix", ["chat-c32", "docqa-c16"])
def test_closed_stream_repeats_for_a_seed(mix):
    spec = _spec(mix)
    a, b = Traffic(spec, 2**31 + 7, 1000), Traffic(spec, 2**31 + 7, 1000)
    ra = [a.next() for _ in range(40)]
    rb = [b.next() for _ in range(40)]
    assert [(r.ids, r.max_tokens) for r in ra] == \
        [(r.ids, r.max_tokens) for r in rb]
    c = Traffic(spec, 5, 1000)
    assert [r.ids for r in (c.next() for _ in range(40))] != \
        [r.ids for r in ra]


@pytest.mark.parametrize("mix", ["chat-c32", "docqa-c16"])
def test_closed_blocks_hold_the_same_sizes_for_every_seed(mix):
    """The same sizes in every block; their order is the seed's where the
    mix says ``order: "seed"``, else the same for every seed."""
    spec = _spec(mix)
    g = spec["grid"]
    blocks = []
    for seed in (0, 1, 2**40 + 3):
        t = Traffic(spec, seed, 1000)
        blocks.append([t.next_size() for _ in range(g)])
    for blk in blocks[1:]:
        assert sorted(p for p, _ in blk) == sorted(p for p, _ in blocks[0])
        assert sorted(o for _, o in blk) == sorted(o for _, o in blocks[0])
    assert (blocks[0] != blocks[1]) == (spec["order"] == "seed")
    lens = [p for p, _ in blocks[0]]
    assert min(lens) >= spec["prompt"]["min"]
    assert max(lens) <= spec["prompt"]["max"]


def test_grids():
    s = size_grid({"median": 100, "sigma": 0.5, "min": 10, "max": 400}, 101)
    assert s[50] == 100 and (np.diff(s) >= 0).all()


def test_ids_avoid_the_banned_ids():
    spec = tiny("tiny-closed")
    t = Traffic(spec, 3, 64)
    ids = [i for _ in range(50) for i in t.next().ids]
    assert min(ids) >= 3 and max(ids) < 64
