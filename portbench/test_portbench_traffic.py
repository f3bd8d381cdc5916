"""The traffic generator: seeded, repeatable, the same work on every seed."""
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from portbench import loadgen

TRAFFIC = Path(__file__).resolve().parent / "traffic"
MIXES = sorted(p.stem for p in TRAFFIC.glob("*.json"))


def _mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


def _take(mix, seed, n, vocab=1000):
    s = loadgen.Stream(mix, seed, vocab)
    return [s.take() for _ in range(n)]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a, b = _take(_mix(name), 2**31 + 17, 50), _take(_mix(name), 2**31 + 17, 50)
    assert [(r.prompt, r.max_new) for r in a] == \
        [(r.prompt, r.max_new) for r in b]


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_other_order_and_tokens(name):
    a, b = _take(_mix(name), 1, 50), _take(_mix(name), 2, 50)
    assert [r.prompt for r in a] != [r.prompt for r in b]
    assert [(len(r.prompt), r.max_new) for r in a] != \
        [(len(r.prompt), r.max_new) for r in b]


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_serves_the_same_sizes(name):
    mix = _mix(name)
    n = mix["lengths"]["pool"]
    sizes = [Counter((len(r.prompt), r.max_new) for r in _take(mix, s, n))
             for s in (3, -5, 2**40 + 1)]
    assert sizes[0] == sizes[1] == sizes[2]


@pytest.mark.parametrize("name", MIXES)
def test_lengths_follow_the_mix(name):
    mix = _mix(name)
    ln = mix["lengths"]
    pool = loadgen.pool(mix).reshape(-1, 2)
    for col, key in ((0, "prompt"), (1, "output")):
        d = ln[key]
        assert pool[:, col].min() >= d["min"] and pool[:, col].max() <= d["max"]
        # the median of the stratified quantiles is the distribution's
        assert abs(np.median(pool[:, col]) - d["median"]) <= 1
    # the longest request fits a slot of the mix's engine
    assert loadgen.pool(mix).sum(axis=-1).max() <= mix["engine"]["capacity"]


def test_token_ids_cover_the_vocabulary():
    mix = _mix(MIXES[0])
    toks = np.concatenate([r.prompt for r in _take(mix, 9, 40, vocab=64000)])
    assert toks.min() >= 0 and toks.max() < 64000
    assert toks.max() > 60000 and toks.min() < 4000


@pytest.mark.parametrize("arrivals", [{"kind": "poisson", "rate": 4.0},
                                      {"kind": "gamma", "rate": 4, "cv": 3}])
def test_only_closed_loops_are_generated(arrivals):
    with pytest.raises(ValueError, match="closed"):
        loadgen.Stream(dict(_mix(MIXES[0]), arrivals=arrivals), 1, 100)


@pytest.mark.parametrize("name", MIXES)
def test_every_block_holds_one_request_of_each_stratum(name):
    mix = _mix(name)
    ln = mix["lengths"]
    blocks = loadgen.pool(mix)
    k, b = blocks.shape[:2]
    for col, key in ((0, "prompt"), (1, "output")):
        strata = loadgen.lengths(ln[key], k * b).reshape(b, k)
        lo, hi = strata.min(axis=1), strata.max(axis=1)
        for blk in blocks[:, :, col]:
            v = np.sort(blk)
            assert np.all((lo <= v) & (v <= hi))
    # a window's worth of the stream (two blocks) carries nearly the
    # pool's mean work whatever the seed
    s = loadgen.Stream(mix, 99, 100)
    work = [sum(len(r.prompt) + r.max_new for r in
                (s.take() for _ in range(2 * b))) for _ in range(k // 2)]
    mean = blocks.sum() / (k / 2)
    assert max(abs(w - mean) for w in work) < 0.1 * mean


def test_pool_refuses_a_block_that_does_not_divide_it():
    mix = dict(_mix(MIXES[0]))
    mix["lengths"] = dict(mix["lengths"], pool=2047)
    with pytest.raises(ValueError):
        loadgen.pool(mix)
