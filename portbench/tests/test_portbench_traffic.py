"""The traffic generator: deterministic per seed, the same sizes and gaps
for every seed, and draws that match the traffic files."""
import math

import numpy as np
import pytest

from harness import files
from harness.traffic import (kept, lognormal_lengths, longest_context,
                             request_count, schedule, sizes)

# An open loop after the Azure conversation trace (prompts median 1,024,
# outputs 128): the generator's other driver, which no cell runs yet.
OPEN_LOOP = {"driver": "open_loop", "rate_per_s": 2.0, "ramp_s": 20,
             "sizes_seed": 20231101,
             "prompt_tokens": {"median": 1024, "sigma": 0.8, "min": 64,
                               "max": 4096},
             "output_tokens": {"median": 128, "sigma": 0.9, "min": 8,
                               "max": 768}}
MIXES = ["open-loop", "sharegpt-offline"]


def mix(name):
    return dict(OPEN_LOOP) if name == "open-loop" \
        else files.load_data("traffic", name)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_schedule(name):
    t = mix(name)
    a = schedule(t, 40, 2**31 + 17, 32064)
    b = schedule(t, 40, 2**31 + 17, 32064)
    assert [(p.due, p.max_new) for p in a] == [(p.due, p.max_new) for p in b]
    assert all(np.array_equal(p.prompt, q.prompt) for p, q in zip(a, b))


@pytest.mark.parametrize("name", MIXES)
def test_seeds_share_sizes_and_arrivals(name):
    t = mix(name)
    a = schedule(t, 40, 1, 32064)
    b = schedule(t, 40, 2, 32064)
    assert [(len(p.prompt), p.max_new, p.due) for p in a] == \
        [(len(p.prompt), p.max_new, p.due) for p in b]
    assert not any(np.array_equal(p.prompt, q.prompt) for p, q in zip(a, b))


def test_open_loop_rate_and_length():
    t = dict(OPEN_LOOP)
    plan = schedule(t, 40, 5, 32064)
    assert len(plan) == request_count(t, 40)
    assert plan[-1].due == pytest.approx(t["ramp_s"] + 40, rel=1e-9)
    assert all(b.due >= a.due for a, b in zip(plan, plan[1:]))


def test_backlog_is_due_at_start():
    t = files.load_data("traffic", "sharegpt-offline")
    plan = schedule(t, 40, 5, 32064)
    assert len(plan) == t["backlog_requests"]
    assert {p.due for p in plan} == {0.0}


@pytest.mark.parametrize("key", ["prompt_tokens", "output_tokens"])
def test_clipped_lengths_follow_the_spec(key):
    spec = OPEN_LOOP[key]
    got = lognormal_lengths(np.random.default_rng(0), spec, 200_000)
    assert got.min() >= spec["min"] and got.max() <= spec["max"]
    assert np.median(got) == pytest.approx(spec["median"], rel=0.02)
    q = np.quantile(np.log(got), [0.25, 0.75])
    assert (q[1] - q[0]) / 1.349 == pytest.approx(spec["sigma"], rel=0.05)
    # the clipped tails hold the lognormal's mass beyond each end
    for end, share in ((spec["max"], np.mean(got == spec["max"])),
                       (spec["min"], np.mean(got == spec["min"]))):
        z = abs(np.log(end / spec["median"])) / spec["sigma"]
        tail = 0.5 * math.erfc(z / math.sqrt(2))
        assert share == pytest.approx(tail, abs=0.005)


@pytest.mark.parametrize("key", ["prompt_tokens", "output_tokens"])
def test_unclipped_lengths_follow_the_file(key):
    spec = files.load_data("traffic", "sharegpt-offline")[key]
    got = lognormal_lengths(np.random.default_rng(0), spec, 200_000)
    assert np.median(got) == pytest.approx(spec["median"], rel=0.02)
    q = np.quantile(np.log(np.maximum(got, 1)), [0.25, 0.75])
    assert (q[1] - q[0]) / 1.349 == pytest.approx(spec["sigma"], rel=0.05)
    # the file's medians are the source's means under its sigma
    mean = spec["median"] * math.exp(spec["sigma"] ** 2 / 2)
    assert got.mean() == pytest.approx(mean, rel=0.03)


def test_prune_drops_pairs_as_the_file_says():
    t = files.load_data("traffic", "sharegpt-offline")
    rule = t["prune"]
    p, o, gaps = sizes(t, 5000)
    assert gaps is None and len(p) == len(o) == 5000
    assert kept(rule, p, o).all()
    assert p.min() >= rule["prompt_min"] and p.max() <= rule["prompt_max"]
    assert o.min() >= rule["output_min"]
    assert (p + o).max() <= rule["total_max"] == longest_context(t)
    # what the rule drops is the lognormal's mass beyond the bounds, a
    # small share: the kept pairs keep the source's shape
    rng = np.random.default_rng(1)
    raw_p = lognormal_lengths(rng, t["prompt_tokens"], 200_000)
    raw_o = lognormal_lengths(rng, t["output_tokens"], 200_000)
    assert 0.005 < 1 - kept(rule, raw_p, raw_o).mean() < 0.05


@pytest.mark.parametrize("name", MIXES)
def test_a_longer_schedule_extends_a_shorter_one(name):
    t = mix(name)
    short, long = sizes(t, 300), sizes(t, 3000)
    assert np.array_equal(short[0], long[0][:300])
    assert np.array_equal(short[1], long[1][:300])


def test_token_ids_cover_the_vocabulary():
    t = dict(OPEN_LOOP)
    ids = np.concatenate([p.prompt for p in schedule(t, 40, 9, 32064)])
    assert ids.min() >= 0 and ids.max() < 32064
    assert ids.dtype == np.int32


def test_gaps_sum_to_the_schedule():
    t = dict(OPEN_LOOP)
    n = request_count(t, 40)
    _, _, gaps = sizes(t, n)
    assert gaps.sum() == pytest.approx(n / t["rate_per_s"], rel=1e-12)
    # exponential gaps: the coefficient of variation is about 1
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, abs=0.25)
