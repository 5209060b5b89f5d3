"""The one generator of request schedules, driven by a traffic file.

Every seed gets the same sizes (prompt and output lengths drawn from the
file's own ``sizes_seed``) in the same order and, in an open loop, the same
gaps between arrivals, scaled so that they sum to the schedule's length; the
run's ``--seed`` draws the token ids (and, elsewhere, the weights).  So two
seeds do the same work and warm the same prompt lengths: the port's prefill
time depends steeply on the prompt length (its MoE capacity groups), and a
seed that reordered the lengths would change how much of that work falls in
the window.

Lengths are drawn in blocks of (prompt, output) pairs, so the first ``n``
pairs are the same whatever ``n`` is.  A length spec with ``min`` and
``max`` clips to them; a file's ``prune`` drops a pair instead, as a
dataset's sampler drops a conversation that is too short or too long.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

BLOCK = 1024


@dataclasses.dataclass
class Planned:
    rid: int
    due: float            # seconds after the traffic starts
    prompt: np.ndarray    # (L,) int32 token ids
    max_new: int


def lognormal_lengths(rng, spec: Dict, n: int) -> np.ndarray:
    """``n`` lengths ``round(median * exp(sigma * N(0, 1)))``, clipped to
    ``[min, max]`` where the spec gives them."""
    raw = np.rint(spec["median"] * np.exp(spec["sigma"]
                                          * rng.standard_normal(n)))
    if "min" in spec:
        raw = np.clip(raw, spec["min"], spec["max"])
    return raw.astype(np.int64)


def kept(prune: Dict, prompts: np.ndarray, outputs: np.ndarray) -> np.ndarray:
    """Which pairs a ``prune`` rule keeps: prompt and output lengths within
    their bounds and together at most ``total_max``."""
    return ((prompts >= prune["prompt_min"]) & (prompts <= prune["prompt_max"])
            & (outputs >= prune["output_min"])
            & (prompts + outputs <= prune["total_max"]))


def request_count(traffic: Dict, seconds: float) -> int:
    if traffic["driver"] == "open_loop":
        return max(1, int(round(traffic["rate_per_s"]
                                * (traffic["ramp_s"] + seconds))))
    if traffic["driver"] == "saturated":
        return int(traffic["backlog_requests"])
    raise ValueError(f"driver {traffic['driver']!r} sends no requests")


def sizes(traffic: Dict, n: int):
    """(prompt lengths, output lengths, gaps) in the order drawn from the
    file's ``sizes_seed``; gaps are None for a backlog due at t = 0."""
    rng = np.random.default_rng(traffic["sizes_seed"])
    prompts, outputs, have = [], [], 0
    while have < n:
        p = lognormal_lengths(rng, traffic["prompt_tokens"], BLOCK)
        o = lognormal_lengths(rng, traffic["output_tokens"], BLOCK)
        if "prune" in traffic:
            keep = kept(traffic["prune"], p, o)
            p, o = p[keep], o[keep]
        prompts.append(p)
        outputs.append(o)
        have += len(p)
    prompts = np.concatenate(prompts)[:n]
    outputs = np.concatenate(outputs)[:n]
    gaps = None
    if traffic["driver"] == "open_loop":
        raw = rng.exponential(1.0, n)
        gaps = raw * (n / traffic["rate_per_s"]) / raw.sum()
    return prompts, outputs, gaps


def schedule(traffic: Dict, seconds: float, seed: int,
             vocab: int) -> List[Planned]:
    n = request_count(traffic, seconds)
    prompts, outputs, gaps = sizes(traffic, n)
    rng = np.random.default_rng(seed)
    dues = np.zeros(n) if gaps is None else np.cumsum(gaps)
    return [Planned(rid=rid, due=float(dues[rid]),
                    prompt=rng.integers(0, vocab, size=int(prompts[rid]))
                    .astype(np.int32),
                    max_new=int(outputs[rid]))
            for rid in range(n)]


def longest_context(traffic: Dict) -> int:
    """The most tokens a request of the mix holds: prompt and output."""
    if "prune" in traffic:
        return traffic["prune"]["total_max"]
    return traffic["prompt_tokens"]["max"] + traffic["output_tokens"]["max"]
