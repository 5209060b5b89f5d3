"""What the metric files read from a run's record.

Host-clock numbers use every sample of the window (``[w0, w1]``, or for
per-layer numbers of a traced run the part before the profiled slice);
trace numbers use the profiled slice.  A reader that finds nothing to read
returns None, and the metric is left out of the result.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from harness import roofline
from harness.trace import covered, kernels_by_span, kernels_launched_in


def ms(seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else 1e3 * seconds


def percentile(values: List[float], q: float) -> Optional[float]:
    """numpy's linear percentile of every sample, or None for none."""
    return float(np.percentile(np.asarray(values, float), q)) \
        if len(values) else None


# -- serving, host clock ------------------------------------------------------

def _clean(record: Dict):
    return record["window"][0], record["clean_end"]


def output_tokens_per_s(record: Dict) -> Optional[float]:
    w0, w1 = record["window"]
    n = sum(1 for r in record["requests"] for t in r["times"]
            if w0 <= t <= w1)
    return n / (w1 - w0) if n else None


def ttft_s(record: Dict, w0: float, w1: float) -> List[float]:
    """Due to first token for every request due in [w0, w1); a request with
    no first token by w1 counts its wait so far."""
    out = []
    for r in record["requests"]:
        if w0 <= r["due"] < w1:
            first = r["times"][0] if r["times"] and r["times"][0] <= w1 \
                else w1
            out.append(first - r["due"])
    return out


def itl_s(record: Dict, w0: float, w1: float) -> List[float]:
    """Every gap between consecutive tokens of a request that ends in
    [w0, w1]."""
    return [b - a for r in record["requests"]
            for a, b in zip(r["times"], r["times"][1:]) if w0 <= b <= w1]


def queue_wait_s(record: Dict) -> List[float]:
    """Due to the start of the step that admitted the request, for every
    request due in the clean window; one still queued at its end counts its
    wait so far."""
    w0, w1 = _clean(record)
    steps = record["steps"]
    out = []
    for r in record["requests"]:
        if not w0 <= r["due"] < w1:
            continue
        i = r["admitted_step"]
        start = steps[i]["t0"] if i is not None and steps[i]["t0"] <= w1 \
            else w1
        out.append(start - r["due"])
    return out


def _between_snapshots(record: Dict):
    s0, s1 = record["snapshots"]
    return s0, s1, record["steps"][s0["step"]:s1["step"]]


def prefill_ms(record: Dict) -> Optional[float]:
    s0, s1, steps = _between_snapshots(record)
    admissions = sum(len(s["admitted"]) for s in steps)
    if not admissions:
        return None
    return 1e3 * (s1["phase"]["prefill"] - s0["phase"]["prefill"]) \
        / admissions


def decode_step_ms(record: Dict) -> Optional[float]:
    s0, s1, steps = _between_snapshots(record)
    decodes = sum(1 for s in steps if s["active"])
    if not decodes:
        return None
    return 1e3 * (s1["phase"]["decode"] - s0["phase"]["decode"]) / decodes


def launches_per_step(record: Dict) -> Optional[float]:
    s0, s1, steps = _between_snapshots(record)
    return (s1["launches"] - s0["launches"]) / len(steps) if steps else None


def serve_mfu(record: Dict) -> Optional[float]:
    """Model FLOPs of every token emitted in the clean window over its
    seconds at the bf16 peak, %."""
    w0, w1 = _clean(record)
    cfg = record["cfg"]
    flops = 0.0
    for r in record["requests"]:
        for j, t in enumerate(r["times"]):
            if w0 <= t <= w1:
                flops += roofline.prefill_flops(cfg, r["prompt_len"]) if j == 0 \
                    else roofline.decode_flops(cfg, r["prompt_len"] + j - 1)
    if not flops:
        return None
    return 100.0 * flops / ((w1 - w0) * roofline.PEAK_FLOPS["bfloat16"])


# -- training, host clock -----------------------------------------------------

def train_tokens_per_s(record: Dict) -> Optional[float]:
    ends = record["step_ends"]
    return len(ends) * record["tokens_per_step"] / ends[-1] if ends else None


def train_mfu(record: Dict) -> Optional[float]:
    ends, traffic = record["step_ends"], record["traffic"]
    if not ends:
        return None
    flops = roofline.train_step_flops(record["cfg"], traffic["batch"],
                                      traffic["seq"]) * len(ends)
    return 100.0 * flops / (ends[-1] * roofline.PEAK_FLOPS["bfloat16"])


# -- the profiled slice -------------------------------------------------------

def _profile(record: Dict) -> Optional[Dict]:
    prof = record.get("profile")
    return prof if prof and prof["kernels"] else None


def device_idle(record: Dict) -> Optional[float]:
    prof = _profile(record)
    if prof is None:
        return None
    a, b = prof["window"]
    busy = sum(e - s for s, e in prof["busy"])
    return 100.0 * (b - a - busy) / (b - a)


def family_seconds(prof: Dict, fam: str) -> float:
    return sum(d for name, _, d, _ in prof["kernels"]
               if roofline.family(name) == fam)


def _share(bound: float, measured: float) -> Optional[float]:
    return 100.0 * bound / measured if measured > 0 and bound > 0 else None


def linear_roofline(record: Dict) -> Optional[float]:
    prof = _profile(record)
    if prof is None:
        return None
    t = record["traffic"]
    bound = roofline.linear_train_bound_s(record["cfg"], t["batch"] * t["seq"])
    return _share(bound * record["profile_steps"],
                  family_seconds(prof, "gemm"))


def attention_roofline(record: Dict) -> Optional[float]:
    prof = _profile(record)
    if prof is None:
        return None
    t = record["traffic"]
    bound = roofline.attention_train_bound_s(record["cfg"], t["batch"],
                                             t["seq"])
    return _share(bound * record["profile_steps"],
                  family_seconds(prof, "flash"))


def optimizer_ms(record: Dict) -> Optional[float]:
    prof = _profile(record)
    if prof is None:
        return None
    ks = kernels_launched_in(prof, "optimizer")
    if not ks:
        return None
    return 1e3 * sum(d for _, _, d, _ in ks) / record["profile_steps"]


def expert_roofline(record: Dict) -> Optional[float]:
    """The decode steps' expert work in the slice against the device time
    of the grouped kernels launched inside them.  A decode step is a
    profiled ``step`` that admitted nothing, so no prefill shares it; its
    expert work is that of its active slots' tokens."""
    prof = _profile(record)
    if prof is None:
        return None
    traced = [s for s in record["steps"] if s.get("traced")]
    per_span = kernels_by_span(prof, "step")
    if len(per_span) != len(traced):
        raise RuntimeError(f"{len(per_span)} step spans in the trace for "
                           f"{len(traced)} profiled steps")
    cfg, bound, measured = record["cfg"], 0.0, 0.0
    for s, ks in zip(traced, per_span):
        if s["admitted"] or not s["active"]:
            continue
        bound += roofline.expert_bound_s(cfg, s["active"])
        measured += sum(d for name, _, d, _ in ks
                        if roofline.family(name) == "grouped")
    return _share(bound, measured)


def host_ms_per_step(record: Dict) -> Optional[float]:
    """Mean over the slice's ``step`` spans of their wall time less the
    device's busy time inside them."""
    prof = _profile(record)
    if prof is None:
        return None
    spans = [(a, b) for n, a, b in prof["spans"] if n == "step"]
    if not spans:
        return None
    host = [(b - a) - covered(prof["busy"], a, b) for a, b in spans]
    return 1e3 * sum(host) / len(host)
