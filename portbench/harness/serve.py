"""The serving drivers: an open loop on the wall clock, and a saturated
backlog, both through ``ContinuousBatchingEngine.submit`` and ``.step``.

Times are seconds after the traffic starts.  The window is
``[ramp_s, ramp_s + seconds]`` (a saturated backlog: from the end of the
step that makes its ``ramp_admissions``-th admission); a ``--trace 1`` run
profiles its last
``profile_s`` seconds, and reads its host counters over the part before.
A token is stamped at the end of the ``step`` call that emitted it (a
request's first token comes from its prefill, inside the step that admits
it).
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np

from harness import port
from harness.traffic import longest_context, schedule


@dataclasses.dataclass
class Tracked:
    rid: int
    due: float
    prompt: np.ndarray
    max_new: int
    times: List[float] = dataclasses.field(default_factory=list)
    admitted_step: Optional[int] = None
    seq: object = None


def _snapshot(eng, t: float, step_index: int) -> Dict:
    return {"t": t, "step": step_index, "phase": dict(eng.phase_seconds),
            "launches": port.engine_launches()}


def setup(cfg, cfg_file, traffic, seed, device, prompt_lens):
    """The port's model with the benchmark's weights, and an engine warmed
    on ``prompt_lens`` and the decode step."""
    model = port.build_model(cfg, cfg_file, seed, device)
    eng = port.serving_engine(model, slots=traffic["slots"],
                              page_size=traffic["page_size"],
                              max_context=longest_context(traffic))
    eng.warmup(prompt_lens=sorted(set(prompt_lens)))
    return eng


def loop(eng, plan, traffic, seconds, trace, tracer):
    """Drive ``plan`` through ``eng`` until the window (and a traced run's
    slice) ends; returns the record's host-side part and the finished
    requests.  The window starts at ``ramp_s``, or with ``ramp_admissions``
    at the end of the step that makes that many admissions."""
    ramp_admissions = traffic.get("ramp_admissions")
    w0 = math.inf if ramp_admissions else float(traffic["ramp_s"])
    w1 = w0 + seconds
    clean_end = w1 - traffic["profile_s"] if trace else w1
    admissions = 0
    pending = list(reversed(plan))          # popped from the end: by due
    tracked: Dict[int, Tracked] = {}
    steps: List[Dict] = []
    snaps: List[Dict] = []
    t_start = time.perf_counter()
    end = w1
    while True:
        now = time.perf_counter() - t_start
        if now >= end:
            break
        if trace and not tracer.active and now >= clean_end:
            tracer.start()
            # The profiler takes a while to start: the slice runs its
            # full length from when it has.
            end = max(w1, time.perf_counter() - t_start
                      + traffic["profile_s"])
        with tracer.span("submit"):
            while pending and pending[-1].due <= now:
                p = pending.pop()
                tracked[p.rid] = Tracked(p.rid, p.due, p.prompt, p.max_new)
                eng.submit(port.request(p.rid, p.prompt, p.max_new))
        t0 = time.perf_counter() - t_start
        with tracer.span("step"):
            n = eng.step()
        t1 = time.perf_counter() - t_start
        admitted = []
        with tracer.span("poll"):
            for seq in eng.slots:
                if seq is None:
                    continue
                r = tracked[seq.req.rid]
                if r.seq is None:
                    r.seq, r.admitted_step = seq, len(steps)
                    admitted.append(len(r.prompt))
                while len(r.times) < len(seq.generated):
                    r.times.append(t1)
        steps.append({"t0": t0, "t1": t1, "active": n, "admitted": admitted,
                      "traced": tracer.active})
        admissions += len(admitted)
        if ramp_admissions and admissions == len(plan) and t1 < end:
            raise RuntimeError(f"the backlog's {len(plan)} requests were all "
                               "admitted before the window closed: a "
                               "saturated cell needs a larger backlog")
        if w0 == math.inf and admissions >= (ramp_admissions or 0):
            w0, w1 = t1, t1 + seconds
            clean_end = w1 - traffic["profile_s"] if trace else w1
            end = w1
        if (not snaps and t1 >= w0) or (len(snaps) == 1 and t1 >= clean_end):
            snaps.append(_snapshot(eng, t1, len(steps)))
        if n == 0:
            if not pending and w0 == math.inf:
                raise RuntimeError("the backlog ran out before the ramp's "
                                   f"{ramp_admissions} admissions")
            now = time.perf_counter() - t_start
            wait = min(pending[-1].due, end) - now if pending else 1e-3
            if wait > 0:
                with tracer.span("wait"):
                    time.sleep(wait)
    profile = tracer.stop() if tracer.active else None
    if len(snaps) == 1:
        snaps.append(_snapshot(eng, time.perf_counter() - t_start,
                               len(steps)))
    requests = [{"rid": r.rid, "due": r.due, "prompt_len": len(r.prompt),
                 "max_new": r.max_new, "times": r.times,
                 "admitted_step": r.admitted_step}
                for r in sorted(tracked.values(), key=lambda r: r.rid)]
    finished = [{"rid": r.rid, "prompt": r.prompt,
                 "served": list(r.seq.generated[:r.max_new])}
                for r in tracked.values()
                if r.seq is not None and len(r.times) >= r.max_new]
    record = {"window": [w0, w1], "clean_end": clean_end,
              "requests": requests, "steps": steps, "snapshots": snaps,
              "profile": profile,
              "attempted": sum(1 for r in requests
                               if w0 <= r["due"] < w1
                               or any(w0 <= t <= w1 for t in r["times"]))}
    return record, finished


def _window(cfg, cfg_file, traffic, seed, seconds, trace, device, t_proc,
            tracer):
    """Set-up and the window; returns (record, finished requests).  The
    program's objects die with this frame."""
    import torch
    plan = schedule(traffic, seconds, seed, cfg_file["model"]["vocab_size"])
    eng = setup(cfg, cfg_file, traffic, seed, device,
                [len(p.prompt) for p in plan])
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_proc
    record, finished = loop(eng, plan, traffic, seconds, trace, tracer)
    record["setup_s"] = setup_s
    record["memory_peak_bytes"] = torch.cuda.max_memory_allocated() \
        if device == "cuda" else 0
    return record, finished


def sample(finished: List[Dict], count: int, seed: int) -> List[Dict]:
    """The request with the most served tokens, and ``count - 1`` others
    drawn from the seed."""
    if not finished:
        raise RuntimeError("no request finished inside the window")
    ordered = sorted(finished, key=lambda f: f["rid"])
    longest = max(ordered, key=lambda f: (len(f["served"]),
                                          len(f["prompt"])))
    rest = [f for f in ordered if f is not longest]
    rng = np.random.default_rng([int(seed), 1])
    pick = rng.choice(len(rest), size=min(count - 1, len(rest)),
                      replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def run(cfg_file: Dict, traffic: Dict, seed: int, seconds: float,
        trace: bool, device: str, t_proc: float, tracer) -> Dict:
    import torch

    from harness.check import serve_readings
    cfg = port.port_config(cfg_file)
    with port.defaults(device):
        record, finished = _window(cfg, cfg_file, traffic, seed, seconds,
                                   trace, device, t_proc, tracer)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    record["sample"] = sample(finished, traffic["sample_requests"], seed)
    record["check"] = serve_readings(cfg_file["model"], seed,
                                     record["sample"], traffic["slots"],
                                     device)
    return record
