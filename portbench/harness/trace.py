"""Spans from the benchmark's own files, and the profiler slice.

Spans mark the calls the drivers make into the program's layers
(``portbench.step``, ``portbench.optimizer``, ...).  They are
``torch.profiler.record_function`` ranges, so they cost nothing outside the
profiled slice.  The slice is ``torch.profiler`` (CPU and CUDA activity)
over a steady part of a ``--trace 1`` run; its Chrome trace is read back
into kernel intervals, launch times, spans and CPU operations, and the file
is deleted.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

SLICE = "portbench.slice"


class Tracer:
    def __init__(self):
        self._prof = None
        self._slice = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    @contextlib.contextmanager
    def span(self, name: str):
        if self._prof is None:
            yield
            return
        import torch
        with torch.profiler.record_function("portbench." + name):
            yield

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._slice = torch.profiler.record_function(SLICE)
        self._slice.__enter__()

    def stop(self) -> Dict:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._slice.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._prof = None
        return parse(events)


def parse(events: List[Dict]) -> Dict:
    """Kernel intervals and launches, spans, CPU operations and the slice's
    bounds, in seconds on the trace's clock."""
    kernels, other_dev, cpu_ops, spans = [], [], [], []
    launches: Dict[int, float] = {}
    window = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev["ts"]) * 1e-6, float(ev.get("dur", 0)) * 1e-6
        args = ev.get("args") or {}
        if cat == "kernel":
            kernels.append((name, ts, dur, args.get("correlation")))
        elif cat in ("gpu_memcpy", "gpu_memset"):
            other_dev.append((name, ts, dur))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if args.get("correlation") is not None:
                launches[args["correlation"]] = ts
        elif cat == "user_annotation":
            if name == SLICE:
                window = (ts, ts + dur)
            elif name.startswith("portbench."):
                spans.append((name[len("portbench."):], ts, ts + dur))
        elif cat == "cpu_op":
            cpu_ops.append((name, ts, ts + dur))
    if window is None:
        raise RuntimeError("the profiler's trace holds no slice annotation")
    busy = union([(ts, ts + d) for _, ts, d, _ in kernels]
                 + [(ts, ts + d) for _, ts, d in other_dev], window)
    return {"window": window, "kernels": kernels, "other_device": other_dev,
            "launches": launches, "spans": spans, "cpu_ops": cpu_ops,
            "busy": busy}


def union(intervals, window) -> List[Tuple[float, float]]:
    """The union of ``intervals`` clipped to ``window``, sorted, disjoint."""
    lo, hi = window
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(busy, a: float, b: float) -> float:
    """Seconds of [a, b] that the sorted disjoint ``busy`` covers."""
    i = bisect.bisect_left(busy, (a,)) - 1
    total = 0.0
    for s, e in busy[max(i, 0):]:
        if s >= b:
            break
        total += max(0.0, min(e, b) - max(s, a))
    return total


def gaps(busy, window) -> List[Tuple[float, float]]:
    out, t = [], window[0]
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if window[1] > t:
        out.append((t, window[1]))
    return out


def _innermost(items, t: float) -> Optional[str]:
    best = None
    for name, a, b in items:
        if a <= t < b and (best is None or a >= best[1]):
            best = (name, a)
    return best[0] if best else None


def breakdown(prof: Dict, top: int = 10) -> Dict:
    """The device operations that took most time, by kernel name, and the
    longest idle gaps, each named by the benchmark span and the innermost
    CPU operation the host was in when the gap began."""
    by_name: Dict[str, float] = {}
    for name, ts, dur, _ in prof["kernels"]:
        by_name[name] = by_name.get(name, 0.0) + dur
    for name, ts, dur in prof["other_device"]:
        by_name[name] = by_name.get(name, 0.0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(prof["busy"], prof["window"]),
                  key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in idle:
        span = _innermost(prof["spans"], a) or "outside spans"
        op = _innermost(prof["cpu_ops"], a) or "python"
        named.append([f"{span} / {op}"[:200], b - a])
    return {"device_ops": [[n[:200], s] for n, s in ops], "idle_gaps": named}


def kernels_by_span(prof: Dict, span_name: str) -> List[List]:
    """For each span named ``span_name``, in order, the kernels whose launch
    call lies inside it."""
    spans = sorted((a, b) for n, a, b in prof["spans"] if n == span_name)
    starts = [a for a, _ in spans]
    out: List[List] = [[] for _ in spans]
    for k in prof["kernels"]:
        t = prof["launches"].get(k[3])
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < spans[i][1]:
            out[i].append(k)
    return out


def kernels_launched_in(prof: Dict, span_name: str):
    """Kernels whose launch call lies inside a span named ``span_name``."""
    return [k for ks in kernels_by_span(prof, span_name) for k in ks]
