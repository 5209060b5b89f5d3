"""The program's own spans in the profiled slice, and what their readers
share.

The program names its spans ``repro_torch.<name>``, with ``|k=v,k=v``
appended for attributes (``repro_torch/core/trace.py``), and records them as
function-scope profiler events, the kind aten operators are: the slice's
parser files them with the CPU operations, so they reach the record as
``profile["cpu_ops"]`` entries (name, start, end) on the kernels' clock.  A
program that records none gives no spans, and every reader returns None.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from harness.trace import covered, union

PREFIX = "repro_torch."

Span = Tuple[str, Dict, float, float]       # name, attributes, start, end


def _attrs(text: str) -> Dict:
    out: Dict = {}
    for item in filter(None, text.split(",")):
        key, _, value = item.partition("=")
        out[key] = int(value) if value.lstrip("-").isdigit() else value
    return out


def program_spans(prof: Dict) -> List[Span]:
    """Every program span of the slice, by start."""
    out = []
    for name, a, b in prof["cpu_ops"]:
        if name.startswith(PREFIX):
            base, _, attrs = name[len(PREFIX):].partition("|")
            out.append((base, _attrs(attrs), a, b))
    return sorted(out, key=lambda s: s[2])


def traced(record: Dict) -> Optional[Tuple[Dict, List[Span]]]:
    """(the slice, its program spans), or None where the run was not traced
    or the program records no spans."""
    prof = record.get("profile")
    if not prof:
        return None
    spans = program_spans(prof)
    return (prof, spans) if spans else None


def named(spans: List[Span], name: str) -> List[Span]:
    return [s for s in spans if s[0] == name]


def within(spans: List[Span], intervals) -> List[Span]:
    """The spans that start inside one of the sorted, disjoint
    ``intervals``."""
    starts = [a for a, _ in intervals]
    out = []
    for s in spans:
        i = bisect.bisect_right(starts, s[2]) - 1
        if i >= 0 and s[2] < intervals[i][1]:
            out.append(s)
    return out


def self_seconds(span: Span, children: List[Span]) -> float:
    """``span``'s wall time less the part that ``children`` (sorted by
    start) cover inside it."""
    _, _, a, b = span
    starts = [c[2] for c in children]
    lo, hi = bisect.bisect_left(starts, a), bisect.bisect_left(starts, b)
    inner = union([(c[2], c[3]) for c in children[lo:hi]], (a, b))
    return (b - a) - covered(inner, a, b)


def kernel_seconds(prof: Dict, spans: List[Span]) -> float:
    """Device seconds of the kernels whose launch call lies inside one of
    ``spans``, each kernel counted once (``kernels_launched_in``'s
    matching, over program spans)."""
    intervals = union([(s[2], s[3]) for s in spans], prof["window"])
    starts = [a for a, _ in intervals]
    total = 0.0
    for _, _, dur, corr in prof["kernels"]:
        t = prof["launches"].get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < intervals[i][1]:
            total += dur
    return total


def decode_steps(record: Dict, prof: Dict) -> List[Tuple[float, float]]:
    """The slice's decode steps, (start, end) by start: profiled ``step``
    spans whose step admitted nothing and had active slots, matched to the
    record's traced steps in order, as ``readers.expert_roofline`` matches
    them."""
    steps = [s for s in record["steps"] if s.get("traced")]
    spans = sorted((a, b) for n, a, b in prof["spans"] if n == "step")
    if len(spans) != len(steps):
        raise RuntimeError(f"{len(spans)} step spans in the trace for "
                           f"{len(steps)} profiled steps")
    return [ab for s, ab in zip(steps, spans)
            if not s["admitted"] and s["active"]]
