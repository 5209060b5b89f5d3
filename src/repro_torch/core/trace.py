"""Named spans of the program on the profiler's clock.

``span(name, **attrs)`` marks a region as an event of the ``torch.profiler``
trace that also holds the kernels and their launch calls, so a span and the
kernels launched inside it share one clock.  The event is named
``repro_torch.<name>``, with ``|k=v,k=v`` appended for the attributes: the
Chrome export keeps an event's name but not its argument strings.  It is a
function-scope record, the kind the profiler files aten operators under, so
a reader of the trace finds the spans nested among the operators they
enclose.

The spans are on exactly while a profiler runs (``torch.profiler.profile``
around a serving or training run).  Otherwise ``span`` returns one shared
null context: no record is made and no attribute string is formatted.
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A context manager that records ``name`` while a profiler runs."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    if attrs:
        name += "|" + ",".join(f"{k}={v}" for k, v in attrs.items())
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)
