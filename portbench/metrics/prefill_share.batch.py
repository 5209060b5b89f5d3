"""``prefill_share.batch``: Scheduler prefill: wall time of the program's
``sched.prefill`` spans (a prompt's prefill, its cache write and the
synchronise after it) over the wall time of the slice's ``step`` spans, %."""
from harness import program_spans as P


def read(record):
    found = P.traced(record)
    if found is None:
        return None
    prof, spans = found
    steps = sum(b - a for n, a, b in prof["spans"] if n == "step")
    if not steps:
        return None
    prefill = sum(s[3] - s[2] for s in P.named(spans, "sched.prefill"))
    return 100.0 * prefill / steps
