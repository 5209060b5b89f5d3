"""``cast_ms_per_step.batch``: Master casts: device ms of the kernels
launched inside the program's ``cast`` spans (``cast_param``, fp32 masters
to the compute dtype) within the slice's decode steps, per decode step."""
from harness import program_spans as P


def read(record):
    found = P.traced(record)
    if found is None or not found[0]["kernels"]:
        return None
    prof, spans = found
    steps = P.decode_steps(record, prof)
    if not steps:
        return None
    casts = P.within(P.named(spans, "cast"), steps)
    return 1e3 * P.kernel_seconds(prof, casts) / len(steps)
