"""``moe_host_ms.batch``: MoE on the host: wall ms inside the program's
``moe`` spans (``moe_apply``, every layer) less their ``cast`` children,
within the slice's decode steps, per decode step."""
from harness import program_spans as P


def read(record):
    found = P.traced(record)
    if found is None:
        return None
    prof, spans = found
    steps = P.decode_steps(record, prof)
    if not steps:
        return None
    casts = P.named(spans, "cast")
    host = sum(P.self_seconds(m, casts)
               for m in P.within(P.named(spans, "moe"), steps))
    return 1e3 * host / len(steps)
