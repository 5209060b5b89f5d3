"""``expert_rows_useful.batch``: MoE capacity: routed rows (tokens times
top-k) over the capacity rows the expert GEMMs run over, summed over the
program's ``moe`` spans within the slice's decode steps, %."""
from harness import program_spans as P


def read(record):
    found = P.traced(record)
    if found is None:
        return None
    prof, spans = found
    moes = P.within(P.named(spans, "moe"), P.decode_steps(record, prof))
    capacity = sum(m[1]["capacity_rows"] for m in moes)
    if not capacity:
        return None
    return 100.0 * sum(m[1]["routed_rows"] for m in moes) / capacity
