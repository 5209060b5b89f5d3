"""Cost records of engine kernel descriptors, in the reference's schema.

The reference's module is mostly a trip-count-aware walker over XLA's
optimized HLO text (``parse_module``, ``analyze``): it reads the compiled
module's dots, fusion boundaries, while-loop trip counts and collectives.
The port runs eagerly and compiles no module, so there is no HLO to walk
and that walker has no counterpart here; it is recorded as a gap of the
port (PERF.md, open questions), not replaced by an invented equivalent.
What the port counts instead is the work its kernels are asked for: the
engine's cost trace (``repro_torch.core.engine.trace_costs``) sums
:func:`descriptor_cost` over every kernel call of a step, and
``torch.utils.flop_counter`` counts the matrix products outside the
engine.  No collective is counted: the step runs on one device.
"""
from __future__ import annotations

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")


def descriptor_cost(desc) -> dict:
    """Cost record for one engine kernel descriptor, in the schema of the
    reference's ``analyze`` (FLOPs, bytes read and written, no
    collective), so engine kernels of any family merge with module
    costs."""
    return {
        "flops": float(desc.flops),
        "bytes": float(desc.in_bytes + desc.out_bytes),
        "collectives": {c: {"count": 0.0, "bytes": 0.0}
                        for c in COLLECTIVE_OPS},
        "collective_bytes": 0.0,
        "num_computations": 1,
    }
