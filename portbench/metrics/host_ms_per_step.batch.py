"""``host_ms_per_step.batch``: Model and engine on the host: a scheduler step's
wall time less the device's busy time inside it, mean over the profiled
slice."""
from harness import readers


def read(record):
    return readers.host_ms_per_step(record)
