"""``device_idle.chat``: Device: share of the profiled slice with no kernel,
copy or fill running, %."""
from harness import readers


def read(record):
    return readers.device_idle(record)
