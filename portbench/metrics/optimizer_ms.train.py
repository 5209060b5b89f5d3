"""``optimizer_ms.train``: Optimizer: device ms a step of the kernels launched
inside the optimizer's update."""
from harness import readers


def _ms(seconds):
    return None if seconds is None else 1e3 * seconds


def read(record):
    return readers.optimizer_ms(record)
