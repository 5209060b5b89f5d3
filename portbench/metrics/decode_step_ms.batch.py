"""``decode_step_ms.batch``: Paged decode step: the engine's decode seconds
over its decode steps, in the window."""
from harness import readers


def _ms(seconds):
    return None if seconds is None else 1e3 * seconds


def read(record):
    return readers.decode_step_ms(record)
