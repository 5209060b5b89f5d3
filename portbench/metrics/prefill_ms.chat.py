"""``prefill_ms.chat``: Prefill: the engine's prefill seconds over the
admissions, in the window."""
from harness import readers


def _ms(seconds):
    return None if seconds is None else 1e3 * seconds


def read(record):
    return readers.prefill_ms(record)
