"""``mfu.batch``: Whole step: model FLOPs of the tokens emitted in the window
over its seconds at the bf16 peak, %."""
from harness import readers


def read(record):
    return readers.serve_mfu(record)
