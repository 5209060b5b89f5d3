"""``mfu.train``: Whole step: model FLOPs of the window's steps over its
seconds at the bf16 peak, %."""
from harness import readers


def read(record):
    return readers.train_mfu(record)
