"""``attention_roofline.train``: Flash kernels: the least time of causal
attention forward and backward, over the flash kernels' device time, %."""
from harness import readers


def read(record):
    return readers.attention_roofline(record)
