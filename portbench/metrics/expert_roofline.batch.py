"""``expert_roofline.batch``: Grouped GEMM kernels: the least time of the
expert work the slice's decode steps need (the steps that admit nothing),
over the device time of the grouped kernels launched inside them, %."""
from harness import readers


def read(record):
    return readers.expert_roofline(record)
