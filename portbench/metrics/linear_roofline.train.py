"""``linear_roofline.train``: GEMM kernels: the least time of every linear
map's forward, dX and dW, over the device time of every GEMM kernel, %."""
from harness import readers


def read(record):
    return readers.linear_roofline(record)
