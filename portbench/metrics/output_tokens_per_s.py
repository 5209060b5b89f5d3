"""``output_tokens_per_s``: Output tokens emitted inside the window, over the
window's seconds."""
from harness import readers


def read(record):
    return readers.output_tokens_per_s(record)
