"""``train_tokens_per_s``: Tokens of every training step completed in the
window, over the window's seconds."""
from harness import readers


def read(record):
    return readers.train_tokens_per_s(record)
