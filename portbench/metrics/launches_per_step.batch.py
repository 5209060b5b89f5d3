"""``launches_per_step.batch``: Engine: kernel launches (engine.stats()) a
scheduler step, prefills included, in the window."""
from harness import readers


def read(record):
    return readers.launches_per_step(record)
