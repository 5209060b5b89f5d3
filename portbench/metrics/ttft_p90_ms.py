"""``ttft_p90_ms``: 90th percentile, over every request due in the window, of
due time to the end of the step that emitted its first token; a request
still waiting at the window's end counts its wait so far."""
from harness import readers


def read(record):
    w0, w1 = record["window"]
    return readers.ms(readers.percentile(readers.ttft_s(record, w0, w1), 90))
