"""``queue_wait_p95_ms.chat``: Scheduler: 95th percentile of due time to the
start of the step that admitted the request."""
from harness import readers


def read(record):
    return readers.ms(readers.percentile(readers.queue_wait_s(record), 95))
