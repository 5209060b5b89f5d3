"""``setup_s``: Set-up seconds: process start to the first request or the
window's first step: kernel build or load, weights, warm-up (and training's
first steps)."""


def read(record):
    return record["setup_s"]
