"""Step builders (train, prefill, decode) and the training loop."""
