"""The plain reference: the decoder (dense or mixture of experts) and its
training step in float32 PyTorch, TF32 off, written from the configuration
file alone.  It imports nothing of the program, and takes the benchmark's
weights (``harness.weights``) and inputs, never the program's."""
