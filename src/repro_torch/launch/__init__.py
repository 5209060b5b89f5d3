"""Entry points: the static serving CLI and the training CLI."""
