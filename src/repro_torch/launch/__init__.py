"""Entry points (the static serving CLI)."""
