"""Checkpoints: atomic, asynchronous, with retention and exact resume."""
from repro_torch.checkpoint.ckpt import (  # noqa: F401
    CheckpointManager, latest_step, restore_checkpoint, save_checkpoint)
