"""Checkpointing of nested dicts of tensors, in the reference's layout.

  * a checkpoint is ``<dir>/step_N/arrays.npz`` (one array per leaf, keyed
    by the leaf's path joined with ``/``, e.g. ``params/blocks.0.mixer.wq.w``
    -- the port's own state-dict names) plus ``meta.json``;
  * atomic commit: the files are written to ``step_N.tmp``, which
    ``os.replace`` renames, so a crash mid-write never corrupts the
    latest checkpoint;
  * asynchronous: the host copy (a snapshot, on the CPU too) happens on
    the caller's thread, the file write on a background thread;
  * retention: the last ``max_to_keep`` steps are kept;
  * metadata (step, data position) rides along, so resume is exact.

Leaves numpy cannot hold (bfloat16) are stored as float32 and cast back
to the target's dtype on restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        flat = {}
        for key, value in tree.items():
            flat.update(_flatten(value, f"{prefix}{key}/"))
        return flat
    return {prefix[:-1]: tree}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host snapshot that owns its memory.  ``copy=True`` matters for a
    CPU tensor: ``.cpu().numpy()`` would alias it, and the next training
    step, which updates in place, would change what the writer thread is
    still saving."""
    dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.detach().to("cpu", dtype, copy=True).numpy()


def save_checkpoint(directory: str, step: int, tree, *,
                    meta: Optional[dict] = None, max_to_keep: int = 3,
                    async_write: bool = True) -> threading.Thread:
    """Write ``tree`` (nested dicts of tensors) as ``step_{step}``.
    Returns the writer thread (already joined unless ``async_write``)."""
    os.makedirs(directory, exist_ok=True)
    host = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")

    def write():
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **(meta or {})}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic commit
        _retain(directory, max_to_keep)

    t = threading.Thread(target=write, daemon=True)
    t.start()
    if not async_write:
        t.join()
    return t


def _retain(directory: str, max_to_keep: int):
    for s in sorted(_list_steps(directory))[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)


def _list_steps(directory: str):
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = _list_steps(directory)
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int,
                       target_tree) -> Tuple[Any, dict]:
    """Restore ``step_{step}`` into new tensors shaped like ``target_tree``
    (same keys; each leaf takes the target leaf's dtype and device)."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        def build(tree, prefix):
            if isinstance(tree, dict):
                return {k: build(v, f"{prefix}{k}/") for k, v in tree.items()}
            key = prefix[:-1]
            if key not in arrays:
                raise KeyError(f"checkpoint missing {key}")
            arr = torch.from_numpy(arrays[key])
            if tuple(arr.shape) != tuple(tree.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)}"
                                 f", target {tuple(tree.shape)}")
            return arr.to(device=tree.device, dtype=tree.dtype)

        return build(target_tree, ""), meta


class CheckpointManager:
    """Train-loop-facing wrapper: periodic asynchronous saves and exact
    resume."""

    def __init__(self, directory: str, save_every: int = 100,
                 max_to_keep: int = 3):
        self.directory = directory
        self.save_every = save_every
        self.max_to_keep = max_to_keep
        self._pending: Optional[threading.Thread] = None

    def maybe_save(self, step: int, tree, meta: Optional[dict] = None,
                   force: bool = False):
        if not force and (step % self.save_every):
            return False
        self.wait()
        self._pending = save_checkpoint(
            self.directory, step, tree, meta=meta, max_to_keep=self.max_to_keep)
        return True

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore_latest(self, target_tree):
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return restore_checkpoint(self.directory, step, target_tree)
