"""Fault-tolerant training loop.

  * periodic asynchronous checkpoints with an atomic commit and exact
    data-position resume (the data pipeline is counter-based, so skipping
    to a step is free);
  * a restart supervisor (``run_with_restarts``): any exception in a step
    rolls the job back to the last committed checkpoint, with bounded
    retries;
  * straggler detection: step wall times feed a running median; steps
    slower than ``straggler_factor`` x median are counted.

The model and the optimizer state are updated in place, so the
supervisor asks ``make_state()`` for FRESH state on every (re)start: it
must build a new model and optimizer state, not hand back objects a
failed attempt has already stepped, or a restart before the first
checkpoint would resume from mutated weights.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import engine


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    save_every: int = 50
    max_to_keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    max_restarts: int = 3


@dataclasses.dataclass
class StragglerStats:
    times: List[float] = dataclasses.field(default_factory=list)
    stragglers: int = 0

    def observe(self, dt: float, factor: float) -> bool:
        self.times.append(dt)
        if len(self.times) >= 10:
            med = statistics.median(self.times[-100:])
            if dt > factor * med:
                self.stragglers += 1
                return True
        return False


def _state_tree(model, opt_state) -> Dict[str, Any]:
    return {"params": dict(model.named_parameters()), "opt_state": opt_state}


def _sync(model) -> None:
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)


def train(step_fn: Callable, model, opt_state, batch_fn: Callable[[int], Any],
          loop_cfg: TrainLoopConfig, *, start_step: int = 0,
          log_fn: Callable[[int, Dict], None] = None) -> Dict[str, Any]:
    """Run ``step_fn(model, opt_state, batch, step) -> metrics`` from
    ``start_step`` to ``loop_cfg.total_steps``, checkpointing every
    ``save_every`` steps and at the end (unless that step was just
    saved)."""
    mgr = CheckpointManager(loop_cfg.ckpt_dir, loop_cfg.save_every,
                            loop_cfg.max_to_keep)
    stats = StragglerStats()
    metrics_hist = []
    step = start_step
    saved = None
    while step < loop_cfg.total_steps:
        t0 = time.time()
        batch = batch_fn(step)
        metrics = step_fn(model, opt_state, batch, step)
        _sync(model)
        dt = time.time() - t0
        slow = stats.observe(dt, loop_cfg.straggler_factor)
        scalars = {k: float(v) for k, v in metrics.items()
                   if isinstance(v, torch.Tensor) and v.ndim == 0}
        scalars["step_seconds"] = dt
        scalars["straggler"] = float(slow)
        metrics_hist.append(scalars)
        if log_fn and (step % loop_cfg.log_every == 0
                       or step == loop_cfg.total_steps - 1):
            log_fn(step, scalars)
        step += 1
        if mgr.maybe_save(step, _state_tree(model, opt_state),
                          meta={"data_step": step}):
            saved = step
    if saved != step:
        mgr.maybe_save(step, _state_tree(model, opt_state),
                       meta={"data_step": step}, force=True)
    mgr.wait()
    return {"model": model, "opt_state": opt_state,
            "metrics": metrics_hist, "stragglers": stats.stragglers,
            "final_step": step,
            # Per-family plan/launch counters, the backward (``*_bwd``)
            # ones included: whether the gradients went through the
            # scheduled backward kernels or the reference fallback.
            "engine_stats": engine.stats()}


def run_with_restarts(make_state: Callable[[], tuple], step_fn, batch_fn,
                      loop_cfg: TrainLoopConfig, *,
                      fault_injector: Optional[Callable[[int], None]] = None,
                      log_fn=None) -> Dict[str, Any]:
    """Supervisor: (re)start training from the latest checkpoint until the
    step budget completes or restarts are exhausted.

    ``make_state() -> (model, opt_state)`` must build fresh state on every
    call (see the module docstring).  ``fault_injector(step)`` may raise
    to simulate a node failure (tests).
    """
    restarts = 0
    while True:
        model, opt_state = make_state()
        mgr = CheckpointManager(loop_cfg.ckpt_dir, loop_cfg.save_every,
                                loop_cfg.max_to_keep)
        restored, meta = mgr.restore_latest(_state_tree(model, opt_state))
        start = 0
        if restored is not None:
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(restored["params"][name])
            opt_state = restored["opt_state"]
            start = int(meta["data_step"])

        wrapped_batch_fn = batch_fn
        if fault_injector is not None:
            def wrapped_batch_fn(step, _orig=batch_fn):
                fault_injector(step)
                return _orig(step)

        try:
            out = train(step_fn, model, opt_state, wrapped_batch_fn,
                        loop_cfg, start_step=start, log_fn=log_fn)
            out["restarts"] = restarts
            return out
        except Exception:
            restarts += 1
            if restarts > loop_cfg.max_restarts:
                raise
            # Free this attempt's state before make_state builds anew.
            del model, opt_state, restored
