"""Process-wide engine configuration: backend, device, machine, fused policy.

  * ``backend`` -- ``"engine"`` (descriptor -> plan -> hand-written
    Hopper kernel; the default, because the port targets the card) or
    ``"torch"`` (plain torch ops, with ``torch.matmul``/cuBLAS as the
    vendor baseline);
  * ``device``  -- where entry points put models and tensors when the
    caller names none: ``"cuda"`` by default, ``"cpu"`` for the tests.
    Asking for CUDA on a host without it raises; nothing falls back;
  * ``machine`` -- the :class:`~repro_torch.core.machine.MachineModel`
    every planner reads (``H100_SXM`` by default);
  * ``fused``   -- ``"auto"`` follows the plan's ``fused`` bit, ``"on"`` /
    ``"off"`` force the single-launch or the multi-launch / dense-grid
    lowering.  ``REPRO_FUSED=auto|on|off`` seeds the process default;
  * ``quant``   -- the ambient low-precision spec the GEMM-family entry
    points (``gemm``, ``grouped_gemm``) apply when a call passes none:
    ``None`` (wide, the default), a :class:`~repro_torch.core.descriptor.
    QuantSpec` or a shorthand (``"int8"``/``"w8a16"``/``"fp8"``).  Per
    call, ``quant=False`` opts out; in ``use``/``configure``,
    ``quant=False`` clears it.  ``REPRO_QUANT=int8|w8a16|fp8`` seeds the
    process default;
  * ``autotune`` -- let ``engine.dispatch`` time the top ``autotune_budget``
    candidate plans on the call's operands instead of trusting the cost
    model (``REPRO_AUTOTUNE=1``, ``REPRO_AUTOTUNE_BUDGET=K``; a malformed
    budget warns and keeps 8);
  * ``tuning_cache`` -- the JSON file autotuned winners persist in, read
    before any search (``REPRO_TUNING_CACHE``);
  * ``tuning_cache_preload`` -- a read-only, fleet-merged tuning cache
    consulted after ``tuning_cache`` misses (``REPRO_TUNING_CACHE_PRELOAD``);
  * ``warm_start`` -- a descriptor manifest (``engine.save_manifest``) that
    ``engine.warmup()`` replays with no arguments (``REPRO_WARM_START``).

For the three paths, ``""`` is the explicit off switch (``None`` leaves the
setting as it is).

Configuration is layered: a process-wide default (``configure``) under a
thread-local override stack (``use``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import warnings
from typing import Optional

import torch

from .descriptor import QuantSpec, resolve_quant
from .machine import DEFAULT_MACHINE, MachineModel, get_machine

BACKENDS = ("torch", "engine")
FUSED_MODES = ("auto", "on", "off")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """One immutable snapshot of the engine's ambient configuration."""

    backend: str = "engine"
    device: str = "cuda"
    machine: MachineModel = DEFAULT_MACHINE
    fused: str = "auto"
    quant: Optional[QuantSpec] = None
    autotune: bool = False
    autotune_budget: int = 8
    tuning_cache: Optional[str] = None
    tuning_cache_preload: Optional[str] = None
    warm_start: Optional[str] = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        if self.autotune_budget < 1:
            raise ValueError(f"autotune_budget must be >= 1, "
                             f"got {self.autotune_budget}")
        if self.fused not in FUSED_MODES:
            raise ValueError(f"fused must be one of {FUSED_MODES}, "
                             f"got {self.fused!r}")
        if torch.device(self.device).type not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {self.device!r}")
        if self.quant is not None and not isinstance(self.quant, QuantSpec):
            raise ValueError(f"quant must be None or a QuantSpec, "
                             f"got {self.quant!r}")

    def replace(self, **kw) -> "EngineConfig":
        kw = {k: v for k, v in kw.items() if v is not None}
        if isinstance(kw.get("machine"), str):
            kw["machine"] = get_machine(kw["machine"])
        if "device" in kw:
            kw["device"] = str(kw["device"])
        if "quant" in kw:
            # quant=False is the explicit off switch (None leaves it as is)
            kw["quant"] = resolve_quant(kw["quant"])
        return dataclasses.replace(self, **kw)


def _env_default() -> EngineConfig:
    budget = EngineConfig.autotune_budget
    raw = os.environ.get("REPRO_AUTOTUNE_BUDGET")
    if raw:
        try:
            budget = int(raw)
            if budget < 1:
                raise ValueError("must be >= 1")
        except ValueError as e:
            warnings.warn(f"ignoring REPRO_AUTOTUNE_BUDGET={raw!r}: {e}")
            budget = EngineConfig.autotune_budget
    fused = os.environ.get("REPRO_FUSED", "").lower()
    if fused in ("1", "true", "yes"):
        fused = "on"
    elif fused in ("0", "false", "no"):
        fused = "off"
    if fused not in FUSED_MODES:
        if fused:
            warnings.warn(f"ignoring REPRO_FUSED={fused!r}: "
                          f"must be one of {FUSED_MODES}")
        fused = "auto"
    quant = None
    raw = os.environ.get("REPRO_QUANT", "").lower()
    if raw and raw not in ("0", "false", "no", "off", "none"):
        try:
            quant = resolve_quant(raw)
        except ValueError as e:
            warnings.warn(f"ignoring REPRO_QUANT={raw!r}: {e}")
    return EngineConfig(
        fused=fused, quant=quant,
        autotune=os.environ.get("REPRO_AUTOTUNE", "").lower()
        in ("1", "true", "yes", "on"),
        autotune_budget=budget,
        tuning_cache=os.environ.get("REPRO_TUNING_CACHE") or None,
        tuning_cache_preload=os.environ.get("REPRO_TUNING_CACHE_PRELOAD")
        or None,
        warm_start=os.environ.get("REPRO_WARM_START") or None)


_DEFAULT = _env_default()
_default_lock = threading.Lock()
_tls = threading.local()


def _stack() -> list:
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def get_config() -> EngineConfig:
    """Effective config: innermost thread-local override, else the global."""
    stack = _stack()
    return stack[-1] if stack else _DEFAULT


def configure(*, backend: Optional[str] = None, device=None, machine=None,
              fused: Optional[str] = None, quant=None,
              autotune: Optional[bool] = None,
              autotune_budget: Optional[int] = None,
              tuning_cache: Optional[str] = None,
              tuning_cache_preload: Optional[str] = None,
              warm_start: Optional[str] = None) -> EngineConfig:
    """Mutate the process-wide default (all threads without an override)."""
    global _DEFAULT
    with _default_lock:
        _DEFAULT = _DEFAULT.replace(
            backend=backend, device=device, machine=machine, fused=fused,
            quant=quant, autotune=autotune, autotune_budget=autotune_budget,
            tuning_cache=tuning_cache,
            tuning_cache_preload=tuning_cache_preload, warm_start=warm_start)
        return _DEFAULT


@contextlib.contextmanager
def use(*, backend: Optional[str] = None, device=None, machine=None,
        fused: Optional[str] = None, quant=None,
        autotune: Optional[bool] = None,
        autotune_budget: Optional[int] = None,
        tuning_cache: Optional[str] = None,
        tuning_cache_preload: Optional[str] = None,
        warm_start: Optional[str] = None):
    """Thread-local override: ``with use(backend="torch"): ...``."""
    stack = _stack()
    stack.append(get_config().replace(
        backend=backend, device=device, machine=machine, fused=fused,
        quant=quant, autotune=autotune, autotune_budget=autotune_budget,
        tuning_cache=tuning_cache, tuning_cache_preload=tuning_cache_preload,
        warm_start=warm_start))
    try:
        yield stack[-1]
    finally:
        stack.pop()


@contextlib.contextmanager
def pinned(cfg: EngineConfig):
    """Thread-local override by a whole snapshot ``cfg`` (one that
    ``get_config`` returned): work that runs on another thread, such as a
    forward recomputed in the backward, which autograd runs on its device
    thread for CUDA tensors, sees the configuration its caller saw."""
    stack = _stack()
    stack.append(cfg)
    try:
        yield cfg
    finally:
        stack.pop()


_shape_only = threading.local()


@contextlib.contextmanager
def shape_only():
    """Admit ``device="meta"`` in :func:`resolve_device` for the block: the
    dry-run's shape-only builds (``runtime.steps.param_shapes``,
    ``cache_shapes``, ``opt_state_shapes`` and ``launch.dryrun``), which
    hold no storage.  No user-facing entry point opens it."""
    depth = getattr(_shape_only, "depth", 0)
    _shape_only.depth = depth + 1
    try:
        yield
    finally:
        _shape_only.depth = depth


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    configured default.  CUDA on a host without a usable card raises;
    ``meta`` is refused outside :func:`shape_only`."""
    dev = torch.device(device if device is not None else get_config().device)
    if dev.type == "meta" and getattr(_shape_only, "depth", 0):
        return dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (or use(device='cpu')) to run the "
            "plain CPU versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
