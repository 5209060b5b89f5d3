"""Descriptor-driven kernel engine: family registry, planning, dispatch.

The paper's pipeline is descriptor -> blocking plan -> generated kernel ->
dispatch cache.  A family registers two callables:

  * ``planner(desc, machine) -> plan`` (``repro_torch.core.blocking``);
  * ``execute(desc, plan, *operands, **kw) -> result`` -- runs the cached
    kernel build for that plan.

``dispatch(desc, *operands)`` serves the plan from an LRU plan cache
(analytical machine-model planner on a miss) and calls the executor,
which serves kernel builds -- with their device-resident tile tables --
from the LRU kernel cache via :func:`build_cached`.  Families register
when their ``kernels/<family>/ops`` module is imported, which
:func:`get_family` does lazily on first use.
"""
from __future__ import annotations

import dataclasses
import importlib
import threading
from typing import Any, Callable, Dict, Optional

from .config import get_config
from .descriptor import KernelDescriptor
from .jit_cache import GLOBAL_KERNEL_CACHE, LruCache
from .machine import MachineModel


@dataclasses.dataclass(frozen=True)
class Family:
    """One registered kernel family."""

    name: str
    planner: Callable[[KernelDescriptor, MachineModel], Any]
    execute: Callable[..., Any]


_REGISTRY: Dict[str, Family] = {}
_registry_lock = threading.Lock()

_FAMILY_MODULES = {
    "gemm": "repro_torch.kernels.gemm.ops",
    "flash_attention": "repro_torch.kernels.flash_attention.ops",
    "flash_attention_bwd": "repro_torch.kernels.flash_attention.ops",
}

PLAN_CACHE = LruCache(max_entries=65536)

_counters_lock = threading.Lock()
_plan_calls: Dict[str, int] = {}
# Kernel launches per family, reported by the executors: 1 for a fused
# plan, one per region for a multi-launch GEMM plan.  The port runs
# eagerly, so these are true per-call counts.
_launches: Dict[str, int] = {}


def count_launches(family: str, n: int = 1):
    """Family executors call this once per execute() with the number of
    kernel launches they emit (``stats()[family]["launches"]``)."""
    with _counters_lock:
        _launches[family] = _launches.get(family, 0) + n


def register_family(name: str, planner, execute) -> Family:
    """Register (or replace) a kernel family."""
    fam = Family(name=name, planner=planner, execute=execute)
    with _registry_lock:
        _REGISTRY[name] = fam
    return fam


def get_family(name: str) -> Family:
    """Resolve a family by name, importing its ops module on first use."""
    fam = _REGISTRY.get(name)
    if fam is None:
        module = _FAMILY_MODULES.get(name)
        if module is None:
            raise KeyError(f"unknown kernel family {name!r}; "
                           f"known: {sorted(_FAMILY_MODULES)}")
        importlib.import_module(module)
        fam = _REGISTRY.get(name)
        if fam is None:
            raise RuntimeError(f"module {module} did not register family "
                               f"{name!r}")
    return fam


def plan_for(desc: KernelDescriptor,
             machine: Optional[MachineModel] = None) -> Any:
    """Plan-cache lookup: (descriptor, machine) -> family plan."""
    fam = get_family(desc.family)
    machine = machine or get_config().machine
    key = desc.cache_key() + ("plan", machine.name, machine.fingerprint)

    def build_plan():
        with _counters_lock:
            _plan_calls[desc.family] = _plan_calls.get(desc.family, 0) + 1
        return fam.planner(desc, machine)

    return PLAN_CACHE.get_or_build(key, build_plan)


def dispatch(desc: KernelDescriptor, *operands, plan: Any = None, **kw) -> Any:
    """Run one kernel request: plan (cached unless given), then execute."""
    fam = get_family(desc.family)
    if plan is None:
        plan = plan_for(desc)
    return fam.execute(desc, plan, *operands, **kw)


def resolve_fused(plan: Any) -> bool:
    """A plan's lowering: ``config.fused`` "on"/"off" wins, else the
    plan's own ``fused`` bit."""
    mode = get_config().fused
    if mode == "on":
        return True
    if mode == "off":
        return False
    return bool(getattr(plan, "fused", False))


def build_cached(key: tuple, builder: Callable[[], Any]) -> Any:
    """Kernel-cache helper for family executors; ``key`` starts with the
    family name (``desc.cache_key() + knobs``)."""
    return GLOBAL_KERNEL_CACHE.get_or_build(key, builder)


_STAT_KEYS = ("plan_hits", "plan_misses", "plan_evictions", "planner_calls",
              "launches", "kernel_hits", "kernel_misses", "kernel_evictions")


def stats() -> Dict[str, Dict[str, int]]:
    """Per-family engine stats across both cache layers.

    A backward family (``<family>_bwd``) folds into its forward family's
    row under ``*_bwd`` keys (``launches_bwd``, ``plan_hits_bwd``, ...),
    so one row tells a family's forward and backward story.
    """
    out: Dict[str, Dict[str, int]] = {}

    def slot(fam: str):
        """The family's row and the key suffix it reports under."""
        fam, sfx = (fam[:-4], "_bwd") if fam.endswith("_bwd") else (fam, "")
        row = out.setdefault(fam, {k + s: 0 for s in ("", "_bwd")
                                   for k in _STAT_KEYS})
        return row, sfx

    for fam, c in PLAN_CACHE.family_stats().items():
        b, sfx = slot(fam)
        b["plan_hits" + sfx], b["plan_misses" + sfx] = c["hits"], c["misses"]
        b["plan_evictions" + sfx] = c["evictions"]
    with _counters_lock:
        for fam, n in _plan_calls.items():
            b, sfx = slot(fam)
            b["planner_calls" + sfx] = n
        for fam, n in _launches.items():
            b, sfx = slot(fam)
            b["launches" + sfx] = n
    for fam, c in GLOBAL_KERNEL_CACHE.family_stats().items():
        b, sfx = slot(fam)
        b["kernel_hits" + sfx], b["kernel_misses" + sfx] = \
            c["hits"], c["misses"]
        b["kernel_evictions" + sfx] = c["evictions"]
    return out


def reset_stats(*, entries: bool = True):
    """Reset all engine counters; ``entries=True`` also drops cached plans
    and built kernels, ``entries=False`` keeps both caches warm."""
    if entries:
        PLAN_CACHE.clear()
        GLOBAL_KERNEL_CACHE.clear()
    else:
        PLAN_CACHE.reset_stats()
        GLOBAL_KERNEL_CACHE.reset_stats()
    with _counters_lock:
        _plan_calls.clear()
        _launches.clear()
