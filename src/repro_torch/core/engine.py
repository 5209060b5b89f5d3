"""Descriptor-driven kernel engine: family registry, planning, dispatch.

The paper's pipeline is descriptor -> blocking plan -> generated kernel ->
dispatch cache.  A family registers two callables:

  * ``planner(desc, machine) -> plan`` (``repro_torch.core.blocking``);
  * ``execute(desc, plan, *operands, **kw) -> result`` -- runs the cached
    kernel build for that plan.

``dispatch(desc, *operands)`` serves the plan from an LRU plan cache and
calls the executor, which serves kernel builds -- with their
device-resident tile tables -- from the LRU kernel cache via
:func:`build_cached`.  A plan-cache miss resolves through three tiers,
as in the reference:

  1. **tuned cache** -- the winners on disk (``config.tuning_cache``, then
     the read-only ``config.tuning_cache_preload``);
  2. **autotune** -- with ``config.autotune`` and operands to time, the
     top candidates timed for real (:mod:`repro_torch.core.autotune`),
     the winner stored in the writable cache;
  3. **model** -- the family planner.

``stats()`` shows per family which tier served each resolution
(``plan_source_{tuned_cache,autotuned,model}``), how many candidate runs
were timed (``autotune_timings``) and how many candidates failed
(``autotune_failures``).  For warm starts every dispatch records its
descriptor (:func:`seen_descriptors`, :func:`save_manifest`), and
:func:`warmup` resolves and builds a recorded population before the
first request.  Families register when their ``kernels/<family>/ops``
module is imported, which :func:`get_family` does lazily on first use.

:func:`trace_costs` records every kernel call of a block, per family
(calls, descriptor FLOPs and bytes), with the FLOPs of the matrix
products outside the engine: the port's counterpart of the reference's
compile-time cost analysis.  On meta operands a dispatch plans and
launches nothing and returns its descriptor's ``meta_output()``, so the
dry-run (``repro_torch.launch.dryrun``) traces a full-size step with no
storage.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import threading
import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import autotune as _autotune
from .config import get_config
from .descriptor import KernelDescriptor
from .jit_cache import GLOBAL_KERNEL_CACHE, LruCache
from .machine import MachineModel
from .trace import span


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
    "flash_decode": "repro_torch.kernels.flash_attention.ops",
    "grouped_gemm": "repro_torch.kernels.grouped_gemm.ops",
    "grouped_gemm_bwd": "repro_torch.kernels.grouped_gemm.ops",
    "ssd_chunk": "repro_torch.kernels.ssd_chunk.ops",
    "ssd_chunk_bwd": "repro_torch.kernels.ssd_chunk.ops",
    "transpose": "repro_torch.kernels.transpose.ops",
}

PLAN_CACHE = LruCache(max_entries=65536)

_counters_lock = threading.Lock()
_plan_calls: Dict[str, int] = {}
# Kernel launches per family, reported by the executors: 1 for a fused
# plan, one per region for a multi-launch GEMM plan.  The port runs
# eagerly, so these are true per-call counts.
_launches: Dict[str, int] = {}
# Collectives per family that the mesh executors report: the payload bytes
# each device moves and the collectives launched around the per-shard
# kernel.  They count what the reference counts: the distributed
# strategy's two all_to_alls.  The port's explicit all_gathers (the weights
# in the gathered strategy, the output in both) stand where XLA gathers
# implicitly in the reference, which counts nothing for them; so do these
# counters, and a non-zero count means a distributed execution ran.
_comm_bytes: Dict[str, int] = {}
_collective_launches: Dict[str, int] = {}
# Which tier served each plan-cache miss, per family.
PLAN_SOURCES = ("tuned_cache", "autotuned", "model")
_plan_sources: Dict[str, Dict[str, int]] = {}
# Candidate runs the autotuner timed, candidates that failed, descriptors
# warmed and warmup builds that failed, per family.
_autotune_timings: Dict[str, int] = {}
_autotune_failures: Dict[str, int] = {}
_warmups: Dict[str, int] = {}
_warmup_failures: Dict[str, int] = {}
# Every distinct descriptor dispatched since the last full reset, by cache
# key: the population a warm-start manifest records.
_seen_descs: Dict[tuple, KernelDescriptor] = {}


def _bump(counter: Dict[str, int], family: str, n: int = 1):
    with _counters_lock:
        counter[family] = counter.get(family, 0) + n


def _note_source(family: str, source: str):
    with _counters_lock:
        bucket = _plan_sources.setdefault(family,
                                          {s: 0 for s in PLAN_SOURCES})
        bucket[source] += 1


def count_launches(family: str, n: int = 1):
    """Family executors call this once per execute() with the number of
    kernel launches they emit (``stats()[family]["launches"]``)."""
    _bump(_launches, family, n)


def count_comm(family: str, nbytes: int, launches: int = 1):
    """Mesh executors call this with the per-device payload bytes and the
    number of counted collectives one execute() emits
    (``stats()[family]["comm_bytes"]`` / ``["collective_launches"]``)."""
    _bump(_comm_bytes, family, int(nbytes))
    _bump(_collective_launches, family, launches)


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


def _device_mode(operands: Optional[tuple], kw: Optional[dict], cfg) -> str:
    """The tuning-cache mode of a resolution: the operands' device type,
    else the configured device's."""
    mode = _autotune.operand_mode(operands or (), kw or {})
    return mode or torch.device(cfg.device).type


def _resolve_plan(desc: KernelDescriptor, cfg, *,
                  machine: Optional[MachineModel] = None,
                  operands: Optional[tuple] = None,
                  kw: Optional[dict] = None) -> Any:
    """Plan-cache lookup; a miss walks the three tiers."""
    fam = get_family(desc.family)
    machine = machine or cfg.machine
    kw = kw or {}
    mode = _device_mode(operands, kw, cfg)
    autotunable = (cfg.autotune and operands is not None
                   and _autotune.can_autotune(operands, kw))
    tier = "autotune" if autotunable else \
        ("tuned" if (cfg.tuning_cache or cfg.tuning_cache_preload)
         else "model")

    def key_for(t):
        # The machine by name and constants, the tier (a model plan cached
        # without operands never masks a later autotune), the device mode
        # and both cache paths.
        return desc.cache_key() + ("plan", machine.name, machine.fingerprint,
                                   t, mode, cfg.tuning_cache or "",
                                   cfg.tuning_cache_preload or "")

    def build_plan():
        with span("engine.plan", family=desc.family):
            return walk_tiers()

    def walk_tiers():
        # Tier 1: the tuned caches, the writable one first.
        for path in (cfg.tuning_cache, cfg.tuning_cache_preload):
            if not path:
                continue
            record = _autotune.get_tuning_cache(path).lookup(
                machine.tuning_key, desc, mode=mode)
            if record is not None:
                plan = _autotune.plan_from_record(desc, record)
                if plan is not None:
                    _note_source(desc.family, "tuned_cache")
                    return plan
        # Tier 2: time the model's top candidates on these operands.
        if autotunable:
            cache = (_autotune.get_tuning_cache(cfg.tuning_cache)
                     if cfg.tuning_cache else None)
            plan, timed = _autotune.search(
                fam.execute, desc, machine, operands, kw,
                budget=cfg.autotune_budget, tuning_cache=cache,
                on_failure=lambda: _bump(_autotune_failures, desc.family))
            _bump(_autotune_timings, desc.family, timed)
            if plan is not None:
                _note_source(desc.family, "autotuned")
                if cfg.tuning_cache:
                    # A resolution without operands may have cached a model
                    # plan under the tuned-tier key: the winner replaces it.
                    PLAN_CACHE.put(key_for("tuned"), plan)
                return plan
        # Tier 3: the analytical planner.
        _bump(_plan_calls, desc.family)
        _note_source(desc.family, "model")
        return fam.planner(desc, machine)

    return PLAN_CACHE.get_or_build(key_for(tier), build_plan)


def plan_for(desc: KernelDescriptor,
             machine: Optional[MachineModel] = None) -> Any:
    """Plan-cache lookup: (descriptor, machine) -> family plan.  With no
    operands there is nothing to time: the tuned caches (when configured)
    and the model serve it."""
    return _resolve_plan(desc, get_config(), machine=machine)


def resolve(desc: KernelDescriptor, *operands, **kw) -> Any:
    """The plan :func:`dispatch` runs ``desc`` with on these operands (the
    three tiers behind the plan cache): a caller that keeps it, such as a
    backward that runs the forward's plan, resolves it once."""
    return _resolve_plan(desc, get_config(), operands=operands, kw=kw)


def dispatch(desc: KernelDescriptor, *operands, plan: Any = None, **kw) -> Any:
    """Run one kernel request: plan (three tiers behind the plan cache,
    unless ``plan`` is given), then execute.  Under :func:`trace_costs`
    the call is recorded first; meta operands (a shape-only trace) plan
    nothing and launch nothing, and get the descriptor's
    ``meta_output()``."""
    fam = get_family(desc.family)
    if traced_call(desc, operands, kw):
        return desc.meta_output()
    _seen_descs.setdefault(desc.cache_key(), desc)
    if plan is None:
        plan = resolve(desc, *operands, **kw)
    with engine_work():
        return fam.execute(desc, plan, *operands, **kw)


# ---------------------------------------------------------------------------
# Cost trace
# ---------------------------------------------------------------------------

class _ProductCounter(FlopCounterMode):
    """``FlopCounterMode`` that skips what the engine's executors run: on
    the CPU their plain versions are torch products, which are engine
    work, not work outside it."""

    def __init__(self, trace: "CostTrace"):
        super().__init__(display=False)
        self._trace = trace

    def _count_flops(self, func_packet, out, args, kwargs):
        if self._trace.in_engine:
            return out
        return super()._count_flops(func_packet, out, args, kwargs)


class CostTrace:
    """What :func:`trace_costs` recorded.

    ``families[family]`` holds ``calls``, ``flops`` and ``bytes`` (the
    sums of each call's ``launch.hlo_cost.descriptor_cost``: the
    descriptor's ``flops`` and ``in_bytes + out_bytes``), backward
    families under their own names; ``descriptors`` every distinct
    descriptor, by cache key; ``non_engine_flops`` the FLOPs of the
    matrix products that ran outside the engine (the router, plain
    attention, the fp32 products of ``core.matmul``'s backward), as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them."""

    def __init__(self):
        self.families: Dict[str, Dict[str, int]] = {}
        self.descriptors: Dict[tuple, KernelDescriptor] = {}
        self.non_engine_flops = 0
        self.in_engine = 0
        self._lock = threading.Lock()

    def record(self, desc: KernelDescriptor) -> None:
        with self._lock:
            row = self.families.setdefault(
                desc.family, {"calls": 0, "flops": 0, "bytes": 0})
            row["calls"] += 1
            row["flops"] += int(desc.flops)
            row["bytes"] += int(desc.in_bytes + desc.out_bytes)
            self.descriptors.setdefault(desc.cache_key(), desc)

    @contextlib.contextmanager
    def engine_work(self):
        with self._lock:
            self.in_engine += 1
        try:
            yield
        finally:
            with self._lock:
                self.in_engine -= 1

    @property
    def flops(self) -> int:
        return sum(r["flops"] for r in self.families.values())

    @property
    def bytes(self) -> int:
        return sum(r["bytes"] for r in self.families.values())

    def summary(self) -> Dict[str, Any]:
        """JSON-ready totals: per family, engine, and outside the engine."""
        return {"families": {f: dict(r) for f, r in
                             sorted(self.families.items())},
                "flops": self.flops, "bytes": self.bytes,
                "non_engine_flops": self.non_engine_flops}


# The active trace, process-wide: autograd runs a CUDA backward on its own
# device thread, whose dispatches must be recorded too.
_TRACE: Optional[CostTrace] = None


@contextlib.contextmanager
def trace_costs():
    """Record every kernel call of the block (the port's counterpart of the
    reference's compile-time cost pass): ``with engine.trace_costs() as
    t: step(...)``, then ``t.families`` / ``t.summary()``.

    On meta operands nothing is planned or launched: each dispatch returns
    its descriptor's ``meta_output()``, so a step at full size costs no
    memory.  On CPU or CUDA operands each call is recorded and then runs
    as usual.  The FLOPs of matrix products outside the engine count as
    ``non_engine_flops``.  Traces do not nest."""
    global _TRACE
    if _TRACE is not None:
        raise RuntimeError("engine.trace_costs() does not nest")
    trace = CostTrace()
    counter = _ProductCounter(trace)
    _TRACE = trace
    try:
        with counter:
            yield trace
    finally:
        _TRACE = None
        trace.non_engine_flops = int(counter.get_total_flops())


def engine_work():
    """Context of a kernel's execution: under a trace, torch products run
    inside it (a CPU plain version) do not count as ``non_engine_flops``."""
    return _TRACE.engine_work() if _TRACE is not None \
        else contextlib.nullcontext()


def _is_meta(operands, kw) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_meta
               for t in (*operands, *kw.values()))


def traced_call(desc: KernelDescriptor, operands=(), kw=None) -> bool:
    """Record one kernel call of ``desc`` in the active trace; True when
    the operands are on the meta device, so the caller returns shape-only
    outputs instead of launching.  Meta operands outside a trace raise.
    Launch sites outside :func:`dispatch` (a forward that keeps its
    residuals for a backward kernel) call it themselves."""
    meta = _is_meta(operands, kw or {})
    trace = _TRACE
    if trace is not None:
        trace.record(desc)
    elif meta:
        raise RuntimeError(
            f"{desc.family}: meta operands reach the engine only under "
            f"engine.trace_costs() (the dry-run's shape-only trace)")
    return meta


# ---------------------------------------------------------------------------
# Warm start
# ---------------------------------------------------------------------------

def seen_descriptors() -> List[KernelDescriptor]:
    """Every distinct descriptor dispatched since the last full reset, in
    cache-key order: the population a warm-start manifest records."""
    return [_seen_descs[k] for k in sorted(_seen_descs, key=repr)]


def save_manifest(path: str,
                  descriptors: Optional[Iterable[KernelDescriptor]] = None
                  ) -> int:
    """Record a descriptor manifest for :func:`warmup` (default: every
    descriptor this process dispatched).  Returns the entry count."""
    from . import warmstart as _warmstart
    descs = list(descriptors) if descriptors is not None \
        else seen_descriptors()
    return _warmstart.save_manifest(path, descs)


def warmup(descriptors: Optional[Iterable[KernelDescriptor]] = None, *,
           manifest: Optional[str] = None, build: bool = True
           ) -> Dict[str, int]:
    """Resolve plans and build kernels before the first request.

    For each descriptor (given, loaded from ``manifest``, or from
    ``config.warm_start``) the plan resolves through the tiers without
    operands, so nothing is timed and a preloaded tuning cache serves the
    tuned tier; with ``build`` the family then runs once on zero operands
    on the configured device (``warmstart.synth_operands``), so its
    kernel state is cached and its kernel built (a mesh descriptor, for
    which there are no such operands, warms its plan only).  A build that
    fails warns and counts as ``warmup_failures``; its plan stays warm.
    Returns ``{family: descriptors warmed}``, also counted as
    ``warmups``."""
    from . import warmstart as _warmstart
    cfg = get_config()
    if descriptors is None:
        path = manifest if manifest is not None else cfg.warm_start
        if not path:
            raise ValueError(
                "warmup() needs descriptors, a manifest path, or "
                "configure(warm_start=...) / REPRO_WARM_START")
        descriptors = _warmstart.load_manifest(path)
    counts: Dict[str, int] = {}
    for desc in descriptors:
        fam = get_family(desc.family)
        plan = _resolve_plan(desc, cfg)
        if build:
            try:
                synth = _warmstart.synth_operands(desc, cfg.device)
                if synth is not None:
                    operands, kw = synth
                    fam.execute(desc, plan, *operands, **kw)
            except Exception as e:
                warnings.warn(f"warmup build failed for {desc.family} "
                              f"{desc.cache_key()!r}: {e}")
                _bump(_warmup_failures, desc.family)
        counts[desc.family] = counts.get(desc.family, 0) + 1
        _bump(_warmups, desc.family)
    return counts


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
    def build():
        with span("engine.build", family=key[0]):
            return builder()

    return GLOBAL_KERNEL_CACHE.get_or_build(key, build)


_STAT_KEYS = ("plan_hits", "plan_misses", "plan_evictions", "planner_calls",
              *(f"plan_source_{s}" for s in PLAN_SOURCES),
              "autotune_timings", "autotune_failures", "launches",
              "comm_bytes", "collective_launches", "warmups",
              "warmup_failures",
              "kernel_hits", "kernel_misses", "kernel_evictions")


def stats() -> Dict[str, Dict[str, int]]:
    """Per-family engine stats across both cache layers and the tiers.

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
        for name, counter in (("planner_calls", _plan_calls),
                              ("launches", _launches),
                              ("comm_bytes", _comm_bytes),
                              ("collective_launches", _collective_launches),
                              ("autotune_timings", _autotune_timings),
                              ("autotune_failures", _autotune_failures),
                              ("warmups", _warmups),
                              ("warmup_failures", _warmup_failures)):
            for fam, n in counter.items():
                b, sfx = slot(fam)
                b[name + sfx] = n
        for fam, sources in _plan_sources.items():
            b, sfx = slot(fam)
            for src, n in sources.items():
                b[f"plan_source_{src}{sfx}"] = n
    for fam, c in GLOBAL_KERNEL_CACHE.family_stats().items():
        b, sfx = slot(fam)
        b["kernel_hits" + sfx], b["kernel_misses" + sfx] = \
            c["hits"], c["misses"]
        b["kernel_evictions" + sfx] = c["evictions"]
    return out


def reset_stats(*, entries: bool = True):
    """Reset all engine counters.  ``entries=True`` also drops cached plans,
    built kernels, the tuning caches' in-memory mirrors (the files stay: a
    fresh mirror re-reads them, as a restarted process would) and the
    dispatched-descriptor record; ``entries=False`` keeps all of them warm,
    so a phase's counts stand alone."""
    if entries:
        PLAN_CACHE.clear()
        GLOBAL_KERNEL_CACHE.clear()
        _autotune.reset_tuning_caches()
        _seen_descs.clear()
    else:
        PLAN_CACHE.reset_stats()
        GLOBAL_KERNEL_CACHE.reset_stats()
    with _counters_lock:
        for counter in (_plan_calls, _launches, _comm_bytes,
                        _collective_launches, _plan_sources,
                        _autotune_timings, _autotune_failures, _warmups,
                        _warmup_failures):
            counter.clear()
