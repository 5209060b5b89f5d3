"""Empirical plan autotuner and the persistent tuning cache.

The planners in :mod:`repro_torch.core.blocking` rank tilings with a cost
model; :func:`search` times the top candidates
(:func:`~repro_torch.core.blocking.candidate_plans`) through the family
executor on the call's own operands and returns the fastest, with
``plan_source="autotuned"``.  Winners persist in a JSON
:class:`TuningCache`, so a restarted process replays them without timing
anything.  The three-tier resolution (tuned cache, autotune, model) is
``engine._resolve_plan``'s; this module owns the search and the file.

The file format is the reference's (``tools/tune.py show/merge/export``
read it).  An entry's key is ``"<machine.tuning_key>|<mode>|<desc
cache_key repr>"``, where the mode is the device type the winner was timed
on, ``cuda`` or ``cpu`` (the reference's ``interpret`` / ``compiled``): a
winner timed on the CPU never serves the card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .blocking import (BlockingPlan, FlashPlan, GroupedGemmPlan, Region,
                       SsdChunkPlan, TransposePlan, candidate_plans)
from .descriptor import KernelDescriptor
from .machine import MachineModel

TUNING_CACHE_VERSION = 1

# One untimed call (kernel build, first launch), then ``_TIME_ITERS`` timed
# calls; a candidate scores its fastest.  A winner persists, so one
# scheduler hiccup must not decide it.
_TIME_ITERS = 3

# desc.cache_key() -> [(candidate, seconds or None if it failed), ...] of
# the latest search on that descriptor, in candidate order.
TIMED: Dict[tuple, List[Tuple[Any, Optional[float]]]] = {}


# ---------------------------------------------------------------------------
# Plan <-> JSON records
# ---------------------------------------------------------------------------

def _desc_dtypes(desc: KernelDescriptor) -> list:
    """Every dtype field of a descriptor and its quant spec, recorded with
    the knobs and checked on replay (the key separates them already; this
    guards hand-edited or foreign records)."""
    vals = []
    for attr in ("in_dtype", "acc_dtype", "out_dtype", "dtype"):
        v = getattr(desc, attr, None)
        if v is not None:
            vals.append(f"{attr}={v}")
    vals.append(f"quant={getattr(desc, 'quant', None)!r}")
    return vals


def plan_to_record(plan: Any) -> Dict[str, Any]:
    """A plan's tiling knobs as a JSON record (the descriptor is the key)."""
    if isinstance(plan, BlockingPlan):
        rec = {"family": "gemm",
               "regions": [[r.row0, r.col0, r.rows, r.cols, r.bm, r.bn]
                           for r in plan.regions],
               "bk": plan.bk, "heterogeneous": plan.heterogeneous,
               "fused": plan.fused}
        if plan.comm is not None:
            rec["comm"] = plan.comm  # mesh strategy
    elif isinstance(plan, FlashPlan):
        rec = {"family": "flash_attention",
               "block_q": plan.block_q, "block_k": plan.block_k,
               "fused": plan.fused}
    elif isinstance(plan, GroupedGemmPlan):
        rec = {"family": "grouped_gemm",
               "bm": plan.bm, "bk": plan.bk, "bn": plan.bn,
               "fused": plan.fused}
        if plan.comm is not None:
            rec["comm"] = plan.comm  # mesh strategy
    elif isinstance(plan, TransposePlan):
        rec = {"family": "transpose", "bt": plan.bt}
    elif isinstance(plan, SsdChunkPlan):
        rec = {"family": "ssd_chunk", "fits_vmem": plan.fits_vmem,
               "fused": plan.fused}
    else:
        raise TypeError(f"unknown plan type: {type(plan).__name__}")
    rec["dtypes"] = _desc_dtypes(plan.desc)
    return rec


def plan_from_record(desc: KernelDescriptor,
                     record: Dict[str, Any]) -> Optional[Any]:
    """Rebuild a plan from its record; None on any mismatch (family,
    dtypes, malformed knobs), so the caller re-plans."""
    try:
        family = record["family"]
        if family != desc.family:
            return None
        want = record.get("dtypes")
        if want is not None and list(want) != _desc_dtypes(desc):
            return None
        fused = bool(record.get("fused", False))
        if family == "gemm":
            regions = tuple(Region(*map(int, r)) for r in record["regions"])
            return BlockingPlan(desc, regions, int(record["bk"]),
                                bool(record["heterogeneous"]), fused=fused,
                                plan_source="autotuned",
                                comm=record.get("comm"))
        if family == "flash_attention":
            return FlashPlan(desc, int(record["block_q"]),
                             int(record["block_k"]), fused=fused,
                             plan_source="autotuned")
        if family == "grouped_gemm":
            return GroupedGemmPlan(desc, int(record["bm"]), int(record["bk"]),
                                   int(record["bn"]), fused=fused,
                                   plan_source="autotuned",
                                   comm=record.get("comm"))
        if family == "transpose":
            return TransposePlan(desc, int(record["bt"]),
                                 plan_source="autotuned")
        if family == "ssd_chunk":
            return SsdChunkPlan(desc, bool(record["fits_vmem"]), fused=fused,
                                plan_source="autotuned")
        return None
    except (KeyError, TypeError, ValueError):
        return None


def _entry_key(machine_key: str, desc: KernelDescriptor, mode: str) -> str:
    # Keyed by ``machine.tuning_key`` (the name plus the +net / +refit
    # provenance), not the constants fingerprint: winners survive probe
    # drift on one host, but a network-calibrated host's mesh winners never
    # serve an uncalibrated one.
    return f"{machine_key}|{mode}|{desc.cache_key()!r}"


# ---------------------------------------------------------------------------
# Persistent tuning cache
# ---------------------------------------------------------------------------

class TuningCache:
    """On-disk JSON store of autotuned winners, mirrored in memory::

        {"version": 1,
         "entries": {"<machine>|<mode>|<desc cache-key repr>":
                     {"family": ..., <knobs>, "dtypes": [...],
                      "us": <measured>, "ts": <wall-clock stamp>}}}

    A missing file is an empty cache; a corrupt one warns and is treated
    as empty (the next ``store`` rewrites it whole).  Writes are atomic
    (a temporary file, then ``os.replace``)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict[str, Any]] = {}
        self._load()

    def _load(self):
        try:
            with open(self.path) as f:
                data = json.load(f)
            if not isinstance(data, dict) or "entries" not in data:
                raise ValueError("not a tuning-cache file")
            if not isinstance(data["entries"], dict):
                raise ValueError("entries must be an object")
            self._entries = data["entries"]
        except FileNotFoundError:
            self._entries = {}
        except (json.JSONDecodeError, ValueError, OSError) as e:
            warnings.warn(f"ignoring corrupt tuning cache {self.path}: {e}")
            self._entries = {}

    def lookup(self, machine_key: str, desc: KernelDescriptor, *,
               mode: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._entries.get(_entry_key(machine_key, desc, mode))

    def store(self, machine_key: str, desc: KernelDescriptor, plan: Any,
              measured_us: float, *, mode: str):
        record = plan_to_record(plan)
        record["us"] = round(float(measured_us), 3)
        # tools/tune.py merge keeps the newest record of a key by this.
        record["ts"] = round(time.time(), 3)
        with self._lock:
            self._entries[_entry_key(machine_key, desc, mode)] = record
            self._flush_locked()

    def _flush_locked(self):
        payload = {"version": TUNING_CACHE_VERSION, "entries": self._entries}
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tuning.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# One mirror per file per process, dropped by ``reset_tuning_caches`` (a
# fresh mirror re-reads the file, as a restarted process would).
_CACHES: Dict[str, TuningCache] = {}
_caches_lock = threading.Lock()


def get_tuning_cache(path: str) -> TuningCache:
    """The process-wide :class:`TuningCache` mirror of one file."""
    key = os.path.abspath(path)
    with _caches_lock:
        cache = _CACHES.get(key)
        if cache is None:
            cache = _CACHES[key] = TuningCache(path)
        return cache


def reset_tuning_caches():
    """Drop every in-memory mirror and search record (files stay)."""
    with _caches_lock:
        _CACHES.clear()
    TIMED.clear()


# ---------------------------------------------------------------------------
# Empirical search
# ---------------------------------------------------------------------------

def _tensors(operands: tuple, kw: Dict[str, Any]) -> List[torch.Tensor]:
    return [v for v in list(operands) + list(kw.values())
            if isinstance(v, torch.Tensor)]


def operand_mode(operands: tuple, kw: Dict[str, Any]) -> Optional[str]:
    """The device type the operands live on (the tuning-cache mode)."""
    ts = _tensors(operands, kw)
    return ts[0].device.type if ts else None


def can_autotune(operands: tuple, kw: Dict[str, Any]) -> bool:
    """Timing needs operands with data, on the CPU or the card (not meta
    tensors, which only carry shapes)."""
    ts = _tensors(operands, kw)
    return bool(ts) and all(t.device.type in ("cpu", "cuda") for t in ts)


def _time_plan(execute, desc, plan, operands, kw: Dict[str, Any]) -> float:
    """Seconds of one candidate: one untimed call, then the fastest of
    ``_TIME_ITERS``; on the card between CUDA events, after a
    synchronise."""
    cuda = operand_mode(operands, kw) == "cuda"
    execute(desc, plan, *operands, **kw)
    if cuda:
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(_TIME_ITERS):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            execute(desc, plan, *operands, **kw)
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) * 1e-3
        else:
            t0 = time.perf_counter()
            execute(desc, plan, *operands, **kw)
            t = time.perf_counter() - t0
        best = min(best, t)
    return best


def search(execute, desc: KernelDescriptor, machine: MachineModel,
           operands: tuple, kw: Dict[str, Any], *, budget: int,
           tuning_cache: Optional[TuningCache] = None,
           on_failure: Optional[Callable[[], None]] = None
           ) -> Tuple[Optional[Any], int]:
    """Time the top-``budget`` candidates; return (winner, timed count).

    The winner carries ``plan_source="autotuned"`` and is stored in
    ``tuning_cache`` when one is given.  A candidate that raises is
    skipped with a warning and reported to ``on_failure``; if every one
    fails the winner is None and the caller plans by the model.  Fewer
    than two candidates (after a forced ``config.fused`` mode drops the
    other lowering's) leave nothing to choose: nothing is timed."""
    from .config import get_config
    candidates = candidate_plans(desc, machine, top_k=budget)
    mode = get_config().fused
    if mode != "auto":
        # The executor would run every candidate on the forced lowering:
        # time only those whose bit it is, and persist no untimed bit.
        want = mode == "on"
        candidates = [c for c in candidates
                      if getattr(c, "fused", want) == want]
    if len(candidates) < 2:
        return None, 0
    dev_mode = operand_mode(operands, kw) or "cpu"
    best_plan, best_t, timed = None, float("inf"), 0
    log: List[Tuple[Any, Optional[float]]] = []
    for plan in candidates:
        try:
            t = _time_plan(execute, desc, plan, operands, kw)
        except Exception as e:  # a build or launch failure: skip it
            warnings.warn(f"autotune candidate failed for {desc.family}: {e}")
            log.append((plan, None))
            if on_failure is not None:
                on_failure()
            continue
        timed += 1
        log.append((plan, t))
        if t < best_t:
            best_plan, best_t = plan, t
    TIMED[desc.cache_key()] = log
    if best_plan is None:
        return None, timed
    best_plan = dataclasses.replace(best_plan, plan_source="autotuned")
    if tuning_cache is not None:
        tuning_cache.store(machine.tuning_key, desc, best_plan, best_t * 1e6,
                           mode=dev_mode)
    return best_plan, timed
