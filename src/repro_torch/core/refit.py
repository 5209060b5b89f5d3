"""Offline refit of a machine model's cost coefficients from tuning-cache
timings.

Probes calibrate a :class:`~repro_torch.core.machine.MachineModel`, the
model ranks candidate plans, and the autotuner's measured winners collect
in the :class:`~repro_torch.core.autotune.TuningCache`.  This module turns
those measurements back onto the model's dispatch coefficients, so the
analytical tier itself ranks better, as the reference's does.

Every plan's ``predicted_seconds(machine)`` is affine in five coefficients
(``step_overhead_s``, ``launch_overhead_s``, ``launch_overhead_s *
extra_launch_factor``, ``fused_tile_decode_s``, ``stitch_discount``), so a
record's features are exact finite differences of the predictor against a
coefficient-zeroed machine.  The residual (measured seconds minus that
roofline base) is solved by least squares with Huber reweighting and
clipped at zero.  The output is the reference's versioned refit-model JSON
with a provenance fingerprint; :func:`~repro_torch.core.machine.
load_refit_model` applies it with the ``+refit`` stamp.  A second stage,
:func:`fit_network`, backs the collective coefficients out of the records
of mesh plans (their ``mesh_comm_events`` bytes against the time left
after the local kernel).  ``tools/tune_torch.py refit`` is the CLI.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from . import autotune as _autotune
from .blocking import mesh_comm_events
from .descriptor import descriptor_from_cache_key
from .machine import (DEFAULT_MACHINE, MachineModel, REFIT_MODEL_VERSION,
                      apply_refit)

# The fitted coefficients, in feature order; ``extra_launch_s`` is the
# product ``launch_overhead_s * extra_launch_factor`` (the factor is
# recovered by division after the solve).
FIT_FEATURES = ("step_overhead_s", "launch_overhead_s", "extra_launch_s",
                "fused_tile_decode_s", "stitch_discount")

# Coefficient values that zero every fitted term of the predictor.
_ZEROED = dict(step_overhead_s=0.0, launch_overhead_s=0.0,
               extra_launch_factor=0.0, fused_tile_decode_s=0.0,
               stitch_discount=0.0)

_COLLECTIVES = ("all_gather", "all_to_all", "psum")


def parse_entry(key: str, record: dict) -> Optional[Tuple[str, str, Any]]:
    """``(machine_key, mode, plan)`` of one tuning-cache entry, or None for
    anything that does not parse or has no measured ``us``."""
    try:
        machine_key, mode, desc_repr = key.split("|", 2)
        desc = descriptor_from_cache_key(ast.literal_eval(desc_repr))
    except (ValueError, SyntaxError, TypeError, KeyError):
        return None
    if not isinstance(record, dict) or "us" not in record:
        return None
    plan = _autotune.plan_from_record(desc, record)
    if plan is None:
        return None
    return machine_key, mode, plan


def plan_features(plan: Any, machine: MachineModel
                  ) -> Tuple[float, Tuple[float, ...]]:
    """``(base_seconds, features)`` of one plan: predicted = base +
    features . coefficients, by finite differences against a
    coefficient-zeroed copy of ``machine``."""
    zero = dataclasses.replace(machine, **_ZEROED)
    base = plan.predicted_seconds(zero)

    def bump(**kw) -> float:
        return plan.predicted_seconds(dataclasses.replace(zero, **kw)) - base

    f_step = bump(step_overhead_s=1.0)
    f_launch = bump(launch_overhead_s=1.0)
    # launch term lo * (1 + (L - 1) * ef): at lo = ef = 1, less f_launch,
    # the (L - 1) extra-launch feature.
    f_extra = bump(launch_overhead_s=1.0, extra_launch_factor=1.0) - f_launch
    f_decode = bump(fused_tile_decode_s=1.0)
    f_stitch = bump(stitch_discount=1.0)
    return base, (f_step, f_launch, f_extra, f_decode, f_stitch)


def _irls_lstsq(X: np.ndarray, y: np.ndarray,
                robust_iters: int) -> np.ndarray:
    """Least squares with Huber reweighting (columns scaled)."""
    scale = np.abs(X).max(axis=0)
    scale[scale == 0] = 1.0
    Xs = X / scale
    w = np.ones(len(y))
    beta = np.zeros(X.shape[1])
    for _ in range(robust_iters + 1):
        sw = np.sqrt(w)[:, None]
        beta, *_ = np.linalg.lstsq(Xs * sw, y * np.sqrt(w), rcond=None)
        r = y - Xs @ beta
        s = 1.4826 * np.median(np.abs(r)) + 1e-12
        w = np.minimum(1.0, 1.345 * s / np.maximum(np.abs(r), 1e-12))
    return beta / scale


def fit_records(records: Iterable[Tuple[Any, float]],
                base: MachineModel = DEFAULT_MACHINE, *,
                robust_iters: int = 3) -> Dict[str, Any]:
    """Fit the dispatch coefficients from ``(plan, measured_us)`` pairs.

    Returns ``coefficients`` (a coefficient no record exercises keeps the
    base value), ``fitted`` (the names the records identify), ``entries``
    and the RMS residuals before and after in microseconds.  Raises
    ``ValueError`` without a record."""
    plans, bases, rows, y = [], [], [], []
    for plan, us in records:
        b, f = plan_features(plan, base)
        plans.append(plan)
        bases.append(b)
        rows.append(f)
        y.append(us * 1e-6 - b)
    if not rows:
        raise ValueError("no usable records to fit")
    X = np.asarray(rows, float)
    yv = np.asarray(y, float)
    active = np.flatnonzero(np.abs(X).max(axis=0) > 0)
    beta = np.zeros(X.shape[1])
    if active.size:
        beta[active] = _irls_lstsq(X[:, active], yv, robust_iters)
    beta = np.maximum(beta, 0.0)  # a charge is never negative
    step, launch, extra, decode, stitch = beta
    fitted = [FIT_FEATURES[i] for i in active]
    coeffs = {
        "step_overhead_s": float(step) if "step_overhead_s" in fitted
        else base.step_overhead_s,
        "launch_overhead_s": float(launch) if "launch_overhead_s" in fitted
        else base.launch_overhead_s,
        "fused_tile_decode_s": float(decode)
        if "fused_tile_decode_s" in fitted else base.fused_tile_decode_s,
        # The stitch feature is taken at discount 1: the coefficient is the
        # discount, a fraction of the naive bytes.
        "stitch_discount": float(min(stitch, 1.0))
        if "stitch_discount" in fitted else base.stitch_discount,
    }
    if "extra_launch_s" in fitted and launch > 1e-12:
        coeffs["extra_launch_factor"] = float(
            np.clip(extra / launch, 0.0, 4.0))
        fitted[fitted.index("extra_launch_s")] = "extra_launch_factor"
    else:
        coeffs["extra_launch_factor"] = base.extra_launch_factor
        if "extra_launch_s" in fitted:
            fitted.remove("extra_launch_s")
    before = np.asarray([plan.predicted_seconds(base) for plan in plans]) \
        - (np.asarray(bases) + yv)
    after = (np.asarray(bases) + X @ beta) - (np.asarray(bases) + yv)
    return {
        "coefficients": coeffs,
        "fitted": fitted,
        "entries": len(plans),
        "residual_us": {
            "before": round(float(np.sqrt(np.mean(before**2))) * 1e6, 3),
            "after": round(float(np.sqrt(np.mean(after**2))) * 1e6, 3),
        },
    }


def _comm_free(machine: MachineModel) -> MachineModel:
    """A copy of ``machine`` whose collectives cost about nothing, so that
    a mesh plan's ``predicted_seconds`` is its local kernel's alone."""
    return dataclasses.replace(machine, ici_bandwidth_gbps=1e30,
                               collective_launch_s=0.0,
                               collective_efficiency=None)


def fit_network(records: Iterable[Tuple[Any, float]],
                fitted_machine: MachineModel) -> Optional[Dict[str, Any]]:
    """The collective coefficients backed out of the mesh records.

    Solves ``measured - local prediction = n_events * collective_launch_s
    + sum_c bytes_c * seconds_per_byte_c`` over the records whose plan
    carries a mesh strategy, then turns seconds per byte into
    ``ici_bandwidth_gbps`` (the all_gather column) and
    ``collective_efficiency`` ratios.  None when the mesh records cannot
    identify the system (too few, or no all_gather traffic): the network
    model then stays as probed."""
    rows, y = [], []
    for plan, us in records:
        comm = getattr(plan, "comm", None)
        if comm is None or getattr(plan.desc, "mesh", None) is None:
            continue
        events = mesh_comm_events(plan.desc, comm)
        if not events:
            continue
        feat = [float(len(events))] + [0.0] * len(_COLLECTIVES)
        for c, nbytes in events:
            if c in _COLLECTIVES:
                feat[1 + _COLLECTIVES.index(c)] += float(nbytes)
        local = plan.predicted_seconds(_comm_free(fitted_machine))
        rows.append(feat)
        y.append(us * 1e-6 - local)
    if not rows:
        return None
    X = np.asarray(rows, float)
    yv = np.asarray(y, float)
    active = np.flatnonzero(np.abs(X).max(axis=0) > 0)
    if len(rows) < active.size or 1 not in active:  # the all_gather column
        return None
    beta = np.zeros(X.shape[1])
    beta[active] = np.maximum(_irls_lstsq(X[:, active], yv, 2), 0.0)
    spb_ag = beta[1]
    if spb_ag <= 0:
        return None
    eff = {"all_gather": 1.0}
    for i, c in enumerate(_COLLECTIVES[1:], start=2):
        if beta[i] > 0:
            eff[c] = float(np.clip(spb_ag / beta[i], 1e-3, 1.0))
    return {"collective_launch_s": float(beta[0]),
            "ici_bandwidth_gbps": float(1.0 / (spb_ag * 1e9)),
            "collective_efficiency": eff,
            "entries": len(rows)}


def fit_cache_entries(entries: Dict[str, dict],
                      base: MachineModel = DEFAULT_MACHINE, *,
                      machine: Optional[str] = None,
                      mode: Optional[str] = None) -> Dict[str, Any]:
    """The versioned refit-model payload fitted to one tuning cache's
    ``{key: record}`` entries.  ``machine`` keeps entries whose tuning key
    starts with it, ``mode`` those timed on one device type (``"cuda"`` or
    ``"cpu"``).  The fingerprint digests the base model and the exact
    records fitted."""
    records: List[Tuple[Any, float]] = []
    lines = []
    skipped = 0
    for key in sorted(entries):
        parsed = parse_entry(key, entries[key])
        if parsed is None:
            skipped += 1
            continue
        machine_key, entry_mode, plan = parsed
        if machine and not machine_key.startswith(machine):
            continue
        if mode and entry_mode != mode:
            continue
        us = float(entries[key]["us"])
        records.append((plan, us))
        lines.append(f"{key}:{us}")
    fit = fit_records(records, base)
    net = fit_network(records, dataclasses.replace(base,
                                                   **fit["coefficients"]))
    if net is not None:
        for name in ("collective_launch_s", "ici_bandwidth_gbps",
                     "collective_efficiency"):
            fit["coefficients"][name] = net[name]
        fit["fitted"] += ["collective_launch_s", "ici_bandwidth_gbps",
                          "collective_efficiency"]
    blob = (base.fingerprint + "\n" + "\n".join(lines)).encode()
    return {
        "version": REFIT_MODEL_VERSION,
        "kind": "machine-refit",
        "base": base.name,
        "machine": machine or "",
        "mode": mode or "any",
        "fingerprint": hashlib.md5(blob).hexdigest()[:12],
        "skipped": skipped,
        **fit,
    }


def apply_fit(base: MachineModel, model: Dict[str, Any]) -> MachineModel:
    """Overlay an in-memory refit payload onto ``base`` with the ``+refit``
    stamp (the validated from-disk path is ``load_refit_model``)."""
    return apply_refit(base, model["coefficients"], model["fingerprint"])


def save_refit_model(path: str, model: Dict[str, Any]) -> None:
    """Atomic JSON write of one refit-model payload."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".refit.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(model, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def count_misranks(pairs: Iterable[Tuple[Any, Any, float, float]],
                   machine: MachineModel, *,
                   deadband: float = 0.1) -> Tuple[int, int]:
    """``(misranks, considered)`` of the analytical tier on measured pairs
    ``(plan_a, plan_b, us_a, us_b)``: a pair counts when the measurements
    differ by more than ``deadband`` (relative) and the model prefers the
    slower one."""
    bad = considered = 0
    for pa, pb, ua, ub in pairs:
        lo = min(ua, ub)
        if lo <= 0 or abs(ua - ub) / lo < deadband:
            continue
        considered += 1
        model_a = (pa.predicted_seconds(machine)
                   < pb.predicted_seconds(machine))
        if model_a != (ua < ub):
            bad += 1
    return bad, considered
