"""Roofline analysis over the dry-run records, and of single kernels.

For every (arch x shape) cell of one mesh, the record's per-device FLOPs,
bytes and collective bytes become the three roofline terms (seconds) on a
machine model, the dominant term names the bottleneck, and the analytic
MODEL_FLOPS (6 N_active D to train, 2 N_active D to infer) is set against
the counted FLOPs.  The port's records (``repro_torch.launch.dryrun``)
count the FLOPs and bytes of the engine's kernel descriptors, and carry
no collective or peak-memory figure: a term or a fit that was not
computed stays ``None`` (``—`` in the table), and the dominant term is
taken over the terms that were.  Records in the reference's schema, all
terms computed, read as the reference reads them.

:func:`kernel_roofline` prices one kernel descriptor of any family: the
one yardstick for a kernel's bound, whatever implements it.

    python -m repro_torch.launch.roofline [--mesh pod] [--grid] \
        [--write FILE]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

from repro_torch.core.machine import H100_SXM

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")

HINTS = {
    "compute": "cut recompute (remat policy) and masked-block waste "
               "(causal upper-triangle, one-hot dispatch)",
    "memory": "raise arithmetic intensity: larger per-step tiles, "
              "fuse epilogues, bf16 end-to-end",
    "collective": "reshard to cut per-layer gathers (FSDP prefetch, "
                  "sequence-parallel boundaries, EP vs TP-f choice)",
}


def kernel_roofline(desc, machine=H100_SXM, chips: int = 1) -> dict:
    """Roofline terms of ONE engine kernel descriptor, any family: its
    FLOPs at the peak of its dtype, its bytes (each operand read once,
    each output written once) at the memory rate."""
    compute_s = machine.compute_seconds(desc.flops, desc.dtype
                                        if hasattr(desc, "dtype")
                                        else desc.in_dtype, chips)
    memory_s = machine.memory_seconds(desc.in_bytes + desc.out_bytes, chips)
    dominant = "compute" if compute_s >= memory_s else "memory"
    return {
        "family": desc.family,
        "flops": desc.flops,
        "bytes": desc.in_bytes + desc.out_bytes,
        "arithmetic_intensity": desc.arithmetic_intensity,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "dominant": dominant,
    }


def model_flops(rec: dict, cfg, suite) -> float:
    """Analytic useful FLOPs per step, global."""
    n_active = cfg.active_param_count()
    tokens = suite.global_batch * suite.seq_len
    if suite.kind == "train":
        return 6.0 * n_active * tokens
    if suite.kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * suite.global_batch


def _div(x, y):
    return None if x is None else x / y


def analyze_record(rec: dict, machine=H100_SXM) -> Optional[dict]:
    """The roofline row of one ``ok`` record (None for skips and errors).
    ``fits_hbm`` compares the peak per device with ``machine.hbm_bytes``
    (the reference's ``fits_16gb``, its TPU v5e budget)."""
    from repro_torch.configs import get_config, shape_for
    if rec.get("status") != "ok":
        return None
    cfg = get_config(rec["arch"])
    suite = shape_for(rec["shape"])
    chips = rec["chips"]
    m = machine
    flops_dev = rec["cost"]["flops_per_device"]
    bytes_dev = rec["cost"]["bytes_per_device"]
    coll_dev = rec.get("collective_bytes_per_device")
    peak_dev = rec["memory"].get("peak_per_device")

    compute_s = flops_dev / m.peak("bfloat16")
    memory_s = bytes_dev / m.hbm_bw
    collective_s = _div(coll_dev, m.ici_bw_per_link)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    known = {k: v for k, v in terms.items() if v is not None}
    dominant = max(known, key=known.get)
    mf = model_flops(rec, cfg, suite) / chips
    ratio = mf / max(flops_dev, 1.0)
    bound = max(known.values())
    useful_s = mf / m.peak("bfloat16")
    roofline_frac = useful_s / max(bound, 1e-12)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "chips": chips,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops_per_dev": mf,
        "hlo_flops_per_dev": flops_dev,
        "useful_ratio": ratio,
        "roofline_frac": roofline_frac,
        "peak_mem_gb": _div(peak_dev, 2**30),
        "fits_hbm": None if peak_dev is None or m.hbm_bytes is None
        else peak_dev <= m.hbm_bytes,
        "hint": HINTS[dominant],
    }


def load_records(mesh: str = "pod", results_dir: str = RESULTS_DIR
                 ) -> List[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("mesh") != mesh:
            continue
        out.append(rec)
    return out


def _f(x, fmt: str) -> str:
    return "—" if x is None else format(x, fmt)


def _fits(x) -> str:
    return "—" if x is None else ("yes" if x else "NO")


def render_table(rows: List[dict], skips: List[dict]) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | "
           "dominant | MODEL/HLO | roofline frac | peak GB | fits |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {_f(r['collective_s'], '.3f')} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['roofline_frac']:.3f} | {_f(r['peak_mem_gb'], '.1f')} | "
            f"{_fits(r['fits_hbm'])} |")
    for s in skips:
        lines.append(f"| {s['arch']} | {s['shape']} | — | — | — | skip | — "
                     f"| — | — | — |")
    return hdr + "\n".join(lines) + "\n"


_SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def render_grid(rows: List[dict], skips: List[dict]) -> str:
    """The same rows, one line an architecture and a column a shape:
    ``compute s / memory s``, the dominant term's initial, MODEL/HLO."""
    shapes = sorted({r["shape"] for r in rows} | {s["shape"] for s in skips},
                    key=_SHAPE_ORDER.index)
    cells = {(r["arch"], r["shape"]): (
        f"{r['compute_s']:.3g} / {r['memory_s']:.3g} "
        f"{r['dominant'][0].upper()}, {r['useful_ratio']:.2f}") for r in rows}
    cells.update({(s["arch"], s["shape"]): "skip" for s in skips})
    out = ["| arch | " + " | ".join(shapes) + " |",
           "|---|" + "---|" * len(shapes)]
    for arch in sorted({a for a, _ in cells}):
        out.append(f"| {arch} | " + " | ".join(
            cells.get((arch, s), "—") for s in shapes) + " |")
    return "\n".join(out) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod")
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    ap.add_argument("--write", default=None)
    ap.add_argument("--json", default=None)
    ap.add_argument("--grid", action="store_true",
                    help="one line an architecture, a column a shape")
    args = ap.parse_args(argv)
    rows, skips = [], []
    for rec in load_records(args.mesh, args.results_dir):
        if rec.get("status") == "skip":
            skips.append(rec)
            continue
        r = analyze_record(rec)
        if r:
            rows.append(r)
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    table = (render_grid if args.grid else render_table)(rows, skips)
    print(table)
    for r in rows:
        print(f"{r['arch']} x {r['shape']}: {r['dominant']}-bound -> "
              f"{r['hint']}")
    if args.write:
        with open(args.write, "w") as f:
            f.write(f"# Roofline ({args.mesh} mesh, per-device terms, "
                    f"descriptor counts on the host)\n\n")
            f.write(table)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)


if __name__ == "__main__":
    main()
