#!/usr/bin/env python3
"""Run the port's route-A kernels that synchronise through shared memory,
mbarriers and clusters once each, so that compute-sanitizer can watch them:

    python3 tools/sanitize_kernels.py --build   # nvcc, outside the tool
    compute-sanitizer --tool racecheck python3 tools/sanitize_kernels.py
    compute-sanitizer --tool synccheck python3 tools/sanitize_kernels.py

Cases: ``ssd_scan_fused`` (with the entering states) and ``ssd_scan_bwd``
on route A at NC 1, 2, 4 and 8 chunks a group (3 groups, Q 256, n 128,
p 64; bf16 C / B, fp32 L and xdt: the model's dtypes), and
``transpose_tiles`` on route A at chip_smoke.py's transpose cases.  Each result is held to its plain
version (the SSD kernels at chip_smoke.py's TOL and BWD_TOL, the transpose
bit for bit) and printed as one JSON line; a mismatch or a case off route
A exits 1.  ``--only ssd`` or ``--only transpose`` runs one family.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BF, F32 = "bfloat16", "float32"


def _took(routes, before):
    return [r for r, n in routes.items() if n != before[r]]


def ssd(torch, cs, gen):
    from repro_torch.kernels.ssd_chunk import kernel as sk
    ok = True
    for nc in (1, 2, 4, 8):
        ops = cs._ssd_operands(torch, (3, nc, 256, 128, 64), (BF, F32, F32),
                               gen)
        before = dict(sk.SSD_FWD_ROUTES)
        y, s_final, states = sk.ssd_scan_fused(*ops, return_states=True)
        torch.cuda.synchronize()
        fwd_route = _took(sk.SSD_FWD_ROUTES, before)
        want = sk.ssd_scan_fused_plain(*ops, return_states=True)
        fwd_bad = sum(int(((a.float() - w.float()).abs()
                           > cs.TOL[F32] * (1 + w.float().abs())).sum().item())
                      for a, w in zip((y, s_final, states), want))
        dy = torch.randn(ops[3].shape, generator=gen, device="cuda")
        dsf = torch.randn(ops[6].shape, generator=gen, device="cuda")
        before = dict(sk.SSD_BWD_ROUTES)
        got = sk.ssd_scan_bwd(*ops[:6], want[2], dy, dsf)
        torch.cuda.synchronize()
        bwd_route = _took(sk.SSD_BWD_ROUTES, before)
        bwd_want = sk.ssd_scan_bwd_plain(*ops[:6], want[2], dy, dsf)
        bwd_bad = sum(int(((a - w).abs() > cs.BWD_TOL * (1 + w.abs()))
                          .sum().item()) for a, w in zip(got, bwd_want))
        fine = (fwd_route == ["A"] and bwd_route == ["A"]
                and fwd_bad == 0 and bwd_bad == 0)
        ok = ok and fine
        print(json.dumps(dict(case=f"ssd_nc{nc}", fwd_route=fwd_route,
                              bwd_route=bwd_route, fwd_mismatches=fwd_bad,
                              bwd_mismatches=bwd_bad, ok=fine)), flush=True)
    return ok


def transpose(torch, cs, gen):
    from repro_torch.core import TransposeDescriptor, plan_transpose
    from repro_torch.kernels.transpose import kernel as tk
    ok = True
    for label, shape, dname, pad, _ in cs.transpose_cases():
        x = cs._transpose_source(torch, shape, dname, pad, gen)
        nb, rows, cols = shape
        bt = plan_transpose(TransposeDescriptor(
            rows=rows, cols=cols, dtype=dname, batch=nb)).bt
        if tk.choose_route(x.dtype, rows, cols, x.stride(),
                           x.data_ptr()) != "A":
            continue
        before = dict(tk.TRANSPOSE_ROUTES)
        got = tk.transpose_tiles(x, bt=bt)
        torch.cuda.synchronize()
        route = _took(tk.TRANSPOSE_ROUTES, before)
        exact = bool(torch.equal(got, tk.transpose_plain(x, bt=bt)))
        fine = route == ["A"] and exact
        ok = ok and fine
        print(json.dumps(dict(case=f"transpose_{label}", route=route,
                              bit_exact=exact, ok=fine)), flush=True)
        del got
        del x
        torch.cuda.empty_cache()
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build", action="store_true",
                    help="only build the kernels (run it outside the tool)")
    ap.add_argument("--only", choices=("ssd", "transpose"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sanitize_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    from repro_torch.kernels import _build
    _build.build_all()
    if args.build:
        return 0
    import chip_smoke as cs
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for name, fn in (("ssd", ssd), ("transpose", transpose)):
        if args.only in (None, name):
            ok = fn(torch, cs, gen) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
