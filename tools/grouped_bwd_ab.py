#!/usr/bin/env python3
"""Time of the port's grouped-GEMM backward (``grouped_bwd``) at chip_smoke.py's
two main-path cases -- phi3.5-moe-42b's expert GEMMs in training: 16 groups
of 256 capacity rows, ``prefill_gate_silu`` (K 4096 -> N 6400) and
``prefill_down`` (K 6400 -> N 4096), bf16 x and w, an fp32 cotangent --
taken from the source tree ``--src``, so that two trees can be compared on
one card in turns:

    for t in old new new old; do python3 tools/grouped_bwd_ab.py --src $t/src; done

Each call of this script prints one JSON line: the card's name and power
limit, the tree, and per case and summed over both the device milliseconds
of one call (a CUDA graph of 3 calls under CUDA events, chip_smoke's
``graph_ms``) and its host-timed milliseconds (chip_smoke's ``time_ms``, 5
calls), and the route each call took where the tree counts routes.  Needs
a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = ("prefill_gate_silu", "prefill_down")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="the src/ directory whose repro_torch is timed")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("grouped_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import GroupedGemmDescriptor, plan_grouped
    from repro_torch.kernels.grouped_gemm import kernel as grk
    torch.backends.cuda.matmul.allow_tf32 = False

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for case in cs.grouped_cases():
        label, sizes, extra, k, n, epi = case[:6]
        if label not in CASES:
            continue
        e, t = len(sizes), sum(sizes) + extra
        x = torch.randn((t, k), generator=gen, device="cuda").bfloat16()
        w = (torch.randn((e, k, n), generator=gen, device="cuda")
             * k ** -0.5).bfloat16()
        dy = torch.randn((t, n), generator=gen, device="cuda")
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        plan = plan_grouped(GroupedGemmDescriptor(
            t=t, k=k, n=n, num_experts=e, dtype="bfloat16", epilogue=epi))
        table = plan.tile_schedule().tables(gs)

        def bwd():
            return grk.grouped_bwd(table, x, dy, w, gs, bm=plan.bm)

        routes = getattr(grk, "BWD_ROUTES", None)
        before = dict(routes) if routes is not None else None
        bwd()
        torch.cuda.synchronize()
        route = None if routes is None else \
            [r for r, c in routes.items() if c != before[r]]
        out[label] = dict(device_ms=cs.graph_ms(torch, bwd, iters=3),
                          ms=cs.time_ms(torch, bwd, 5), route=route,
                          bm=plan.bm)
        del x, w, dy
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "src": args.src, "cases": out,
                      "device_ms": sum(c["device_ms"] for c in out.values()),
                      "ms": sum(c["ms"] for c in out.values())}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
