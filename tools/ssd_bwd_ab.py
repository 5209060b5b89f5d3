#!/usr/bin/env python3
"""Time of the port's SSD scan backward (``ssd_scan_bwd``) at chip_smoke.py's
``train_model_dtypes`` case -- full-width mamba2-130m training at 8 x 1024:
192 groups of 4 chunks of 256, state 128, head dim 64, bf16 C / B, fp32 L
and xdt -- taken from the source tree ``--src``, so that two trees can be
compared on one card in turns:

    for t in old new new old; do python3 tools/ssd_bwd_ab.py --src $t/src; done

Each call of this script prints one JSON line: the card's name and power
limit, the tree, the device milliseconds of one call (a CUDA graph of 5
calls under CUDA events, chip_smoke's ``graph_ms``) and its host-timed
milliseconds (chip_smoke's ``time_ms``, 10 calls), and the route the call
took where the tree counts routes.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="the src/ directory whose repro_torch is timed")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels.ssd_chunk import kernel as sk

    label, shape, dtypes, _ = next(c for c in cs.ssd_cases()
                                   if c[0] == "train_model_dtypes")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ops = cs._ssd_operands(torch, shape, dtypes, gen)
    _, _, states = sk.ssd_scan_fused_plain(*ops, return_states=True)
    dy = torch.randn(ops[3].shape, generator=gen, device="cuda")
    dsf = torch.randn(ops[6].shape, generator=gen, device="cuda")

    def bwd():
        return sk.ssd_scan_bwd(*ops[:6], states, dy, dsf)

    routes = getattr(sk, "SSD_BWD_ROUTES", None)
    before = dict(routes) if routes is not None else None
    bwd()
    torch.cuda.synchronize()
    route = None if routes is None else \
        [r for r, n in routes.items() if n != before[r]]
    out = dict(device_ms=cs.graph_ms(torch, bwd, iters=5),
               ms=cs.time_ms(torch, bwd, 10))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "src": args.src, "case": label,
                      "shape": list(shape), "route": route, **out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
