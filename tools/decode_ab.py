#!/usr/bin/env python3
"""Device time of the port's paged decode kernel (``flash_decode``) at
chip_smoke.py's ``serve_ragged`` case -- 8 slots of lengths 0-300, 16 query
/ 8 KV heads of 128, 96 pages of 16, 24 blocks -- over bf16 and KV-int8
pools, taken from the source tree ``--src``, so that two trees can be
compared on one card in turns:

    for t in old new new old; do python3 tools/decode_ab.py --src $t/src; done

Each call of this script prints one JSON line: the card's name and power
limit, the tree, and per pool type the device milliseconds of one call (a
CUDA graph of 20 calls under CUDA events, chip_smoke's ``graph_ms``), warm
and after a 64 MB L2 flush.  Needs a CUDA device.
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
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import DecodeTileSchedule
    from repro_torch.kernels.flash_attention.kernel import (FlashDecode,
                                                            flash_decode)
    from repro_torch.models.attention import quantize_kv_rows

    S, P, B, h, hkv, hd = (cs.CONT_SLOTS, cs.CONT_PAGE, cs.CONT_BLOCKS, 16,
                           8, 128)
    lengths = (0, 1, 16, 17, 300, 255, 100, 33)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((S, h, hd), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((cs.CONT_PAGES, P, hkv, hd), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    perm = torch.randperm(cs.CONT_PAGES,
                          generator=torch.Generator().manual_seed(3))
    bt = torch.zeros((S, B), dtype=torch.int32)
    used = 0
    for slot, n in enumerate(-(-L // P) for L in lengths):
        bt[slot, :n] = perm[used:used + n]
        used += n
    exe = FlashDecode(DecodeTileSchedule(num_seqs=S, pages=cs.CONT_PAGES,
                                         page_size=P, max_blocks=B), "cuda")
    exe.update(bt.cuda(), torch.tensor(lengths, dtype=torch.int32,
                                       device="cuda"))
    (kq, ks), (vq, vs) = (quantize_kv_rows(t) for t in (k, v))
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    out = {}
    for name, fn in (("bf16", lambda: flash_decode(exe, q, k, v)),
                     ("int8", lambda: flash_decode(exe, q, kq, vq, ks, vs))):
        out[name] = dict(device_ms=cs.graph_ms(torch, fn),
                         cold_ms=cs.graph_ms(torch, fn, flush=flush))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "src": args.src, "lengths": lengths,
                      **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
