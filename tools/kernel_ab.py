#!/usr/bin/env python3
"""Device times of one of the port's kernels at chip_smoke.py's main-path
cases, taken from the source tree ``--src``, so that two trees can be
compared on one card in turns:

    for t in old new new old; do
        python3 tools/kernel_ab.py ssd_fwd --src $t/src
    done

Kernels and cases (chip_smoke.py's operands and shapes):

  * ``decode`` -- the paged decode (``flash_decode``) at ``serve_ragged``:
    8 slots of lengths 0-300, 16 query / 8 KV heads of 128, 96 pages of
    16, 24 blocks, over bf16 and KV-int8 pools; warm and after a 64 MB L2
    flush (CUDA graphs of 20 calls);
  * ``ssd_fwd`` -- ``ssd_scan_fused`` at ``serve_model_dtypes`` (mamba2-130m
    serving at batch 4 x 1000: 96 groups of 4 chunks of 256, state 128,
    head dim 64, bf16 C / B, fp32 L and xdt) and ``train_model_dtypes``
    (192 groups, with the entering states), and ``ssd_chunk_diag`` on
    serving's 384 flattened cells;
  * ``ssd_bwd`` -- ``ssd_scan_bwd`` at ``train_model_dtypes``;
  * ``grouped_bwd`` -- ``grouped_bwd`` at phi3.5-moe training's
    ``prefill_gate_silu`` and ``prefill_down`` cases;
  * ``transpose`` -- ``transpose_tiles`` at ``fig89_256x512`` (256 x 512
    fp32) and ``qwen3_tied_table`` (151,936 x 1,024 bf16), warm and after a
    64 MB L2 flush (CUDA graphs of 20 calls), beside ``x.transpose(-2,
    -1).contiguous()`` and ``x.clone()`` (the card's copy rate on the same
    bytes); the other tile edge (``<case>:bt=<edge>``) and, where the tree
    counts routes, route B on the same view (``<case>:route=B``); the small
    case also its host microseconds a call (``host_us``: the least of 5
    runs of 200 calls on the host clock);
  * ``gemm_act_bwd`` -- the backward of phi3-mini's gate GEMM at
    phi3mini-train's rows (32,768 x 3,072 @ 3,072 x 8,192, silu, bf16):
    the pre-activation's cotangent by ``gemm_act_bwd`` where the tree has
    it (``fused``), by the fp32 recompute and autograd of the epilogue
    (``plain``; ``plain_product`` its cuBLAS fp32 product alone), beside
    the forward ``gemm_fused`` and cuBLAS's bf16 product of the same
    operands (``cublas_bf16``); host-timed under CUDA events, 5 calls.

Each call prints one JSON line: the card's name and power limit, the tree,
the kernel, and for each case the device milliseconds of one call
(``device_ms``: a CUDA graph of the calls under CUDA events, chip_smoke's
``graph_ms``), host-timed milliseconds (``ms``, chip_smoke's ``time_ms``)
or the L2-cold device time (``cold_ms``), and the route it took where the
tree counts routes.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _route(routes, call, torch):
    """Runs call once; the routes it added to, where the tree counts
    them."""
    before = dict(routes) if routes is not None else None
    call()
    torch.cuda.synchronize()
    return None if routes is None else \
        [r for r, n in routes.items() if n != before[r]]


def decode(torch, cs, gen):
    from repro_torch.core import DecodeTileSchedule
    from repro_torch.kernels.flash_attention.kernel import (FlashDecode,
                                                            flash_decode)
    from repro_torch.models.attention import quantize_kv_rows

    S, P, B, h, hkv, hd = (cs.CONT_SLOTS, cs.CONT_PAGE, cs.CONT_BLOCKS, 16,
                           8, 128)
    lengths = (0, 1, 16, 17, 300, 255, 100, 33)
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
    return out


def ssd_fwd(torch, cs, gen):
    from repro_torch.kernels.ssd_chunk import kernel as sk

    cases = {c[0]: c for c in cs.ssd_cases()}
    routes = getattr(sk, "SSD_FWD_ROUTES", None)
    out = {}
    for label, kname in (("serve_model_dtypes", "ssd_scan_fused"),
                         ("train_model_dtypes", "ssd_scan_fused"),
                         ("serve_model_dtypes", "ssd_chunk_diag")):
        _, shape, dtypes, _ = cases[label]
        ops = cs._ssd_operands(torch, shape, dtypes, gen)
        if kname == "ssd_chunk_diag":
            g, nc = shape[:2]
            flat = [t.reshape(g * nc, *t.shape[2:]) for t in ops[:4]]

            def call(flat=flat):
                return sk.ssd_chunk_diag(*flat)
        else:
            states = label.startswith("train")

            def call(ops=ops, states=states):
                return sk.ssd_scan_fused(*ops, return_states=states)
        route = _route(routes, call, torch)
        out[f"{kname}:{label}"] = dict(
            device_ms=cs.graph_ms(torch, call, iters=5),
            ms=cs.time_ms(torch, call, 10), route=route)
        del ops
    return out


def ssd_bwd(torch, cs, gen):
    from repro_torch.kernels.ssd_chunk import kernel as sk

    label, shape, dtypes, _ = next(c for c in cs.ssd_cases()
                                   if c[0] == "train_model_dtypes")
    ops = cs._ssd_operands(torch, shape, dtypes, gen)
    _, _, states = sk.ssd_scan_fused_plain(*ops, return_states=True)
    dy = torch.randn(ops[3].shape, generator=gen, device="cuda")
    dsf = torch.randn(ops[6].shape, generator=gen, device="cuda")

    def bwd():
        return sk.ssd_scan_bwd(*ops[:6], states, dy, dsf)

    route = _route(getattr(sk, "SSD_BWD_ROUTES", None), bwd, torch)
    return {label: dict(device_ms=cs.graph_ms(torch, bwd, iters=5),
                        ms=cs.time_ms(torch, bwd, 10), route=route)}


def grouped_bwd(torch, cs, gen):
    from repro_torch.core import GroupedGemmDescriptor, plan_grouped
    from repro_torch.kernels.grouped_gemm import kernel as grk
    torch.backends.cuda.matmul.allow_tf32 = False

    out = {}
    for case in cs.grouped_cases():
        label, sizes, extra, k, n, epi = case[:6]
        if label not in ("prefill_gate_silu", "prefill_down"):
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

        route = _route(getattr(grk, "BWD_ROUTES", None), bwd, torch)
        out[label] = dict(device_ms=cs.graph_ms(torch, bwd, iters=3),
                          ms=cs.time_ms(torch, bwd, 5), route=route,
                          bm=plan.bm)
        del x, w, dy
        torch.cuda.empty_cache()
    return out


def transpose(torch, cs, gen):
    from repro_torch.core import TransposeDescriptor, plan_transpose
    from repro_torch.kernels.transpose import kernel as tk

    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    routes = getattr(tk, "TRANSPOSE_ROUTES", None)
    choose = getattr(tk, "choose_route", None)
    out = {}
    for label, shape, dname, pad, main_path in cs.transpose_cases():
        if not main_path:
            continue
        x = cs._transpose_source(torch, shape, dname, pad, gen)
        nb, rows, cols = shape
        bt = plan_transpose(TransposeDescriptor(rows=rows, cols=cols,
                                                dtype=dname, batch=nb)).bt

        def call(x=x, bt=bt):
            return tk.transpose_tiles(x, bt=bt)

        def host_us(fn, n=200, reps=5):
            # Host microseconds a call, the least of `reps` runs of `n`
            # calls (the host's noise only adds): the launches keep ahead
            # of the card.
            best = float("inf")
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                best = min(best, time.perf_counter() - t0)
            torch.cuda.synchronize()
            return best / n * 1e6

        def library(x=x):
            return x.transpose(-2, -1).contiguous()

        # The planned route, then route B on the same view where the tree
        # has routes.
        for suffix in ("", ":route=B")[:1 if choose is None else 2]:
            if suffix:
                tk.choose_route = lambda *a: "B"
            route = _route(routes, call, torch)
            out[label + suffix] = dict(
                device_ms=cs.graph_ms(torch, call),
                cold_ms=cs.graph_ms(torch, call, flush=flush),
                ms=cs.time_ms(torch, call, 20), route=route, tile=bt,
                **({"host_us": host_us(call)} if rows * cols < 1 << 20
                   else {}))
            tk.choose_route = choose
        for other in tk.TILE_EDGES:
            if other != bt:
                out[f"{label}:bt={other}"] = dict(device_ms=cs.graph_ms(
                    torch, lambda x=x, other=other: tk.transpose_tiles(
                        x, bt=other)))
        out[label + ":library"] = dict(
            device_ms=cs.graph_ms(torch, library),
            cold_ms=cs.graph_ms(torch, library, flush=flush),
            ms=cs.time_ms(torch, library, 20))
        # The card's copy rate on the same bytes: a yardstick, not a bound.
        out[label + ":copy"] = dict(device_ms=cs.graph_ms(torch, x.clone))
        del x
        torch.cuda.empty_cache()
    return out


def gemm_act_bwd(torch, cs, gen):
    from repro_torch.core import GemmDescriptor, plan_gemm
    from repro_torch.kernels.epilogue import apply_epilogue
    from repro_torch.kernels.gemm import kernel as gk
    mm = importlib.import_module("repro_torch.core.matmul")

    m, n, k, epi = 32768, 8192, 3072, "silu"
    a = torch.randn((1, m, k), generator=gen, device="cuda").bfloat16()
    b = (torch.randn((1, k, n), generator=gen, device="cuda")
         * k ** -0.5).bfloat16()
    dy = torch.randn((1, m, n), generator=gen, device="cuda").bfloat16()
    plan = plan_gemm(GemmDescriptor(m=m, n=n, k=k, in_dtype="bfloat16",
                                    out_dtype="bfloat16", epilogue=epi))
    exe = gk.FusedGemm(plan.tile_schedule(), "cuda")

    def plain():
        pre = mm._product32(a, b, "nn").requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(apply_epilogue(pre, epi), pre,
                                       dy.float())[0]

    calls = {
        "forward": lambda: gk.gemm_fused(exe, a, b, epilogue=epi,
                                         out_dtype=torch.bfloat16),
        "plain": plain,
        "plain_product": lambda: mm._product32(a, b, "nn"),
        "cublas_bf16": lambda: torch.matmul(a, b)}
    if hasattr(gk, "gemm_act_bwd"):
        calls["fused"] = lambda: gk.gemm_act_bwd(
            exe, a, b, dy, epilogue=epi, out_dtype=torch.bfloat16)
    out = {}
    for name, call in calls.items():
        route = _route(gk.ROUTES, call, torch) \
            if name in ("forward", "fused") else None
        out[name] = dict(ms=cs.time_ms(torch, call, 5), route=route)
        torch.cuda.empty_cache()
    return out


KERNELS = {"decode": decode, "ssd_fwd": ssd_fwd, "ssd_bwd": ssd_bwd,
           "grouped_bwd": grouped_bwd, "transpose": transpose,
           "gemm_act_bwd": gemm_act_bwd}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--src", required=True,
                    help="the src/ directory whose repro_torch is timed")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = KERNELS[args.kernel](torch, cs, gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "src": args.src, "kernel": args.kernel,
                      **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
