#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and exits non-zero):

  1. device  -- the card's name, the device count and nvidia-smi's name and
                power limit; no CUDA device is a failure;
  2. build   -- nvcc builds every kernel source in the checkout;
  3. kernels -- each of the six kernels against its plain torch version on
                the card, at full-width Qwen3-0.6B main-path shapes (serving:
                batch 4, prompt 256; training: batch 8, sequence 128;
                continuous decode: 8 slots over a paged pool) and ragged
                cases, with errors, kernel / plain / library times (CUDA
                events) and the bound; the flash forward also in its LSE
                form, the flash backward, and the paged decode;
  4. serve   -- full-width Qwen3-0.6B (seeded random weights) through
                ``generate`` on the engine backend, fused="auto": batch 4,
                prompt 256, 16 new tokens; launch counts must equal what
                the model's structure implies; prefill logits against the
                torch backend;
  5. serve_off -- the same prefill plus decode steps under fused="off",
                which runs the region GEMM and the dense-grid flash kernel;
  6. profile -- torch.profiler over two full-width decode steps: wall time
                against device time, and the kernels that take it;
     continuous -- full-width Qwen3-0.6B through ``run_continuous``: a
                Poisson trace of 12 requests (prompts 96-256, 16-48 new
                tokens) over 8 slots and a 96-page pool of 16-token pages,
                which forces evictions; every request finishes, the pool's
                invariants hold, one flash_decode launch per layer per
                decode step, GEMM and flash launches as the prefills and
                steps imply (the engine's run counted alone); then, outside
                the count, the static-path oracle, one decode step's
                logits against the static dense path's, and a profile of
                two decode steps;
     reduced -- reduced_config(qwen3-0.6b) in fp32: engine and torch give
                identical greedy tokens, and a continuous run with an
                eviction gives the static path's tokens;
  7. train   -- full-width Qwen3-0.6B training (seeded random fp32 masters,
                bf16 compute; batch 8, sequence 128, AdamW with warmup_cosine,
                the synthetic bigram stream): loss and gradients of one batch
                under the engine and the torch backends, within stated
                bounds; 4 steps through run_with_restarts with checkpoints
                every 2 steps and no restart allowed, finite losses and
                exact launch counts per step; the step-2 checkpoint restored and stepped again, equal
                to the run's steps 3 and 4 within stated tolerances; a
                profile of one more step;
  8. the ``kernels`` line, then the card's nvidia-smi line, then
  9. the last line: {"ok": true, "device": {...}}.

Imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

BATCH, PROMPT, GEN = 4, 256, 16
TOL = {"bfloat16": 2e-2, "float32": 1e-4}   # atol = rtol, kernel vs plain
# Flash backward vs its plain version (atol = rtol): both compute in fp32
# from the same inputs, but in another summation order, and the kernel's
# atomic dQ adds in an order that changes from run to run.
BWD_TOL = 1e-3
# The forward's LSE rows vs the plain version's (fp32 on both sides).
LSE_TOL = 1e-4
# Prefill last-position logits, engine vs torch backend (both bf16): the
# largest difference may be at most this fraction of the logits' range.
LOGIT_BOUND = 0.05
PEAK = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM data sheet, dense
HBM_BPS = 3.35e12

# Training: the reference CLI's defaults (batch 8, sequence 128, peak lr
# 3e-3 with warmup_cosine over the run), 4 steps, a checkpoint every 2.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR, SAVE_EVERY = 8, 128, 4, 3e-3, 2
# Engine vs torch backend on one batch (both bf16 compute from the same
# fp32 masters; the GEMM and attention kernels round in other places than
# cuBLAS and the chunked softmax): the loss may differ by this fraction of
# itself, the whole gradient by this fraction of its L2 norm.
LOSS_BOUND, GRAD_BOUND = 0.01, 0.05
# Resume from the step-2 checkpoint against the uninterrupted run.  Step 2's
# loss comes from restored weights through a deterministic forward: equal
# to 1e-6.  Its grad_norm, and step 3's loss, pass through the atomic dQ
# adds, whose order changes from run to run: 1e-3.  The parameters after
# step 4 likewise: relative L2 gap 1e-3 (Adam moves an element by at most
# about 2 lr when a near-zero gradient flips sign).
RESUME_EXACT, RESUME_TOL = 1e-6, 1e-3

# Continuous batching at full width: 8 slots over 96 pages of 16 positions
# (at most 24 pages, 384 positions, a sequence), and a Poisson trace that
# overflows the pool, so that growth evicts.
CONT_SLOTS, CONT_PAGES, CONT_PAGE, CONT_BLOCKS = 8, 96, 16, 24
CONT_TRACE = dict(num_requests=12, rate=1.0, prompt_len=(96, 256),
                  max_new=(16, 48), seed=0)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False  # plain fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit(phase="device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    from repro_torch.kernels import _build
    _build.build_all()
    emit(phase="build", seconds=_build.last_build_seconds,
         sources=sorted(_build.sources()))

    results = phase_kernels(torch)
    counts_on, model, prompts, logits = phase_serve(torch)
    counts_off = phase_serve_off(torch, model, prompts, logits)
    phase_profile(torch, model, prompts)
    counts_cont = phase_continuous(torch, model)
    del model, logits  # free the serving model before training
    phase_reduced(torch)
    torch.cuda.empty_cache()
    counts_train = phase_train(torch)

    by_path = {"serve": counts_on, "serve_off": counts_off,
               "continuous": counts_cont, "train": counts_train}
    kernels = []
    for kname, meta in KERNELS.items():
        paths = {p: c[kname] for p, c in by_path.items() if c.get(kname)}
        if not paths:
            fail(f"{kname} was never launched on the main path")
        rows = [r for r in results if r["kernel"] == kname and r["main_path"]]
        # The cases run one after another: the least time for all of them
        # is the sum of each case's own bound.
        by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        by_ops = sum(r["bound_ms"] for r in rows
                     if r["bound_by"] == "operations")
        lib = [r["library_ms"] for r in rows]
        kernels.append({
            "name": kname, "route": "cuda", "source": meta[0],
            "replaces": meta[1], "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": by_bytes + by_ops,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None if None in lib else sum(lib),
            "cases": len(rows)})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


KERNELS = {
    "gemm_fused": ("src/repro_torch/kernels/gemm/csrc/gemm.cu",
                   "src/repro/kernels/gemm/kernel.py:266"),
    "gemm_region": ("src/repro_torch/kernels/gemm/csrc/gemm.cu",
                    "src/repro/kernels/gemm/kernel.py:96"),
    "flash_fwd_fused": ("src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
                        "src/repro/kernels/flash_attention/kernel.py:204"),
    "flash_fwd_dense": ("src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
                        "src/repro/kernels/flash_attention/kernel.py:115"),
    "flash_bwd_fused": ("src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu",
                        "src/repro/kernels/flash_attention/kernel.py:500"),
    "flash_decode": ("src/repro_torch/kernels/flash_attention/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_attention/kernel.py:358"),
}


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events, after
    two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(torch, out, ref, dtype_name):
    diff = (out.float() - ref.float()).abs()
    tol = TOL[dtype_name]
    bad = diff > tol + tol * ref.float().abs()
    if not torch.isfinite(out.float()).all():
        fail("kernel output is not finite")
    max_abs = diff.max().item()
    return max_abs, max_abs / max(ref.float().abs().max().item(), 1e-30), \
        int(bad.sum().item()), tol


def gemm_cases():
    """(label, m, n, k, layout, epilogue, dtype, accumulate, batch, main)."""
    d, q, kv, ff, vocab = 1024, 2048, 1024, 3072, 151936
    cases = []
    for stage, m in (("prefill", BATCH * PROMPT), ("decode", BATCH)):
        cases += [(f"{stage}_q", m, q, d, "nn", None),
                  (f"{stage}_kv", m, kv, d, "nn", None),
                  (f"{stage}_o", m, d, q, "nn", None),
                  (f"{stage}_gate_silu", m, ff, d, "nn", "silu"),
                  (f"{stage}_up", m, ff, d, "nn", None),
                  (f"{stage}_down", m, d, ff, "nn", None)]
    cases.append(("readout_nt", BATCH, vocab, d, "nt", None))
    # Training runs the prefill shapes (8 x 128 = 1024 tokens) and the
    # read-out over every position.
    cases.append(("train_readout_nt", TRAIN_BATCH * TRAIN_SEQ, vocab, d,
                  "nt", None))
    cases = [c + ("bfloat16", False, 0, True) for c in cases]
    cases += [
        ("ragged_bias_gelu_acc_nt", 997, 1003, 1001, "nt", "bias_gelu",
         "bfloat16", True, 0, False),
        ("ragged_f32_relu_acc", 300, 500, 129, "nn", "relu", "float32", True,
         0, False),
        ("ragged_f32_batched_bias_silu_nt", 77, 200, 50, "nt", "bias_silu",
         "float32", False, 3, False),
        ("decode_f32_gate_silu", 4, 1024, 1024, "nn", "silu", "float32",
         False, 0, False),
    ]
    return cases


def run_gemm_case(torch, case, gen):
    import torch.nn.functional as F
    from repro_torch.core import GemmDescriptor, plan_gemm
    from repro_torch.kernels.gemm.kernel import (FusedGemm, gemm_fused,
                                                 gemm_fused_plain, gemm_region,
                                                 gemm_region_plain)
    label, m, n, k, layout, epi, dname, acc, nb, main_path = case
    dt = getattr(torch, dname)
    nbx = max(1, nb)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)

    a = rnd(nbx, m, k)
    b = rnd(nbx, k, n, scale=k ** -0.5) if layout == "nn" else \
        rnd(nbx, n, k, scale=k ** -0.5)
    bias = rnd(n) if epi and epi.startswith("bias") else None
    c = rnd(nbx, m, n) if acc else None
    desc = GemmDescriptor(m=m, n=n, k=k, layout=layout, in_dtype=dname,
                          out_dtype=dname, epilogue=epi, accumulate=acc,
                          batch=nb)
    plan = plan_gemm(desc)
    exe = FusedGemm(plan.tile_schedule(), "cuda")
    kw = dict(layout=layout, epilogue=epi, bias=bias, c=c)

    def fused():
        return gemm_fused(exe, a, b, out_dtype=dt, **kw)

    def fused_plain():
        return gemm_fused_plain(exe.schedule, a, b, out_dtype=dt, **kw)

    out_r = torch.empty((nbx, m, n), dtype=dt, device="cuda")
    out_rp = torch.empty_like(out_r)

    def region():
        for r in plan.regions:
            gemm_region(a, b, out_r, r, **kw)

    def region_plain():
        for r in plan.regions:
            gemm_region_plain(a, b, out_rp, r, **kw)

    def library():
        bt = b if layout == "nn" else b.transpose(1, 2)
        y = torch.matmul(a, bt)
        if c is not None:
            y = y + c
        if bias is not None:
            y = y + bias
        if epi in ("gelu", "bias_gelu"):
            y = F.gelu(y, approximate="tanh")
        elif epi in ("silu", "bias_silu"):
            y = F.silu(y)
        elif epi == "relu":
            y = F.relu(y)
        return y

    isz = 2 if dname == "bfloat16" else 4
    nbytes = isz * (nbx * (m * k + k * n + m * n * (2 if acc else 1))
                    + (n if bias is not None else 0))
    op_ms = 2 * nbx * m * n * k / PEAK[dname] * 1e3
    byte_ms = nbytes / HBM_BPS * 1e3
    lib_ms = time_ms(torch, library, 20)
    rows = []
    for kname, kern, plain, out_k, out_p in (
            ("gemm_fused", fused, fused_plain, None, None),
            ("gemm_region", region, region_plain, out_r, out_rp)):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if out_k is not None:
            got, want = out_k, out_p
        max_abs, rel, nbad, tol = compare(torch, got, want, dname)
        row = dict(phase="kernel", kernel=kname, case=label, main_path=main_path,
                   shape=[nb, m, n, k], layout=layout, epilogue=epi,
                   dtype=dname, accumulate=acc,
                   blocks=[[r.bm, r.bn] for r in plan.regions],
                   max_abs_err=max_abs, max_rel_err=rel, tolerance=tol,
                   mismatches=nbad,
                   ms=time_ms(torch, kern, 20),
                   plain_ms=time_ms(torch, plain, 2),
                   library_ms=lib_ms, op_ms=op_ms, byte_ms=byte_ms,
                   bound_ms=max(op_ms, byte_ms),
                   bound_by="bytes" if byte_ms >= op_ms else "operations")
        emit(**row)
        if nbad:
            fail(f"{kname} {label}: {nbad} elements outside atol=rtol={tol}")
        rows.append(row)
    return rows


def flash_cases():
    """(label, bh, sq, sk, d, causal, dtype, main)."""
    return [("prefill_causal", BATCH * 16, PROMPT, PROMPT, 128, True,
             "bfloat16", True),
            ("ragged_causal_100", 8, 100, 100, 128, True, "bfloat16", False),
            ("ragged_noncausal_130x70", 6, 130, 70, 64, False, "float32",
             False),
            ("f32_causal_d16", 8, 100, 100, 16, True, "float32", False)]


def run_flash_case(torch, case, gen):
    import torch.nn.functional as F
    from repro_torch.core import FlashDescriptor, plan_flash
    from repro_torch.kernels.flash_attention.kernel import (
        FusedFlash, flash_fwd_dense, flash_fwd_dense_plain, flash_fwd_fused,
        flash_fwd_fused_plain)
    label, bh, sq, sk, d, causal, dname, main_path = case
    dt = getattr(torch, dname)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda").to(dt)
               for s in (sq, sk, sk))
    desc = FlashDescriptor(batch_heads=bh, sq=sq, sk=sk, d=d, causal=causal,
                           dtype=dname)
    plan = plan_flash(desc)
    exe = FusedFlash(plan.tile_schedule(), "cuda")
    bq, bk = min(plan.block_q, sq), min(plan.block_k, sk)

    def library():
        return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                              is_causal=causal)

    op_ms = desc.flops / PEAK[dname] * 1e3
    byte_ms = (desc.in_bytes + desc.out_bytes) / HBM_BPS * 1e3
    lib_ms = time_ms(torch, library, 20)
    rows = []
    for kname, kern, plain in (
            ("flash_fwd_fused", lambda: flash_fwd_fused(exe, q, k, v),
             lambda: flash_fwd_fused_plain(exe.schedule, q, k, v)),
            ("flash_fwd_dense",
             lambda: flash_fwd_dense(q, k, v, block_q=bq, block_k=bk,
                                     causal=causal),
             lambda: flash_fwd_dense_plain(q, k, v, block_q=bq, block_k=bk,
                                           causal=causal))):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        max_abs, rel, nbad, tol = compare(torch, got, want, dname)
        row = dict(phase="kernel", kernel=kname, case=label, main_path=main_path,
                   shape=[bh, sq, sk, d], causal=causal, dtype=dname,
                   blocks=[bq, bk], max_abs_err=max_abs, max_rel_err=rel,
                   tolerance=tol, mismatches=nbad,
                   ms=time_ms(torch, kern, 20),
                   plain_ms=time_ms(torch, plain, 2),
                   library_ms=lib_ms, op_ms=op_ms, byte_ms=byte_ms,
                   bound_ms=max(op_ms, byte_ms),
                   bound_by="bytes" if byte_ms >= op_ms else "operations")
        emit(**row)
        if nbad:
            fail(f"{kname} {label}: {nbad} elements outside atol=rtol={tol}")
        rows.append(row)
    return rows


def flash_bwd_cases():
    """(label, bh, sq, sk, d, causal, dtype, main): the training shape
    (batch 8 x 16 heads, sequence 128) and ragged fp32 cases."""
    return [("train_causal", TRAIN_BATCH * 16, TRAIN_SEQ, TRAIN_SEQ, 128,
             True, "bfloat16", True),
            ("ragged_f32_causal_100x130", 6, 100, 130, 64, True, "float32",
             False),
            ("ragged_f32_noncausal_130x70", 6, 130, 70, 96, False, "float32",
             False)]


def run_flash_bwd_case(torch, case, gen):
    """The LSE form of flash_fwd_fused and flash_bwd_fused against their
    plain versions, with SDPA's forward / backward as the library."""
    import torch.nn.functional as F
    from repro_torch.core import (FlashBwdDescriptor, FlashDescriptor,
                                  plan_flash_bwd)
    from repro_torch.kernels.flash_attention.kernel import (
        FusedFlash, flash_bwd_fused, flash_bwd_fused_plain, flash_fwd_fused,
        flash_fwd_fused_plain)
    label, bh, sq, sk, d, causal, dname, main_path = case
    dt = getattr(torch, dname)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda").to(dt)
               for s in (sq, sk, sk))
    do = torch.randn((bh, sq, d), generator=gen, device="cuda").to(dt)
    desc = FlashDescriptor(batch_heads=bh, sq=sq, sk=sk, d=d, causal=causal,
                           dtype=dname)
    bdesc = FlashBwdDescriptor.from_forward(desc)
    plan = plan_flash_bwd(bdesc)
    exe = FusedFlash(plan.tile_schedule(), "cuda")
    rows = []

    def row(kname, errs, tol, ms, plain_ms, lib_ms, nbytes, flops):
        op_ms = flops / PEAK[dname] * 1e3
        byte_ms = nbytes / HBM_BPS * 1e3
        r = dict(phase="kernel", kernel=kname, case=label,
                 main_path=main_path, shape=[bh, sq, sk, d], causal=causal,
                 dtype=dname, blocks=[exe.schedule.bq, exe.schedule.bk],
                 max_abs_err=max(e[0] for e in errs.values()),
                 errors={n: e[0] for n, e in errs.items()},
                 max_rel_err=max(e[1] for e in errs.values()), tolerance=tol,
                 mismatches=sum(e[2] for e in errs.values()), ms=ms,
                 plain_ms=plain_ms, library_ms=lib_ms, op_ms=op_ms,
                 byte_ms=byte_ms, bound_ms=max(op_ms, byte_ms),
                 bound_by="bytes" if byte_ms >= op_ms else "operations")
        emit(**r)
        if r["mismatches"]:
            fail(f"{kname} {label}: {r['mismatches']} elements outside "
                 f"atol=rtol={tol}")
        rows.append(r)

    def errors(got, want, tol):
        diff = (got.float() - want.float()).abs()
        if not torch.isfinite(got.float()).all():
            fail(f"{label}: kernel output is not finite")
        bad = int((diff > tol + tol * want.float().abs()).sum().item())
        return (diff.max().item(),
                diff.max().item() / max(want.float().abs().max().item(), 1e-30),
                bad)

    # Forward with the LSE rows.
    o, lse = flash_fwd_fused(exe, q, k, v, return_lse=True)
    o_p, lse_p = flash_fwd_fused_plain(exe.schedule, q, k, v, return_lse=True)
    torch.cuda.synchronize()
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q[None], k[None], v[None], is_causal=causal), 20)
    row("flash_fwd_fused", {"o": errors(o, o_p, TOL[dname]),
                            "lse": errors(lse, lse_p, LSE_TOL)},
        {"o": TOL[dname], "lse": LSE_TOL},
        time_ms(torch, lambda: flash_fwd_fused(exe, q, k, v, return_lse=True),
                20),
        time_ms(torch, lambda: flash_fwd_fused_plain(
            exe.schedule, q, k, v, return_lse=True), 2),
        lib_fwd, desc.in_bytes + desc.out_bytes + bh * sq * 4, desc.flops)

    # Backward, on the kernel's own o and lse.
    got = flash_bwd_fused(exe, q, k, v, o, do, lse)
    want = flash_bwd_fused_plain(exe.schedule, q, k, v, o, do, lse)
    torch.cuda.synchronize()
    qs, ks, vs = (t.detach()[None].requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, (qs, ks, vs), do[None], retain_graph=True), 20)
    row("flash_bwd_fused",
        {n: errors(g, w, BWD_TOL) for n, g, w in zip(("dq", "dk", "dv"),
                                                      got, want)},
        BWD_TOL,
        time_ms(torch, lambda: flash_bwd_fused(exe, q, k, v, o, do, lse), 20),
        time_ms(torch, lambda: flash_bwd_fused_plain(exe.schedule, q, k, v,
                                                     o, do, lse), 2),
        lib_bwd, bdesc.in_bytes + bdesc.out_bytes, bdesc.flops)
    return rows


def decode_cases():
    """(label, slot lengths, dtype, main): the continuous phase's pool (8
    slots, 16 query / 8 KV heads of 128, 96 pages of 16, 24 blocks) with
    ragged lengths, one slot empty."""
    return [("serve_ragged", (0, 1, 16, 17, 300, 255, 100, 33), "bfloat16",
             True),
            ("f32_ragged", (0, 1, 15, 16, 47, 64, 5, 200), "float32", False)]


def run_decode_case(torch, case, gen):
    """flash_decode against its plain version over shuffled block tables;
    the library is SDPA on the slots' pages gathered to a contiguous,
    masked K/V (the gather outside the timed region)."""
    import torch.nn.functional as F
    from repro_torch.core import DecodeTileSchedule
    from repro_torch.kernels.flash_attention.kernel import (
        FlashDecode, flash_decode, flash_decode_plain)
    label, lengths, dname, main_path = case
    dt = getattr(torch, dname)
    S, P, B, h, hkv, hd = (CONT_SLOTS, CONT_PAGE, CONT_BLOCKS, 16, 8, 128)
    q = torch.randn((S, h, hd), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((CONT_PAGES, P, hkv, hd), generator=gen,
                        device="cuda").to(dt) for _ in range(2))
    perm = torch.randperm(CONT_PAGES, generator=torch.Generator()
                          .manual_seed(len(label)))
    bt = torch.zeros((S, B), dtype=torch.int32)
    used = 0
    for slot, n in enumerate(-(-L // P) for L in lengths):
        bt[slot, :n] = perm[used:used + n]
        used += n
    bt, lens = bt.cuda(), torch.tensor(lengths, dtype=torch.int32,
                                       device="cuda")
    exe = FlashDecode(DecodeTileSchedule(num_seqs=S, pages=CONT_PAGES,
                                         page_size=P, max_blocks=B), "cuda")
    exe.update(bt, lens)
    got = flash_decode(exe, q, k, v)
    want = flash_decode_plain(exe, q, k, v)
    torch.cuda.synchronize()
    max_abs, rel, nbad, tol = compare(torch, got, want, dname)
    empty = [i for i, L in enumerate(lengths) if L == 0]
    if any(got[i].abs().max().item() != 0 for i in empty):
        fail(f"flash_decode {label}: an empty slot did not drain zeros")
    # Library: SDPA over the gathered pages, heads expanded to h.
    span = torch.arange(B * P, device="cuda")
    gk, gv = (t[bt.long()].reshape(S, B * P, hkv, hd).transpose(1, 2)
              .repeat_interleave(h // hkv, dim=1).contiguous() for t in (k, v))
    mask = (span[None, :] < lens[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(q4, gk, gv, attn_mask=mask)

    # Bytes: the live K/V rows (the kernel never reads rows past a slot's
    # length), q and out, plus the block-table entries and lengths.
    isz = 2 if dname == "bfloat16" else 4
    live_pages = sum(-(-L // P) for L in lengths)
    nbytes = isz * (2 * sum(lengths) * hkv * hd + 2 * S * h * hd) \
        + 4 * (live_pages + S)
    op_ms = 4 * h * hd * sum(lengths) / PEAK[dname] * 1e3
    byte_ms = nbytes / HBM_BPS * 1e3
    row = dict(phase="kernel", kernel="flash_decode", case=label,
               main_path=main_path, shape=[S, h, hkv, hd, P],
               lengths=list(lengths), dtype=dname, max_abs_err=max_abs,
               max_rel_err=rel, tolerance=tol, mismatches=nbad,
               ms=time_ms(torch, lambda: flash_decode(exe, q, k, v), 50),
               plain_ms=time_ms(torch, lambda: flash_decode_plain(
                   exe, q, k, v), 2),
               library_ms=time_ms(torch, library, 50), op_ms=op_ms,
               byte_ms=byte_ms, bound_ms=max(op_ms, byte_ms),
               bound_by="bytes" if byte_ms >= op_ms else "operations")
    emit(**row)
    if nbad:
        fail(f"flash_decode {label}: {nbad} elements outside atol=rtol={tol}")
    return [row]


def phase_kernels(torch):
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for case in gemm_cases():
        rows += run_gemm_case(torch, case, gen)
    for case in flash_cases():
        rows += run_flash_case(torch, case, gen)
    for case in flash_bwd_cases():
        rows += run_flash_bwd_case(torch, case, gen)
    for case in decode_cases():
        rows += run_decode_case(torch, case, gen)
    return rows


# ---------------------------------------------------------------------------
# Phases 4-6: the model through generate
# ---------------------------------------------------------------------------

def _reset_counts():
    from repro_torch.core import engine
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.gemm import kernel as gk
    engine.reset_stats(entries=False)
    gk.reset_launches()
    fk.reset_launches()


def _read_counts():
    from repro_torch.core import engine
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.gemm import kernel as gk
    st = engine.stats()
    return {**gk.LAUNCHES, **fk.LAUNCHES,
            "engine_gemm_launches": st.get("gemm", {}).get("launches", 0),
            "engine_gemm_calls": st.get("gemm", {}).get("plan_hits", 0)
            + st.get("gemm", {}).get("plan_misses", 0),
            "engine_flash_launches": st.get("flash_attention", {})
            .get("launches", 0),
            "engine_flash_launches_bwd": st.get("flash_attention", {})
            .get("launches_bwd", 0),
            "engine_decode_launches": st.get("flash_decode", {})
            .get("launches", 0)}


def _prompts(torch, vocab):
    gen = torch.Generator(device="cuda").manual_seed(1)
    return torch.randint(0, vocab, (BATCH, PROMPT), generator=gen,
                         device="cuda")


def _prefill_logits(torch, model, prompts):
    from repro_torch.runtime.steps import make_prefill_step
    logits, _ = make_prefill_step(model, PROMPT + GEN)({"tokens": prompts})
    torch.cuda.synchronize()
    return logits.float()


def _logit_gap(torch, got, ref):
    if not torch.isfinite(got).all() or not torch.isfinite(ref).all():
        fail("non-finite logits")
    spread = (ref.max() - ref.min()).item()
    gap = (got - ref).abs().max().item()
    return gap, spread, gap / spread


def phase_serve(torch):
    from repro_torch.configs import get_config
    from repro_torch.core import use
    from repro_torch.launch.serve import generate
    from repro_torch.models import LanguageModel
    cfg = get_config("qwen3-0.6b")
    t0 = time.perf_counter()
    model = LanguageModel(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = _prompts(torch, cfg.vocab_size)
    with use(backend="engine", fused="auto", device="cuda"):
        generate(model, prompts, 2)  # warm: plans, tile tables
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        res = generate(model, prompts, GEN)
        counts = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        logits = _prefill_logits(torch, model, prompts)
    toks = res["tokens"]
    if tuple(toks.shape) != (BATCH, GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"bad tokens {tuple(toks.shape)}")
    forwards = GEN  # one prefill + GEN - 1 decode steps
    want_gemm = forwards * (7 * cfg.num_layers + 1)
    want_flash = cfg.num_layers
    if counts["engine_gemm_calls"] != want_gemm:
        fail(f"GEMM calls {counts['engine_gemm_calls']} != {want_gemm}")
    if counts["gemm_fused"] + counts["gemm_region"] != \
            counts["engine_gemm_launches"]:
        fail(f"GEMM kernel launches disagree with the engine: {counts}")
    if counts["gemm_fused"] + counts["gemm_region"] < want_gemm:
        fail(f"projections did not all run the GEMM kernels: {counts}")
    if counts["flash_fwd_fused"] + counts["flash_fwd_dense"] != want_flash \
            or counts["engine_flash_launches"] != want_flash:
        fail(f"prefill attention did not run flash once per layer: {counts}")
    with use(backend="torch", device="cuda"):
        ref = _prefill_logits(torch, model, prompts)
    gap, spread, rel = _logit_gap(torch, logits, ref)
    emit(phase="serve", model=cfg.name, params=cfg.param_count(),
         batch=BATCH, prompt=PROMPT, new_tokens=GEN, fused="auto",
         init_seconds=init_s, prefill_seconds=res["prefill_seconds"],
         prefill_tokens_per_s=BATCH * PROMPT / res["prefill_seconds"],
         decode_seconds=res["decode_seconds"],
         decode_tokens_per_s=BATCH * (GEN - 1) / res["decode_seconds"],
         peak_memory_bytes=peak, launches=counts,
         expected_gemm_calls=want_gemm, expected_flash_calls=want_flash,
         logits_vs_torch_max_abs=gap, logits_spread=spread,
         logits_rel=rel, logits_bound=LOGIT_BOUND)
    if rel > LOGIT_BOUND:
        fail(f"engine vs torch prefill logits differ by {rel:.4f} of their "
             f"range (bound {LOGIT_BOUND})")
    return counts, model, prompts, logits


def phase_serve_off(torch, model, prompts, logits_auto):
    from repro_torch.core import use
    from repro_torch.launch.serve import generate
    cfg = model.cfg
    steps = 4
    with use(backend="engine", fused="off", device="cuda"):
        _reset_counts()
        res = generate(model, prompts, steps)
        counts = _read_counts()
        logits = _prefill_logits(torch, model, prompts)
    want_flash = cfg.num_layers
    if counts["gemm_fused"] or counts["flash_fwd_fused"]:
        fail(f"fused kernels ran under fused='off': {counts}")
    if counts["gemm_region"] != counts["engine_gemm_launches"] or \
            counts["engine_gemm_calls"] != steps * (7 * cfg.num_layers + 1):
        fail(f"region GEMM launches disagree: {counts}")
    if counts["flash_fwd_dense"] != want_flash:
        fail(f"dense flash launches {counts['flash_fwd_dense']} != {want_flash}")
    gap, spread, rel = _logit_gap(torch, logits, logits_auto)
    emit(phase="serve_off", fused="off", new_tokens=steps,
         prefill_seconds=res["prefill_seconds"],
         decode_seconds=res["decode_seconds"], launches=counts,
         logits_vs_auto_max_abs=gap, logits_rel=rel,
         logits_bound=LOGIT_BOUND)
    if rel > LOGIT_BOUND:
        fail(f"fused='off' logits differ from fused='auto' by {rel:.4f}")
    return counts


def _device_profile(torch, fn, steps: int):
    """``fn()`` run ``steps`` times under torch.profiler: wall time against
    device time per step, and the kernels that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []  # device-side events only: the kernels themselves
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3 / steps
    return dict(wall_ms_per_step=wall * 1e3 / steps,
                device_ms_per_step=device_ms if rows else "not measured",
                device_busy_share=device_ms / (wall * 1e3 / steps) if rows
                else "not measured",
                top=[[name[:80], us / 1e3 / steps, n // steps]
                     for us, name, n in rows[:12]])


def phase_profile(torch, model, prompts, steps: int = 2):
    from repro_torch.core import use
    from repro_torch.runtime.steps import make_prefill_step, make_serve_step
    with use(backend="engine", fused="auto", device="cuda"), torch.no_grad():
        logits, cache = make_prefill_step(model, PROMPT + GEN)(
            {"tokens": prompts})
        tok = torch.argmax(logits, -1)[:, None]
        state = {"cache": cache,
                 "pos": torch.tensor(PROMPT, dtype=torch.int32,
                                     device="cuda")}
        serve = make_serve_step(model)

        def step():
            _, state["cache"], state["pos"] = serve(state["cache"], tok,
                                                    state["pos"])

        step()  # warm
        emit(phase="profile", decode_steps=steps,
             **_device_profile(torch, step, steps))


def phase_continuous(torch, model):
    """Full-width continuous batching through ``run_continuous``, counted
    alone, with its gates; then the static-path oracle outside the
    counted window, one decode step's logits against the static dense
    path, and a profile."""
    from repro_torch.core import use
    from repro_torch.launch.serve import run_continuous, static_oracle
    cfg = model.cfg
    L = cfg.num_layers
    with use(backend="engine", fused="auto", device="cuda"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        res = run_continuous(model, num_slots=CONT_SLOTS,
                             num_pages=CONT_PAGES, page_size=CONT_PAGE,
                             max_blocks=CONT_BLOCKS, check=False,
                             **CONT_TRACE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        oracle = static_oracle(model, res["trace"], res["outputs"])
        oracle_s = time.perf_counter() - t0
    m, reqs, pool = res["metrics"], res["trace"], res["pool"]
    steps = m["decode_steps"]
    # One prefill per admission (re-admissions replay their context), one
    # forward per decode step: 7 projections per layer and the LM head
    # each, flash forward once per layer per prefill, flash_decode once
    # per layer per step.
    admissions = len(reqs) + m["evictions"]
    want = {
        "flash_decode": steps * L, "engine_decode_launches": steps * L,
        "engine_gemm_calls": (admissions + steps) * (7 * L + 1),
        "flash_fwd_fused": admissions * L,
        "engine_flash_launches": admissions * L,
    }
    emit(phase="continuous", model=cfg.name, slots=CONT_SLOTS,
         num_pages=CONT_PAGES, page_size=CONT_PAGE, max_blocks=CONT_BLOCKS,
         trace=CONT_TRACE,
         prompt_lens=[len(r.prompt) for r in reqs],
         max_new=[r.max_new for r in reqs],
         tokens_per_s=m["tokens_per_s"], total_tokens=m["total_tokens"],
         p50_token_latency_s=m["p50_token_latency_s"],
         p99_token_latency_s=m["p99_token_latency_s"],
         phase_seconds=m["phase_seconds"], decode_steps=steps,
         evictions=m["evictions"], evicted=res["evictions"],
         run_seconds=m["wall_seconds"], wall_seconds=wall,
         oracle_seconds=oracle_s,
         peak_memory_bytes=peak, flash_decode_launches=
         m["flash_decode_launches"], launches=counts, expected=want,
         identical_requests=oracle["identical_requests"],
         requests=len(reqs))
    for r in reqs:
        out = res["outputs"].get(r.rid)
        if out is None or len(out) != r.max_new or not (
                (out >= 0) & (out < cfg.vocab_size)).all():
            fail(f"request {r.rid} did not finish with {r.max_new} in-vocab "
                 f"tokens: {out}")
    if m["evictions"] < 1:
        fail("the continuous trace evicted nothing")
    pool.check_invariants([0] * CONT_SLOTS)
    if pool.free_pages != CONT_PAGES:
        fail(f"{CONT_PAGES - pool.free_pages} pages still owned at the end")
    if m["flash_decode_launches"] != steps * L:
        fail(f"flash_decode launches {m['flash_decode_launches']} != "
             f"{steps} steps x {L} layers")
    bad = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
    if bad:
        fail(f"continuous launch counts (got, want): {bad}")
    if counts["gemm_fused"] + counts["gemm_region"] != \
            counts["engine_gemm_launches"] or counts["flash_fwd_dense"]:
        fail(f"GEMM / flash kernel launches disagree with the engine: "
             f"{counts}")
    if counts["gemm_fused"] + counts["gemm_region"] < \
            want["engine_gemm_calls"]:
        fail(f"projections did not all run the GEMM kernels: {counts}")
    _continuous_logits(torch, model, reqs)
    return counts


def _continuous_logits(torch, model, reqs):
    """Prefill the first 8 requests into the slots of a paged pool, and
    hold the first decode step's paged logits of every slot against the
    static dense path's on the same context (``generate``'s prefill and
    first dense-cache decode step).  Then profile two paged decode steps
    over the 8 slots."""
    from repro_torch.core import use
    from repro_torch.models.attention import PageSpec
    from repro_torch.runtime.pages import (PagePool, init_serving_cache,
                                           refresh_tables, write_prefill)
    from repro_torch.runtime.steps import (make_paged_serve_step,
                                           make_prefill_step, make_serve_step)
    spec = PageSpec(CONT_SLOTS * CONT_BLOCKS, CONT_PAGE, CONT_BLOCKS)
    with use(backend="engine", fused="auto", device="cuda"), torch.no_grad():
        pool = PagePool(spec, CONT_SLOTS)
        cache = init_serving_cache(model, CONT_SLOTS, spec)
        toks, dense = [], []
        for slot, r in enumerate(reqs[:CONT_SLOTS]):
            L = len(r.prompt)
            prompt = torch.from_numpy(r.prompt).long().cuda()[None]
            logits, dcache = make_prefill_step(model, L + 1)(
                {"tokens": prompt})
            tok = torch.argmax(logits, -1)[:, None]
            step, _, _ = make_serve_step(model)(
                dcache, tok, torch.tensor(L, dtype=torch.int32,
                                          device="cuda"))
            dense.append(step[0].float())
            ids = pool.grow(slot, L)
            _, pcache = make_prefill_step(model, L)({"tokens": prompt})
            write_prefill(cache, pcache, slot=slot, length=L, page_ids=ids,
                          page_size=CONT_PAGE)
            pool.grow(slot, L + 3)  # room for three decode steps
            toks.append(tok[0])
        refresh_tables(cache, pool.tables)
        tokens = torch.stack(toks)
        lengths = torch.tensor([len(r.prompt) for r in reqs[:CONT_SLOTS]],
                               device="cuda")
        active = torch.ones(CONT_SLOTS, dtype=torch.bool, device="cuda")
        paged, _, _ = model.apply(tokens, positions=lengths.to(
            torch.int32)[:, None], cache=cache)
        gaps = [_logit_gap(torch, paged[slot, -1].float(), dense[slot])[2]
                for slot in range(CONT_SLOTS)]
        emit(phase="continuous_logits", slots=CONT_SLOTS, rel_gaps=gaps,
             bound=LOGIT_BOUND)
        if max(gaps) > LOGIT_BOUND:
            fail(f"paged vs dense decode logits differ by {max(gaps):.4f} "
                 f"of their range (bound {LOGIT_BOUND})")
        step_fn = make_paged_serve_step(model)
        state = {"tokens": torch.argmax(paged[:, -1], -1)[:, None],
                 "lengths": lengths + 1}

        def step():
            state["tokens"], _, state["lengths"] = step_fn(
                cache, state["tokens"], state["lengths"], active)

        emit(phase="continuous_profile", decode_steps=2,
             active_slots=CONT_SLOTS, **_device_profile(torch, step, 2))


def phase_reduced(torch):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core import use
    from repro_torch.launch.serve import generate
    from repro_torch.models import LanguageModel
    cfg = reduced_config(get_config("qwen3-0.6b"))
    model = LanguageModel(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                            device="cuda")
    toks = {}
    for be in ("engine", "torch"):
        with use(backend=be, device="cuda"):
            toks[be] = generate(model, prompts, 8)["tokens"]
    same = bool(torch.equal(toks["engine"], toks["torch"]))
    emit(phase="reduced", model=cfg.name, dtype=cfg.dtype,
         tokens_identical=same, tokens=toks["engine"].tolist())
    if not same:
        fail("reduced fp32 engine and torch tokens differ")
    # Continuous batching in fp32 with an eviction (tests/test_serving.py's
    # evict/re-admit case): the paged fp32 decode kernel's tokens must be
    # the static path's.
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.serve import run_continuous
    n0 = fk.LAUNCHES["flash_decode"]
    with use(backend="engine", device="cuda"):
        res = run_continuous(model, num_slots=3, num_pages=9, page_size=4,
                             max_blocks=8, num_requests=4, rate=2.0,
                             prompt_len=10, max_new=8, seed=1)
    m = res["metrics"]
    emit(phase="reduced_continuous", model=cfg.name, dtype=cfg.dtype,
         evictions=m["evictions"], decode_steps=m["decode_steps"],
         flash_decode_kernel_launches=fk.LAUNCHES["flash_decode"] - n0,
         token_identical=res["token_identical"])
    if not (res["token_identical"] and m["evictions"] > 0
            and fk.LAUNCHES["flash_decode"] - n0
            == m["decode_steps"] * cfg.num_layers):
        fail("reduced fp32 continuous run: tokens differ from the static "
             "path, no eviction, or the decode kernel did not run")


# ---------------------------------------------------------------------------
# Phase 7: training at full width
# ---------------------------------------------------------------------------

def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _train_parts(torch, cfg):
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import LanguageModel
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.runtime.steps import make_train_step
    ds = SyntheticLMDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    opt = adamw(warmup_cosine(TRAIN_LR, TRAIN_STEPS // 10, TRAIN_STEPS))

    def make_state():
        model = LanguageModel(cfg, device="cuda", seed=0)
        return model, opt.init(dict(model.named_parameters()))

    def batch_fn(step):
        return {k: torch.from_numpy(v).to("cuda")
                for k, v in ds.host_batch(step).items()}

    return make_state, batch_fn, make_train_step(cfg, opt)


def _backend_gap(torch, cfg, make_state, batch_fn):
    """Loss and gradients of one batch under both backends, same weights."""
    from repro_torch.core import use
    from repro_torch.runtime.steps import make_loss_fn
    model, _ = make_state()
    params = [p for _, p in model.named_parameters()]
    batch = batch_fn(0)
    loss, grads = {}, {}
    for be in ("torch", "engine"):
        with use(backend=be, device="cuda"):
            total, _ = make_loss_fn(cfg)(model, batch)
            grads[be] = torch.autograd.grad(total, params)
            loss[be] = total.item()
    diff = sum((a.float() - b.float()).square().sum()
               for a, b in zip(grads["engine"], grads["torch"]))
    norm = sum(b.float().square().sum() for b in grads["torch"])
    grad_gap = (diff / norm).sqrt().item()
    loss_gap = _rel(loss["engine"], loss["torch"])
    emit(phase="train_backends", loss_engine=loss["engine"],
         loss_torch=loss["torch"], loss_rel_gap=loss_gap,
         loss_bound=LOSS_BOUND, grad_rel_l2_gap=grad_gap,
         grad_bound=GRAD_BOUND, grad_norm_torch=norm.sqrt().item())
    if not (loss_gap <= LOSS_BOUND and grad_gap <= GRAD_BOUND):
        fail(f"engine vs torch: loss gap {loss_gap:.4g} (bound {LOSS_BOUND}),"
             f" gradient gap {grad_gap:.4g} (bound {GRAD_BOUND})")


def phase_train(torch):
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core import use
    from repro_torch.runtime.train_loop import (TrainLoopConfig,
                                                run_with_restarts)
    cfg = get_config("qwen3-0.6b")
    make_state, batch_fn, step_fn = _train_parts(torch, cfg)
    with use(backend="engine", fused="auto", device="cuda"):
        _backend_gap(torch, cfg, make_state, batch_fn)
    torch.cuda.empty_cache()

    per_step = []

    def counted_step(model, opt_state, batch, step):
        _reset_counts()
        metrics = step_fn(model, opt_state, batch, step)
        per_step.append(_read_counts())
        return metrics

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # No fault is injected, so a restart could only hide a kernel
        # error: the first exception ends the run.
        loop = TrainLoopConfig(total_steps=TRAIN_STEPS, ckpt_dir=ckpt,
                               save_every=SAVE_EVERY, log_every=1,
                               max_restarts=0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with use(backend="engine", fused="auto", device="cuda"):
            out = run_with_restarts(make_state, counted_step, batch_fn, loop)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        hist = out["metrics"]
        losses = [m["loss"] for m in hist]
        step_s = [m["step_seconds"] for m in hist]
        want = {"gemm_fused": 7 * cfg.num_layers + 1, "gemm_region": 0,
                "flash_fwd_fused": cfg.num_layers, "flash_fwd_dense": 0,
                "flash_bwd_fused": cfg.num_layers,
                "engine_flash_launches": cfg.num_layers,
                "engine_flash_launches_bwd": cfg.num_layers}
        tokens = TRAIN_BATCH * TRAIN_SEQ
        emit(phase="train", model=cfg.name, params=cfg.param_count(),
             batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=len(hist),
             losses=losses, nll=[m["nll"] for m in hist],
             grad_norm=[m["grad_norm"] for m in hist],
             step_seconds=step_s,
             tokens_per_s=[tokens / t for t in step_s],
             run_seconds=run_s, peak_memory_bytes=peak,
             launches_per_step=per_step,
             expected_per_step=want)
        if len(hist) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
            fail(f"training losses not finite over {TRAIN_STEPS} steps: "
                 f"{losses}")
        for i, counts in enumerate(per_step):
            bad = {k: (counts[k], n) for k, n in want.items()
                   if counts[k] != n}
            if bad:
                fail(f"step {i}: launch counts (got, want) {bad}")
        model, opt_state = _resume(torch, cfg, make_state, batch_fn, step_fn,
                                   ckpt, out)
        del out
        with use(backend="engine", fused="auto", device="cuda"):
            batch = batch_fn(TRAIN_STEPS)
            emit(phase="train_profile", steps=1, **_device_profile(
                torch, lambda: step_fn(model, opt_state, batch, TRAIN_STEPS),
                1))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    total = {}
    for counts in per_step:
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    return total


def _resume(torch, cfg, make_state, batch_fn, step_fn, ckpt, out):
    """Restore the step-2 checkpoint into fresh state and take steps 3 and
    4 again; compare with the uninterrupted run."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.core import use
    hist = out["metrics"]
    model, opt_state = make_state()
    restored, meta = restore_checkpoint(
        ckpt, SAVE_EVERY, {"params": dict(model.named_parameters()),
                           "opt_state": opt_state})
    model.load_state_dict(restored["params"])
    opt_state = restored["opt_state"]
    del restored
    again = []
    with use(backend="engine", fused="auto", device="cuda"):
        for step in range(meta["data_step"], TRAIN_STEPS):
            m = step_fn(model, opt_state, batch_fn(step), step)
            again.append({k: float(v) for k, v in m.items()})
    first, second = again[0], again[1]
    diff = sum((a - b).float().square().sum() for a, b in zip(
        model.parameters(), out["model"].parameters()))
    norm = sum(b.float().square().sum() for b in out["model"].parameters())
    param_gap = (diff / norm).sqrt().item()
    # hist[i] is the run's step i (0-based): the restored state steps 2, 3.
    gaps = {"loss[2]": _rel(first["loss"], hist[2]["loss"]),
            "grad_norm[2]": _rel(first["grad_norm"], hist[2]["grad_norm"]),
            "loss[3]": _rel(second["loss"], hist[3]["loss"]),
            "final_params_rel_l2": param_gap}
    bounds = {"loss[2]": RESUME_EXACT, "grad_norm[2]": RESUME_TOL,
              "loss[3]": RESUME_TOL, "final_params_rel_l2": RESUME_TOL}
    emit(phase="train_resume", from_step=meta["data_step"],
         losses=[a["loss"] for a in again], gaps=gaps, bounds=bounds)
    bad = {k: g for k, g in gaps.items() if not g <= bounds[k]}
    if bad:
        fail(f"resume from step {meta['data_step']} differs: {bad}")
    return model, opt_state


if __name__ == "__main__":
    sys.exit(main())
