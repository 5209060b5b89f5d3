"""Serving driver, two modes:

  * static batch (default): batched prefill, then greedy decode of the
    whole batch in lock-step with a dense KV cache::

        python -m repro_torch.launch.serve --arch qwen3-0.6b --batch 8 \\
            --prompt-len 64 --gen 32 [--backend torch|engine] [--device cpu]

  * continuous batching (``--continuous``): a Poisson-style request trace
    runs through the paged serving runtime (``repro_torch.runtime.
    batching``), one ``flash_decode`` launch per attention layer per decode
    step while the batch churns, with greedy outputs checked token for
    token against the static path::

        python -m repro_torch.launch.serve --arch qwen3-0.6b --continuous \\
            [--prompt-len 64 --gen 32] [--device cpu]

``--arch`` takes every decoder-only configuration (``list_configs()``) by
either mode: the dense decoders qwen3-0.6b, qwen2.5-3b, phi3-mini-3.8b and
starcoder2-15b, the mixtures of experts phi3.5-moe-42b and grok-1-314b, the
Mamba-2 SSD model mamba2-130m, the hybrid recurrentgemma-9b and
internvl2-1b, served text-only (no image prefix), as the reference serves
it.  The encoder-decoder seamless-m4t-large-v2 is refused with a
``ValueError``: the reference's ``generate`` cannot serve it either (its
prefill has no encoder input).  A mixture of experts promises no
per-sequence token identity in a churning batch (routing and expert
capacity depend on the batch), so its ``token_identical`` is reported, not
required.

Plan resolution and warm start: ``--tuning-cache`` (a writable tuning
cache), ``--tuning-cache-preload`` (a read-only, fleet-merged one) and
``--refit-model`` (a ``tools/tune_torch.py refit`` coefficient model) set
the engine's tiers; ``--warm-start manifest.json`` records the dispatched
descriptors on a first (cold) continuous run and, when the file exists,
replays it through ``ContinuousBatchingEngine.warmup`` before the trace.
Runs ``reduced_config`` of the architecture, like the reference's CLI, on
the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_configs, reduced_config
from repro_torch.core import engine
from repro_torch.runtime.steps import make_prefill_step, make_serve_step, \
    model_for, refuse_encoder_decoder


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, prompts, gen_steps: int, *, capacity=None):
    """Greedy batched generation of a decoder-only model (a vision model
    text-only).  prompts: (b, s) integer ids.

    Returns a dict: ``tokens`` (b, gen_steps), ``prefill_seconds``,
    ``decode_seconds`` (host clock around work that ends in a device
    synchronise) and an ``engine_stats`` snapshot.
    """
    refuse_encoder_decoder(model.cfg, "generation")
    device = model.device
    prompts = prompts.to(device=device, dtype=torch.long)
    b, s = prompts.shape
    capacity = capacity or (s + gen_steps)
    prefill = make_prefill_step(model, capacity)
    serve = make_serve_step(model)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill({"tokens": prompts})
    tok = torch.argmax(logits, -1)[:, None]
    _sync(device)
    t_prefill = time.perf_counter() - t0

    pos = torch.tensor(s, dtype=torch.int32, device=device)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen_steps - 1):
        logits, cache, pos = serve(cache, tok, pos)
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return {
        "tokens": torch.cat(out, dim=1),
        "prefill_seconds": t_prefill,
        "decode_seconds": t_decode,
        "engine_stats": engine.stats(),
    }


def _counts(stats, prefix: str) -> int:
    return sum(v for row in stats.values() for k, v in row.items()
               if k.startswith(prefix))


def run_continuous(model, *, num_slots=4, num_pages=64, page_size=16,
                   max_blocks=8, num_requests=6, rate=0.5, prompt_len=12,
                   max_new=8, seed=0, check=True, warm_start=None):
    """Drive the continuous-batching runtime on a Poisson trace and, with
    ``check``, hold it against the static-batch path.  ``prompt_len``/
    ``max_new`` are ints or (lo, hi) ranges.  Returns the engine's run
    result with the requests (``trace``) and the allocator at the end
    (``pool``) added, and with ``check`` :func:`static_oracle`'s
    ``identical_requests`` and ``token_identical``.

    ``warm_start`` names a descriptor manifest.  When the file exists, the
    engine warms up on it (plans through the tuned tier, kernels built,
    every fresh prompt length prefilled, one all-inactive decode step),
    the counters are reset with every cache kept, and the result gains a
    ``warmup`` summary: the engine's stats at the end of the warmup
    (``engine_stats``) and the serving run's ``post_autotune_timings`` and
    ``post_plan_misses``.  When it does not exist, the run records it
    (``engine.save_manifest``) for the next start."""
    import os

    from repro_torch.models.attention import PageSpec
    from repro_torch.runtime.batching import (ContinuousBatchingEngine,
                                              poisson_trace)
    spec = PageSpec(num_pages, page_size, max_blocks)
    reqs = poisson_trace(num_requests=num_requests, rate=rate,
                         prompt_lens=prompt_len, max_new=max_new,
                         vocab_size=model.cfg.vocab_size, seed=seed)
    serving = ContinuousBatchingEngine(model, num_slots=num_slots, spec=spec)
    warmup = None
    if warm_start and os.path.exists(warm_start):
        warmup = serving.warmup(prompt_lens={len(r.prompt) for r in reqs},
                                manifest=warm_start)
        warmup["engine_stats"] = engine.stats()
        engine.reset_stats(entries=False)
    result = serving.run(reqs)
    if warmup is not None:
        stats = result["engine_stats"]
        warmup["post_autotune_timings"] = _counts(stats, "autotune_timings")
        warmup["post_plan_misses"] = _counts(stats, "plan_misses")
        result["warmup"] = warmup
    elif warm_start:
        engine.save_manifest(warm_start)
    result["trace"] = reqs
    result["pool"] = serving.pool
    if check:
        result.update(static_oracle(model, reqs, result["outputs"]))
    return result


def static_oracle(model, reqs, outputs):
    """Each request decoded alone on the static path must emit the same
    greedy tokens the churning batch produced (``outputs``: rid -> tokens).
    Returns ``identical_requests`` (how many do) and ``token_identical``
    (all of them)."""
    same = 0
    for r in reqs:
        static = generate(model, torch.from_numpy(r.prompt)[None, :],
                          r.max_new)
        same += bool(np.array_equal(static["tokens"][0].cpu().numpy(),
                                    outputs[r.rid]))
    return {"identical_requests": same, "token_identical": same == len(reqs)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching mode over a Poisson trace")
    ap.add_argument("--backend", choices=["torch", "engine"], default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tuning-cache", default=None,
                    help="read/write autotune timing cache (JSON path)")
    ap.add_argument("--tuning-cache-preload", default=None,
                    help="read-only fleet-merged cache (tools/tune.py merge)")
    ap.add_argument("--refit-model", default=None,
                    help="refit-model JSON overlaying fitted cost "
                         "coefficients (tools/tune_torch.py refit)")
    ap.add_argument("--warm-start", default=None,
                    help="descriptor manifest for the warm start; recorded "
                         "on the first (cold) run, replayed on the next")
    args = ap.parse_args(argv)
    refuse_encoder_decoder(get_config(args.arch), "the serve CLI")

    from repro_torch.core import configure, get_config as engine_config
    machine = None
    if args.refit_model:
        from repro_torch.core.machine import load_refit_model
        machine = load_refit_model(args.refit_model,
                                   base=engine_config().machine)
    configure(backend=args.backend, device=args.device, machine=machine,
              tuning_cache=args.tuning_cache,
              tuning_cache_preload=args.tuning_cache_preload)
    cfg = reduced_config(get_config(args.arch))
    model = model_for(cfg)(cfg, seed=args.seed)
    if args.continuous:
        res = run_continuous(model, prompt_len=args.prompt_len // 4 or 8,
                             max_new=args.gen // 4 or 4, seed=args.seed,
                             warm_start=args.warm_start)
        m = res["metrics"]
        print(f"arch={cfg.name} device={model.device} continuous: "
              f"requests={m['requests']} tokens={m['total_tokens']} "
              f"decode_steps={m['decode_steps']} evictions={m['evictions']} "
              f"tok/s={m['tokens_per_s']:.0f} "
              f"p50={m['p50_token_latency_s'] * 1e3:.1f}ms "
              f"p99={m['p99_token_latency_s'] * 1e3:.1f}ms "
              f"token_identical={res['token_identical']}")
        if m["flash_decode_launches"]:
            per_step = m["flash_decode_launches"] / max(m["decode_steps"], 1)
            print(f"engine[flash_decode]: launches="
                  f"{m['flash_decode_launches']} ({per_step:.2f}/decode "
                  f"step)")
        ph = m["phase_seconds"]
        print("phases: " + " ".join(f"{k}={ph[k] * 1e3:.1f}ms"
                                    for k in sorted(ph)))
        w = res.get("warmup")
        if w is not None:
            print(f"warm-start: warmed {sum(w['kernels'].values())} kernels "
                  f"+ {len(w['prefill_lengths'])} prefill lengths in "
                  f"{w['seconds']:.2f}s; serving phase: autotune_timings="
                  f"{w['post_autotune_timings']} plan_misses="
                  f"{w['post_plan_misses']}")
        elif args.warm_start:
            print(f"warm-start: recorded manifest -> {args.warm_start} "
                  f"(next start is warm)")
        return
    gen = torch.Generator(device=model.device).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=model.device)
    res = generate(model, prompts, args.gen)
    ptput = args.batch * args.prompt_len / res["prefill_seconds"]
    dtput = args.batch * (args.gen - 1) / max(res["decode_seconds"], 1e-9)
    print(f"arch={cfg.name} device={model.device} generated "
          f"{tuple(res['tokens'].shape)} prefill={ptput:.0f} tok/s "
          f"decode={dtput:.0f} tok/s")


if __name__ == "__main__":
    main()
