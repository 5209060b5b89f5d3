"""Serving driver, two modes:

  * static batch (default): batched prefill, then greedy decode of the
    whole batch in lock-step with a dense KV cache::

        python -m repro_torch.launch.serve --arch qwen3-0.6b --batch 8 \\
            --prompt-len 64 --gen 32 [--backend torch|engine] [--device cpu]

  * continuous batching (``--continuous``): a Poisson-style request trace
    runs through the paged serving runtime (``repro_torch.runtime.
    batching``), one ``flash_decode`` launch per layer per decode step
    while the batch churns, with greedy outputs checked token for token
    against the static path::

        python -m repro_torch.launch.serve --arch qwen3-0.6b --continuous \\
            [--prompt-len 64 --gen 32] [--device cpu]

``--arch`` takes every registered configuration (``list_configs()``):
the dense decoders qwen3-0.6b, qwen2.5-3b, phi3-mini-3.8b and
starcoder2-15b (LayerNorm, biased linears) by either mode; the mixtures of
experts phi3.5-moe-42b and grok-1-314b and the Mamba-2 SSD model
mamba2-130m by the static path (an SSM's decode state is O(1) per slot);
continuous batching of MoE and SSM models is not ported and raises.

Runs ``reduced_config`` of the architecture, like the reference's CLI, on
the card unless ``--device cpu`` is given.  AOT warm-start
(``--warm-start``) is not ported.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_configs, reduced_config
from repro_torch.core import engine
from repro_torch.runtime.steps import make_prefill_step, make_serve_step, \
    model_for


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, prompts, gen_steps: int, *, capacity=None):
    """Greedy batched generation.  prompts: (b, s) integer ids.

    Returns a dict: ``tokens`` (b, gen_steps), ``prefill_seconds``,
    ``decode_seconds`` (host clock around work that ends in a device
    synchronise) and an ``engine_stats`` snapshot.
    """
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


def run_continuous(model, *, num_slots=4, num_pages=64, page_size=16,
                   max_blocks=8, num_requests=6, rate=0.5, prompt_len=12,
                   max_new=8, seed=0, check=True, warm_start=None):
    """Drive the continuous-batching runtime on a Poisson trace and, with
    ``check``, hold it against the static-batch path.  ``prompt_len``/
    ``max_new`` are ints or (lo, hi) ranges.  Returns the engine's run
    result with the requests (``trace``) and the allocator at the end
    (``pool``) added, and with ``check`` :func:`static_oracle`'s
    ``identical_requests`` and ``token_identical``."""
    from repro_torch.models.attention import PageSpec
    from repro_torch.runtime.batching import (ContinuousBatchingEngine,
                                              poisson_trace)
    if warm_start is not None:
        raise NotImplementedError("AOT warm-start manifests are not ported")
    spec = PageSpec(num_pages, page_size, max_blocks)
    reqs = poisson_trace(num_requests=num_requests, rate=rate,
                         prompt_lens=prompt_len, max_new=max_new,
                         vocab_size=model.cfg.vocab_size, seed=seed)
    serving = ContinuousBatchingEngine(model, num_slots=num_slots, spec=spec)
    result = serving.run(reqs)
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
    args = ap.parse_args(argv)

    from repro_torch.core import configure
    configure(backend=args.backend, device=args.device)
    cfg = reduced_config(get_config(args.arch))
    model = model_for(cfg)(cfg, seed=args.seed)
    if args.continuous:
        res = run_continuous(model, prompt_len=args.prompt_len // 4 or 8,
                             max_new=args.gen // 4 or 4, seed=args.seed)
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
