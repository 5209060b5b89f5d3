"""Serving driver: batched prefill, then greedy decode with a dense KV
cache (the static path).

    python -m repro_torch.launch.serve --arch qwen3-0.6b --batch 8 \\
        --prompt-len 64 --gen 32 [--backend torch|engine] [--device cpu]

Runs ``reduced_config`` of the architecture, like the reference's CLI, on
the card unless ``--device cpu`` is given.  Continuous batching is not
ported yet.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced_config
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--backend", choices=["torch", "engine"], default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.core import configure
    configure(backend=args.backend, device=args.device)
    cfg = reduced_config(get_config(args.arch))
    model = model_for(cfg)(cfg, seed=args.seed)
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
