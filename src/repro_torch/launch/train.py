"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains ``reduced_config`` of the architecture (``--reduced`` is on by
default and cannot be turned off, as in the reference's CLI) on the card
unless ``--device cpu`` is given, through the checkpoint / restart
supervisor of ``repro_torch.runtime.train_loop``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --device cpu --steps 3
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import configure, resolve_device
from repro_torch.data import SyntheticLMDataset
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.runtime.steps import make_train_step, model_for
from repro_torch.runtime.train_loop import TrainLoopConfig, run_with_restarts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--scale", type=int, default=1,
                    help="multiplier on the reduced config width/depth")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--backend", choices=("torch", "engine"), default=None,
                    help="engine runs the kernel families (and the flash "
                         "backward kernel); default keeps the process config")
    ap.add_argument("--fused", choices=("auto", "on", "off"), default=None,
                    help="fused-lowering policy for engine dispatches, "
                         "forward and backward")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    configure(backend=args.backend, fused=args.fused, device=args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(
            cfg, d_model=64 * args.scale, d_ff=128 * args.scale,
            num_layers=max(2, 2 * len(cfg.block_pattern)) * args.scale)
    opt = adamw(warmup_cosine(args.lr, args.steps // 10, args.steps))

    def make_state():
        # Fresh on every (re)start: the step updates both in place.
        model = model_for(cfg)(cfg, seed=0)
        return model, opt.init(dict(model.named_parameters()))

    model, _ = make_state()
    print(f"arch={cfg.name} device={model.device} "
          f"params={sum(p.numel() for p in model.parameters()):,}")
    del model

    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches)
    ds = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch)

    dev = resolve_device()

    def batch_fn(step):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in ds.host_batch(step).items()}

    loop = TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                           save_every=args.save_every)

    def log(step, m):
        print(f"step {step:5d} loss={m['loss']:.4f} nll={m['nll']:.4f} "
              f"gnorm={m['grad_norm']:.2f} dt={m['step_seconds']*1e3:.0f}ms")

    out = run_with_restarts(make_state, step_fn, batch_fn, loop, log_fn=log)
    if out["metrics"]:
        first, last = out["metrics"][0]["nll"], out["metrics"][-1]["nll"]
        print(f"nll: {first:.3f} -> {last:.3f} (structure floor "
              f"~{ds.unigram_floor_nats():.3f}, uniform "
              f"{math.log(cfg.vocab_size):.3f}); "
              f"stragglers={out['stragglers']} restarts={out['restarts']}")
    for fam, s in sorted(out["engine_stats"].items()):
        if s["launches"] or s["launches_bwd"]:
            print(f"engine[{fam}]: launches={s['launches']} "
                  f"launches_bwd={s['launches_bwd']} "
                  f"plan_hits={s['plan_hits']} "
                  f"plan_hits_bwd={s['plan_hits_bwd']}")


if __name__ == "__main__":
    main()
