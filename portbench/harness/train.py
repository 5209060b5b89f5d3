"""The training driver: ``make_train_step``'s step on the port's ``adamw``.

Set-up builds the model and the optimizer state once, runs the first
``warm_steps`` steps through the same call and feed as the window (a fresh
batch every step), and reads what the check compares: each step's loss,
the first step's clipped gradient a leaf (from AdamW's first moment, which
after one step is (1 - b1) times it) and the parameters' change a leaf
after the last of them.  The window then runs whole steps, each ended by a
synchronise, until ``seconds`` have passed; it spans those steps.  A
``--trace 1`` run profiles ``profile_steps`` more steps after the window.
"""
from __future__ import annotations

import gc
import time
from typing import Dict

from harness import port
from harness import weights as W

ADAMW = {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
         "max_grad_norm": 1.0}


def batch(cfg: Dict, traffic: Dict, seed: int, step: int, device):
    """(tokens, labels) of ``step``: ids uniform over the vocabulary."""
    import torch
    gen = torch.Generator(device=device).manual_seed(
        W.leaf_seed(seed, f"batch/{step}"))
    ids = torch.randint(0, cfg["vocab_size"],
                        (traffic["batch"], traffic["seq"] + 1),
                        generator=gen, device=device)
    return ids[:, :-1], ids[:, 1:]


def _check_optimizer_defaults() -> None:
    have = port.adamw_defaults()
    for key, want in ADAMW.items():
        if have[key] != want:
            raise RuntimeError(f"the port's adamw has {key}={have[key]}, "
                               f"the reference {want}")


def change_norms(model, cfg: Dict, seed: int) -> Dict[str, float]:
    import torch
    leaves = {leaf[0]: leaf for leaf in W.all_leaves(cfg)}
    with torch.no_grad():
        return {n: float((p - W.draw(seed, leaves[n], p.device)).norm())
                for n, p in model.named_parameters()}


def _window(cfg, cfg_file, traffic, seed, seconds, trace, device, t_proc,
            tracer):
    import torch
    model_cfg = cfg_file["model"]
    _check_optimizer_defaults()
    model = port.build_model(cfg, cfg_file, seed, device)

    def wrap(update):
        def spanned(*args, **kwargs):
            with tracer.span("optimizer"):
                return update(*args, **kwargs)
        return spanned

    state, step_fn = port.training(cfg, model, traffic["lr"], wrap)

    def run_step(i):
        with tracer.span("batch"):
            tokens, labels = batch(model_cfg, traffic, seed, i, device)
        with tracer.span("train_step"):
            metrics = step_fn(model, state, {"tokens": tokens,
                                             "labels": labels}, i)
        with tracer.span("sync"):
            return float(metrics["loss"])

    prog = {"losses": []}
    for i in range(traffic["warm_steps"]):
        prog["losses"].append(run_step(i))
        if i == 0:
            prog["first_grad"] = {
                n: float(m.norm()) / (1 - ADAMW["b1"])
                for n, m in state["m"].items()}
    prog["change"] = change_norms(model, model_cfg, seed)
    setup_s = time.perf_counter() - t_proc

    i = traffic["warm_steps"]
    ends = []
    t0 = time.perf_counter()
    while not ends or ends[-1] < seconds:
        run_step(i)
        ends.append(time.perf_counter() - t0)
        i += 1
    profile = None
    if trace:
        tracer.start()
        for _ in range(traffic["profile_steps"]):
            run_step(i)
            i += 1
        profile = tracer.stop()
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" \
        else 0
    return {"setup_s": setup_s, "step_ends": ends,
            "tokens_per_step": traffic["batch"] * traffic["seq"],
            "profile": profile, "profile_steps": traffic["profile_steps"],
            "memory_peak_bytes": memory_peak, "attempted": len(ends),
            "program": prog}


def run(cfg_file: Dict, traffic: Dict, seed: int, seconds: float,
        trace: bool, device: str, t_proc: float, tracer) -> Dict:
    import torch

    from harness.check import train_readings
    cfg = port.port_config(cfg_file)
    with port.defaults(device):
        record = _window(cfg, cfg_file, traffic, seed, seconds, trace,
                         device, t_proc, tracer)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    ref, change = reference_run(cfg_file["model"], traffic, seed, device)
    record["reference"] = {"losses": ref["losses"],
                           "first_grad": ref["first_grad"], "change": change}
    del ref
    record["check"] = train_readings(record["program"], record["reference"],
                                     change)
    return record


def reference_run(model_cfg: Dict, traffic: Dict, seed: int, device, *,
                  fp8: bool = False, rows=None):
    """The reference's three steps from the benchmark's weights and batches:
    (its run, its change norms a leaf)."""
    from harness.check import weight_source
    from reference.train import train as ref_train
    names = [leaf[0] for leaf in W.all_leaves(model_cfg)]
    params = weight_source(model_cfg, seed, device)(names)
    out = ref_train(model_cfg, dict(ADAMW, lr=traffic["lr"]), params,
                    lambda s: batch(model_cfg, traffic, seed, s, device),
                    traffic["warm_steps"], fp8=fp8, rows=rows)
    get = weight_source(model_cfg, seed, device)
    change = {n: float((out["params"][n] - get([n])[n]).norm())
              for n in names}
    del out["params"]
    return out, change
