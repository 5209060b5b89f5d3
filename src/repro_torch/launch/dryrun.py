"""Production-mesh dry-run: per-device bytes and step costs of every cell.

The reference compiles each (architecture x input shape) cell on a forced
512-device XLA mesh, (data 16, model 16) and (pod 2, data 16, model 16),
and records what the compiled module says: ``memory_analysis()`` (does
it fit a chip), ``cost_analysis()`` and the collectives of its HLO.  One
H100 has no counterpart for that compile, so this module records what the
port can compute, on the host, with no card:

  * ``memory.argument_bytes``: the bytes one device holds of the step's
    arguments (parameters, optimizer state, decode cache, batch) under the
    reference's placements (``runtime.sharding``: ``param_pspecs``,
    ``opt_pspecs``, ``cache_pspecs``, ``batch_pspecs``) on a shape-only
    mesh; ``output_bytes`` and ``alias_bytes`` follow the reference's
    donation (a train step donates parameters and optimizer state, a
    decode step its cache);
  * ``cost``: the engine's cost trace (``core.engine.trace_costs``) of one
    step at the cell's global shape on the meta device (no storage, so
    grok-1's 316 B parameters cost nothing): the FLOPs and bytes of every
    kernel descriptor, and the FLOPs of the matrix products outside the
    engine, divided by the mesh's chips -- the ideal partition, which the
    port does not run (under a mesh it replicates everything but the
    expert-parallel GEMM);
  * ``gaps``: what is not computed, and why (temp and peak memory, the
    collectives).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # resumable

Records go to ``experiments/dryrun_torch/`` (``python -m
repro_torch.launch.roofline`` reads them).  :func:`card_check` holds the
byte count and the trace to what the card allocates and runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, Iterable, Optional, Tuple

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")

GAPS = (
    "memory.temp_bytes, memory.peak_per_device: no compiler memory "
    "analysis; the port runs its steps eagerly",
    "collectives, collective_bytes_per_device: no compiled module to walk "
    "(the reference reads its HLO); the step is traced on one device",
    "cost: the global step's counts divided by chips, an ideal partition "
    "the port does not run (under a mesh it replicates all but the "
    "expert-parallel GEMM)",
    "cost.bytes_per_device: engine kernels only; the bytes of torch work "
    "outside the engine are not counted",
    "memory.output_bytes: logits placed by the batch rule, which the "
    "reference leaves to the compiler",
)


class ShapeMesh:
    """A shape-only mesh: axis names and sizes, no devices or process
    group (what ``runtime.shardlib.axis_sizes`` reads)."""

    def __init__(self, **axes: int):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)

    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        return f"ShapeMesh({self.shape})"


def make_shape_mesh(mesh_kind: str) -> ShapeMesh:
    """The reference's production mesh, shape only: (data 16, model 16)
    for ``pod``, (pod 2, data 16, model 16) for ``multipod``."""
    if mesh_kind == "pod":
        return ShapeMesh(data=16, model=16)
    if mesh_kind == "multipod":
        return ShapeMesh(pod=2, data=16, model=16)
    raise ValueError(f"mesh must be 'pod' or 'multipod', got {mesh_kind!r}")


def pick_optimizer(cfg):
    from repro_torch.optim import adamw, scalable_adamw, warmup_cosine
    sched = warmup_cosine(3e-4, 1000, 100000)
    if cfg.param_count() > 100e9:
        # >= 100B: Adafactor (no momentum, factored v), the T5/PaLM
        # recipe; optimizer state is O(sqrt(params)).
        return scalable_adamw(sched, use_momentum=False)
    if cfg.param_count() > 10e9:
        return scalable_adamw(sched)
    return adamw(sched)


def pick_microbatches(cfg, suite) -> int:
    """Gradient-accumulation factor per arch (activation-memory knob),
    the reference's: chosen so peak per-device memory fits 16 GB HBM on
    the single-pod mesh."""
    if suite.kind != "train":
        return 1
    act_cost = cfg.d_model * cfg.num_layers
    if cfg.num_experts:
        act_cost *= 2  # dispatch buffers
    if act_cost > 500_000:   # grok-1 class
        return 4
    if act_cost > 150_000:   # starcoder2 / phi3.5-moe / recurrentgemma class
        return 2
    return 1


def serve_fsdp(cfg, mesh) -> bool:
    """The reference's serving residency rule: bf16 weights stay
    tensor-parallel resident (no FSDP) unless they exceed 8 GiB a device."""
    from repro_torch.runtime.shardlib import axis_size
    return 2.0 * cfg.param_count() / axis_size(mesh, "model") / 2**30 > 8.0


# ---------------------------------------------------------------------------
# per-device bytes
# ---------------------------------------------------------------------------

def spec_bytes(shape, itemsize: int, spec, mesh) -> int:
    """Bytes one device holds of a leaf of ``shape`` placed by ``spec``."""
    from repro_torch.runtime.shardlib import axis_size
    parts = math.prod(axis_size(mesh, a) for a in spec)
    numel = math.prod(shape)
    if numel % parts:
        raise ValueError(f"spec {spec} does not divide {tuple(shape)}")
    return numel // parts * itemsize


def _pairs(tree, specs) -> Iterable[Tuple[object, tuple]]:
    """(tensor, spec) over a state tree and its spec tree (dicts, lists,
    cache dataclasses and named tuples)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, specs[k])
    elif isinstance(tree, list):
        for v, s in zip(tree, specs):
            yield from _pairs(v, s)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _pairs(getattr(tree, f.name), getattr(specs, f.name))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for v, s in zip(tree, specs):
            yield from _pairs(v, s)
    else:
        yield tree, tuple(specs)


def _tree_bytes(tree, specs, mesh) -> Tuple[int, int]:
    """(bytes a device holds, tensors) of ``tree`` placed by ``specs``."""
    total = n = 0
    for t, spec in _pairs(tree, specs):
        total += spec_bytes(t.shape, t.element_size(), spec, mesh)
        n += 1
    return total, n


def param_bytes(model, cfg, mesh, *, fsdp: bool = True,
                serve_bf16: bool = False) -> Tuple[int, int]:
    """(bytes a device holds, tensors) of the model's parameters;
    ``serve_bf16`` counts fp32 masters as the bf16 weights the reference
    serves."""
    from repro_torch.runtime.sharding import param_pspec
    total = n = 0
    for name, p in model.named_parameters():
        spec = param_pspec(name, tuple(p.shape), cfg, mesh, fsdp=fsdp)
        isz = 2 if serve_bf16 and p.dtype.is_floating_point \
            and p.element_size() == 4 else p.element_size()
        total += spec_bytes(p.shape, isz, spec, mesh)
        n += 1
    return total, n


def opt_bytes(state, model, cfg, mesh) -> Tuple[int, int]:
    from repro_torch.runtime.sharding import opt_pspecs
    return _tree_bytes(state, opt_pspecs(state, model, cfg, mesh), mesh)


def cache_bytes(cache, cfg, mesh) -> Tuple[int, int]:
    from repro_torch.runtime.sharding import cache_pspecs
    return _tree_bytes(cache, cache_pspecs(cache, cfg, mesh), mesh)


def batch_bytes(batch, mesh) -> Tuple[int, int]:
    from repro_torch.runtime.sharding import batch_pspecs
    return _tree_bytes(batch, batch_pspecs(batch, mesh), mesh)


def argument_bytes(cfg, suite, mesh, *, model=None) -> Dict[str, int]:
    """Per-device bytes of one step's arguments, by component: the
    parameters (bf16 to serve, as the reference serves them, with its
    FSDP rule), the optimizer state (train), the decode cache (decode),
    the batch and a train step's int32 step counter."""
    from repro_torch.configs.shapes import input_specs
    from repro_torch.runtime import steps
    model = steps.param_shapes(cfg) if model is None else model
    train = suite.kind == "train"
    fsdp = True if train else serve_fsdp(cfg, mesh)
    out = {"params": param_bytes(model, cfg, mesh, fsdp=fsdp,
                                 serve_bf16=not train)[0]}
    if train:
        state = steps.opt_state_shapes(cfg, pick_optimizer(cfg), model)
        out["opt_state"] = opt_bytes(state, model, cfg, mesh)[0]
    if suite.kind == "decode":
        cache = steps.cache_shapes(cfg, suite.global_batch, suite.seq_len,
                                   model)
        out["cache"] = cache_bytes(cache, cfg, mesh)[0]
    out["batch"] = batch_bytes(input_specs(cfg, suite), mesh)[0]
    if train:
        out["step"] = 4
    return out


# ---------------------------------------------------------------------------
# the step trace
# ---------------------------------------------------------------------------

def trace_step(cfg, suite, *, model=None, batch=None, opt_state=None,
               optimizer=None):
    """One step of ``suite``'s kind at its global shape under
    ``engine.trace_costs()`` -> (trace, outputs).  By default everything
    is on the meta device (nothing planned or launched); given a real
    ``model`` (with ``batch``, and ``opt_state`` to train) the step runs
    and is recorded as it runs.  Remat (``cfg.remat``) stays on, so a
    checkpointed forward counts twice, as in the reference's HLO."""
    from repro_torch.configs.shapes import input_specs
    from repro_torch.core import engine
    from repro_torch.runtime import steps
    model = steps.param_shapes(cfg) if model is None else model
    batch = input_specs(cfg, suite) if batch is None else batch
    if suite.kind == "train":
        optimizer = optimizer or pick_optimizer(cfg)
        if opt_state is None:
            opt_state = steps.opt_state_shapes(cfg, optimizer, model)
        step = steps.make_train_step(
            cfg, optimizer, microbatches=pick_microbatches(cfg, suite))
        with engine.trace_costs() as trace:
            out = step(model, opt_state, batch, 0)
        return trace, {"params": model, "opt_state": opt_state,
                       "metrics": out}
    if suite.kind == "prefill":
        with engine.trace_costs() as trace:
            logits, cache = steps.make_prefill_step(model, suite.seq_len)(
                batch)
        return trace, {"logits": logits, "cache": cache}
    cache = steps.cache_shapes(cfg, suite.global_batch, suite.seq_len, model)
    with engine.trace_costs() as trace:
        logits, cache, pos = steps.make_serve_step(model)(
            cache, batch["tokens"], batch["pos"], batch.get("enc_out"))
    return trace, {"logits": logits, "cache": cache, "pos": pos}


def output_bytes(cfg, suite, mesh, outputs, args: Dict[str, int]
                 ) -> Tuple[int, int]:
    """(output bytes, aliased bytes) a device holds after the step, with
    the reference's donation: train donates parameters and optimizer
    state, decode the cache.  Logits take the batch rule; metrics and the
    position counter are replicated."""
    if suite.kind == "train":
        metrics = sum(t.numel() * t.element_size()
                      for t in outputs["metrics"].values())
        aliased = args["params"] + args["opt_state"]
        return aliased + metrics, aliased
    logits = batch_bytes({"logits": outputs["logits"]}, mesh)[0]
    cache = cache_bytes(outputs["cache"], cfg, mesh)[0]
    if suite.kind == "prefill":
        return logits + cache, 0
    pos = outputs["pos"].numel() * outputs["pos"].element_size()
    return logits + cache + pos, args["cache"]


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, mesh_kind: str, save: bool = True,
             results_dir: str = RESULTS_DIR, _cache: Optional[dict] = None
             ) -> dict:
    """One cell's record (and its JSON under ``results_dir``)."""
    from repro_torch.configs import get_config, shape_for
    from repro_torch.configs.shapes import cell_applicable
    from repro_torch.runtime import steps

    cfg = get_config(arch)
    suite = shape_for(shape_name)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "kind": suite.kind, "params": cfg.param_count(),
              "active_params": cfg.active_param_count()}
    skip = cell_applicable(cfg, suite)
    if skip:
        record.update(status="skip", reason=skip)
        return _finish(record, save, results_dir)

    mesh = make_shape_mesh(mesh_kind)
    chips = mesh.size()
    record["chips"] = chips
    t0 = time.time()
    cache = _cache if _cache is not None else {}
    model = cache.get(("model", arch))
    if model is None:
        model = cache[("model", arch)] = steps.param_shapes(cfg)
    traced = cache.get(("trace", arch, shape_name))
    if traced is None:
        traced = cache[("trace", arch, shape_name)] = trace_step(
            cfg, suite, model=model)
    trace, outputs = traced
    args = argument_bytes(cfg, suite, mesh, model=model)
    out_b, alias_b = output_bytes(cfg, suite, mesh, outputs, args)
    summary = trace.summary()
    record.update(
        status="ok",
        trace_seconds=round(time.time() - t0, 2),
        microbatches=pick_microbatches(cfg, suite),
        fsdp=True if suite.kind == "train" else serve_fsdp(cfg, mesh),
        memory={
            "argument_bytes": sum(args.values()),
            "argument_parts": args,
            "output_bytes": out_b,
            "temp_bytes": None,
            "alias_bytes": alias_b,
            "peak_per_device": None,
        },
        cost={
            "flops_per_device": summary["flops"] / chips,
            "bytes_per_device": summary["bytes"] / chips,
            "non_engine_flops": summary["non_engine_flops"] / chips,
            "partition": "ideal: the global step's counts / chips",
            "families": summary["families"],
        },
        collectives=None,
        collective_bytes_per_device=None,
        gaps=list(GAPS),
    )
    print(f"[{arch} x {shape_name} x {mesh_kind}] traced in "
          f"{record['trace_seconds']}s: {summary['flops']:.4g} engine "
          f"FLOPs, {summary['bytes']:.4g} bytes, "
          f"{sum(args.values()) / 2**30:.3f} GiB of arguments a device")
    return _finish(record, save, results_dir)


def _finish(record: dict, save: bool, results_dir: str = RESULTS_DIR
            ) -> dict:
    if save:
        os.makedirs(results_dir, exist_ok=True)
        name = f"{record['arch']}__{record['shape']}__{record['mesh']}.json"
        with open(os.path.join(results_dir, name), "w") as f:
            json.dump(record, f, indent=2)
    return record


def all_cells():
    from repro_torch.configs import SHAPES, list_configs
    for arch in list_configs():
        for shape in SHAPES:
            for mesh in ("pod", "multipod"):
                yield arch, shape, mesh


def run_all(resume: bool = True, results_dir: str = RESULTS_DIR):
    """Every cell, in this process; a cell whose record says ``ok`` or
    ``skip`` is kept when ``resume``.  A failing cell is recorded as
    ``error``.  Both meshes of a cell share one trace."""
    os.makedirs(results_dir, exist_ok=True)
    failures = []
    cache: dict = {}
    last_arch = None
    for arch, shape, mesh in all_cells():
        if arch != last_arch:
            cache.clear()  # one architecture's meta model at a time
            last_arch = arch
        path = os.path.join(results_dir, f"{arch}__{shape}__{mesh}.json")
        if resume and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("status") in ("ok", "skip"):
                    continue
        try:
            run_cell(arch, shape, mesh, results_dir=results_dir,
                     _cache=cache)
        except Exception:
            failures.append((arch, shape, mesh))
            _finish({"arch": arch, "shape": shape, "mesh": mesh,
                     "status": "error",
                     "error": traceback.format_exc()[-4000:]}, True,
                    results_dir)
            print(f"FAIL [{arch} x {shape} x {mesh}]:\n"
                  f"{traceback.format_exc()[-2000:]}")
    print(f"\ndry-run sweep done; {len(failures)} failures: {failures}")
    return failures


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _row_descriptor(row: dict, decode_pool: Tuple[int, int]):
    """The descriptor of one of ``chip_smoke.py``'s kernel rows (its
    ``kernel`` name and shape fields), or None for a kernel no descriptor
    family covers.  ``decode_pool`` is the paged rows' (pages,
    max_blocks)."""
    from repro_torch.core.descriptor import (
        FlashBwdDescriptor, FlashDecodeDescriptor, FlashDescriptor,
        GemmDescriptor, GroupedGemmBwdDescriptor, GroupedGemmDescriptor,
        SsdChunkBwdDescriptor, SsdChunkDescriptor, TransposeDescriptor,
        resolve_quant)
    k = row["kernel"]
    if k in ("gemm_fused", "gemm_region"):
        nb, m, n, kk = row["shape"]
        return GemmDescriptor(m=m, n=n, k=kk, layout=row["layout"],
                              in_dtype=row["dtype"], out_dtype=row["dtype"],
                              epilogue=row["epilogue"],
                              accumulate=row["accumulate"], batch=nb)
    if k == "gemm_quant":
        # As ``gemm`` builds it: A in its wire dtype under full quant.
        m, n, kk = row["shape"]
        quant = resolve_quant(row["mode"])
        return GemmDescriptor(m=m, n=n, k=kk, layout=row["layout"],
                              in_dtype=row["a_dtype"] if quant.weight_only
                              else quant.dtype,
                              out_dtype=row["out_dtype"],
                              epilogue=row["epilogue"], quant=quant)
    if k in ("flash_fwd_fused", "flash_fwd_dense", "flash_bwd_fused"):
        bh, sq, sk, d = row["shape"]
        cls = FlashBwdDescriptor if k == "flash_bwd_fused" \
            else FlashDescriptor
        return cls(batch_heads=bh, sq=sq, sk=sk, d=d, causal=row["causal"],
                   dtype=row["dtype"])
    if k in ("flash_decode", "flash_decode_int8"):
        s, h, hkv, hd, p = row["shape"]
        pages, max_blocks = decode_pool
        return FlashDecodeDescriptor(num_seqs=s, pages=pages, page_size=p,
                                     max_blocks=max_blocks, num_heads=h,
                                     num_kv_heads=hkv, head_dim=hd,
                                     dtype=row["dtype"])
    if k in ("ssd_scan_fused", "ssd_chunk_diag", "ssd_scan_bwd"):
        g, nc, q, n, p = row["shape"]
        dtype = row["dtypes"][2]
        if k == "ssd_chunk_diag":
            return SsdChunkDescriptor(groups=g * nc, q=q, n=n, p=p,
                                      dtype=dtype)
        cls = SsdChunkBwdDescriptor if k == "ssd_scan_bwd" \
            else SsdChunkDescriptor
        return cls(groups=g, q=q, n=n, p=p, dtype=dtype, chunks=nc)
    if k in ("grouped_fused", "grouped_padded", "grouped_bwd",
             "grouped_quant"):
        cls = GroupedGemmBwdDescriptor if k == "grouped_bwd" \
            else GroupedGemmDescriptor
        quant = resolve_quant(row["mode"]) if k == "grouped_quant" else None
        return cls(t=row["rows"], k=row["k"], n=row["n"],
                   num_experts=len(row["group_sizes"]),
                   dtype=row.get("dtype") or row["x_dtype"],
                   epilogue=row["epilogue"], quant=quant)
    if k == "transpose":
        nb, rows, cols = row["shape"]
        return TransposeDescriptor(rows=rows, cols=cols, dtype=row["dtype"],
                                   batch=nb)
    return None


def roofline_beside_bound(rows, decode_pool: Tuple[int, int],
                          rel_tol: float = 0.01):
    """For each kernel row of ``chip_smoke.py``: ``kernel_roofline`` of its
    descriptor on ``H100_SXM`` beside the row's own bound (``byte_ms``,
    ``op_ms``, ``bound_ms``), and whether the two bounds agree within
    ``rel_tol``.  A report, not a gate: a row whose descriptor cannot be
    built is reported with its error."""
    from repro_torch.core.machine import H100_SXM
    from repro_torch.launch.roofline import kernel_roofline
    out = []
    for row in rows:
        try:
            desc = _row_descriptor(row, decode_pool)
        except Exception as e:  # a row schema this reader does not know
            out.append({"kernel": row.get("kernel"), "case": row.get("case"),
                        "error": repr(e), "agree": False})
            continue
        if desc is None:
            continue
        rl = kernel_roofline(desc, H100_SXM)
        rl_ms = max(rl["compute_s"], rl["memory_s"]) * 1e3
        agree = abs(rl_ms - row["bound_ms"]) <= rel_tol * max(
            rl_ms, row["bound_ms"], 1e-12)
        out.append({
            "kernel": row["kernel"], "case": row["case"],
            "main_path": row.get("main_path"),
            "bound": {k: row.get(k) for k in ("byte_ms", "op_ms", "bound_ms",
                                             "bound_by")},
            "roofline": {"memory_ms": rl["memory_s"] * 1e3,
                         "compute_ms": rl["compute_s"] * 1e3,
                         "bound_ms": rl_ms, "dominant": rl["dominant"],
                         "flops": rl["flops"], "bytes": rl["bytes"]},
            "agree": agree})
    return out


CARD_ARCH = "qwen3-0.6b"
CARD_CACHE = (4, 512)       # KVCache batch x capacity
CARD_PREFILL = (4, 256)     # prefill batch x prompt
CARD_TRAIN = (8, 128)       # train batch x sequence


def card_check(device, kernel_rows, decode_pool: Tuple[int, int]) -> dict:
    """The dry-run held to the card (``chip_smoke.py``'s ``dryrun`` phase).

    1. Bytes: full-width qwen3-0.6b, its AdamW state, a dense KV cache of
       ``CARD_CACHE`` and a train batch, each built on ``device``; the
       growth of the caching allocator's ``requested_bytes`` must equal
       the dry-run's per-device byte count on a (1, 1) mesh exactly.  The
       growth of ``memory_allocated()`` is reported beside it: it counts
       blocks, rounded to 512 B and handed out whole when a split would
       leave at most 1 MiB, so it can exceed the tensors' bytes.
    2. The trace: one prefill at ``CARD_PREFILL`` and one train step at
       ``CARD_TRAIN`` run on the card under the trace; per family their
       calls, FLOPs and bytes must equal the meta trace of the same step
       at the same shape, as integers.
    3. ``kernel_roofline`` beside ``chip_smoke.py``'s own bounds for each
       of ``kernel_rows`` (a report).

    Returns the report; ``report["failures"]`` lists the gates that
    failed."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSuite, sample_batch
    from repro_torch.convert import reference_shapes
    from repro_torch.core.machine import H100_SXM
    from repro_torch.runtime import steps

    t0 = time.time()
    device = torch.device(device)
    cfg = get_config(CARD_ARCH)
    mesh = ShapeMesh(data=1, model=1)
    meta = steps.param_shapes(cfg)
    opt = pick_optimizer(cfg)
    failures = []
    report = {"arch": CARD_ARCH, "mesh": mesh.shape,
              "total_memory": torch.cuda.get_device_properties(
                  device).total_memory,
              "hbm_bytes": H100_SXM.hbm_bytes}

    def held():
        torch.cuda.synchronize(device)
        return (torch.cuda.memory_stats(device)["requested_bytes.all.current"],
                torch.cuda.memory_allocated(device))

    def grown(build):
        before = held()
        obj = build()
        return obj, tuple(a - b for a, b in zip(held(), before))

    def gate(name, got, want_tensors):
        (requested, allocated), (want, n) = got, want_tensors
        ok = requested == want
        report.setdefault("bytes", {})[name] = dict(
            requested=requested, allocated=allocated, dry_run=want,
            tensors=n, ok=ok)
        if not ok:
            failures.append(f"{name}: {requested} bytes requested, "
                            f"{allocated} allocated, the dry-run counts "
                            f"{want} ({n} tensors)")

    model, got = grown(lambda: steps.model_for(cfg)(cfg, device=device,
                                                    seed=0))
    gate("params", got, param_bytes(meta, cfg, mesh))
    state, got = grown(lambda: opt.init(
        dict(model.named_parameters()), shapes=reference_shapes(cfg, model)))
    gate("opt_state", got, opt_bytes(
        steps.opt_state_shapes(cfg, opt, meta), meta, cfg, mesh))
    b, cap = CARD_CACHE
    cache, got = grown(lambda: model.init_cache(b, cap))
    gate("cache", got, cache_bytes(steps.cache_shapes(cfg, b, cap, meta),
                                   cfg, mesh))
    del cache
    b, s = CARD_TRAIN
    train_suite = ShapeSuite("card_train", s, b, "train")
    batch, got = grown(lambda: sample_batch(cfg, train_suite, device=device))
    gate("batch", got, batch_bytes(batch, mesh))

    b, s = CARD_PREFILL
    prefill_suite = ShapeSuite("card_prefill", s, b, "prefill")
    traces = {}
    for name, suite, kw in (
            ("prefill", prefill_suite,
             dict(batch=sample_batch(cfg, prefill_suite, device=device))),
            ("train", train_suite,
             dict(batch=batch, opt_state=state, optimizer=opt))):
        card, _ = trace_step(cfg, suite, model=model, **kw)
        torch.cuda.synchronize(device)
        shape_only, _ = trace_step(cfg, suite, model=meta)
        same = card.families == shape_only.families
        traces[name] = dict(card=card.summary(),
                            meta=shape_only.summary(), equal=same)
        if not same:
            failures.append(f"{name}: the card's trace {card.families} is "
                            f"not the meta trace {shape_only.families}")
    report["trace"] = traces
    report["roofline"] = roofline_beside_bound(kernel_rows, decode_pool)
    report["roofline_disagree"] = [
        f"{r['kernel']}:{r['case']}" for r in report["roofline"]
        if not r["agree"]]
    del model, state, batch
    torch.cuda.empty_cache()
    report["seconds"] = time.time() - t0
    report["failures"] = failures
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("pod", "multipod"), default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    if args.all:
        failures = run_all(resume=not args.no_resume,
                           results_dir=args.results_dir)
        sys.exit(1 if failures else 0)
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    rec = run_cell(args.arch, args.shape, args.mesh,
                   results_dir=args.results_dir)
    sys.exit(0 if rec["status"] in ("ok", "skip") else 1)


if __name__ == "__main__":
    main()
