"""The engine's cost trace (``engine.trace_costs``) and the meta device.

A step traced on the meta device (nothing planned, launched or stored)
must record what the same step records when it runs: for every reduced
architecture and kind, the CPU run under the trace and the meta trace
give the same calls, FLOPs and bytes per family, the same FLOPs outside
the engine, and outputs of the same shapes and dtypes.  That is the CPU
form of ``chip_smoke.py``'s ``dryrun`` gate, which runs the full-width
qwen3 steps on the card.  The trace's distinct descriptors of a reduced
qwen3 prefill and train step must be the reference's
``engine.seen_descriptors()`` after the same eager steps.  ``meta`` is
admitted only inside ``core.config.shape_only``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_configs
from repro.configs import reduced_config as j_reduced
from repro.configs.shapes import ShapeSuite as JShapeSuite
from repro.configs.shapes import sample_batch as j_sample_batch
from repro.core import engine as jengine
from repro.core import use as juse
from repro.optim import adamw as j_adamw
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.runtime import steps as jsteps

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.shapes import ShapeSuite, sample_batch
from repro_torch.core import engine, use
from repro_torch.core.config import resolve_device, shape_only
from repro_torch.core.descriptor import GemmDescriptor
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_cost import descriptor_cost
from repro_torch.models import LanguageModel
from repro_torch.runtime import steps

ARCHS = list_configs()
KINDS = [("prefill", 2, 16), ("train", 2, 16), ("decode", 2, 16)]


def _leaves(tree):
    """(shape, dtype) of every tensor of an output tree, in order."""
    if isinstance(tree, torch.Tensor):
        return [(tuple(tree.shape), tree.dtype)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    if isinstance(tree, torch.nn.Module):
        return [(tuple(p.shape), p.dtype) for p in tree.parameters()]
    return []


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind,batch,seq", KINDS)
def test_cpu_run_equals_meta_trace(arch, kind, batch, seq):
    cfg = reduced_config(get_config(arch))
    suite = ShapeSuite(f"small_{kind}", seq, batch, kind)
    with use(device="cpu"):
        model = steps.model_for(cfg)(cfg, device="cpu", seed=0)
        data = sample_batch(cfg, suite, seed=1, device="cpu")
        ran, ran_out = dryrun.trace_step(cfg, suite, model=model, batch=data)
    shaped, shaped_out = dryrun.trace_step(cfg, suite)
    assert ran.families == shaped.families
    assert ran.non_engine_flops == shaped.non_engine_flops
    assert ran.descriptors.keys() == shaped.descriptors.keys()
    assert ran.families, "the step reached the engine"
    assert _leaves(ran_out) == _leaves(shaped_out)


def test_trace_sums_descriptor_costs():
    cfg = reduced_config(get_config("phi3.5-moe-42b"))
    trace, _ = dryrun.trace_step(cfg, ShapeSuite("t", 16, 2, "train"))
    assert {"gemm", "grouped_gemm", "grouped_gemm_bwd"} <= set(trace.families)
    for fam, row in trace.families.items():
        descs = [d for d in trace.descriptors.values() if d.family == fam]
        assert descs and row["calls"] >= len(descs)
    summary = trace.summary()
    assert summary["flops"] == sum(r["flops"]
                                   for r in summary["families"].values())
    one = GemmDescriptor(m=8, n=16, k=32)
    with engine.trace_costs() as t:
        a = torch.empty((8, 32), device="meta")
        b = torch.empty((32, 16), device="meta")
        for _ in range(3):
            out = engine.dispatch(one, a, b)
    cost = descriptor_cost(one)
    assert t.families["gemm"] == {"calls": 3, "flops": 3 * cost["flops"],
                                  "bytes": 3 * cost["bytes"]}
    assert out.is_meta and tuple(out.shape) == (8, 16)
    assert t.non_engine_flops == 0


def test_meta_dispatch_plans_and_launches_nothing():
    engine.reset_stats()
    a = torch.empty((64, 32), device="meta")
    b = torch.empty((32, 48), device="meta")
    desc = GemmDescriptor.from_operands(a, b)
    with engine.trace_costs():
        engine.dispatch(desc, a, b)
    assert engine.stats().get("gemm", {}).get("launches", 0) == 0
    assert engine.stats().get("gemm", {}).get("planner_calls", 0) == 0
    assert engine.seen_descriptors() == []


def test_meta_outside_a_trace_raises():
    a = torch.empty((4, 4), device="meta")
    with pytest.raises(RuntimeError, match="trace_costs"):
        engine.dispatch(GemmDescriptor(m=4, n=4, k=4), a, a)


def test_traces_do_not_nest():
    with engine.trace_costs():
        with pytest.raises(RuntimeError, match="nest"):
            with engine.trace_costs():
                pass
    with engine.trace_costs():  # the first one closed cleanly
        pass


def test_meta_device_only_inside_shape_only():
    cfg = reduced_config(get_config("qwen3-0.6b"))
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    with pytest.raises(ValueError):
        LanguageModel(cfg, device="meta")
    with shape_only():
        assert resolve_device("meta").type == "meta"
        model = LanguageModel(cfg, device="meta")
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert all(p.is_meta for p in model.parameters())
    meta = steps.param_shapes(cfg)
    assert [(n, p.shape) for n, p in meta.named_parameters()] == \
        [(n, p.shape) for n, p in model.named_parameters()]


def test_shape_helpers():
    cfg = reduced_config(get_config("recurrentgemma-9b"))
    model = steps.param_shapes(cfg)
    cache = steps.cache_shapes(cfg, 3, 40, model)
    assert all(shape for shape, _ in _leaves(cache))
    assert len(cache) == cfg.num_layers
    opt = dryrun.pick_optimizer(get_config("grok-1-314b"))
    state = steps.opt_state_shapes(cfg, opt, model)
    assert set(state) == {"v"}
    assert all(t.is_meta for t in state["v"].values()
               if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# the trace against the reference's dispatched descriptors
# ---------------------------------------------------------------------------

def _reference_seen(kind, batch, seq):
    jcfg = j_reduced(j_get_config("qwen3-0.6b"))
    jengine.reset_stats()
    params = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype),
                          jsteps.param_shapes(jcfg))
    data = j_sample_batch(jcfg, JShapeSuite("x", seq, batch, kind))
    with juse(backend="pallas"):
        if kind == "prefill":
            jsteps.make_prefill_step(jcfg, capacity=seq)(params, data)
        else:
            opt = j_adamw(j_warmup_cosine(3e-4, 10, 100))
            jsteps.make_train_step(jcfg, opt)(params, opt.init(params), data,
                                              jnp.int32(0))
    seen = {d.cache_key() for d in jengine.seen_descriptors()}
    jengine.reset_stats()
    return seen


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_trace_descriptors_equal_reference_seen(kind):
    want = _reference_seen(kind, 2, 16)
    trace, _ = dryrun.trace_step(reduced_config(get_config("qwen3-0.6b")),
                                 ShapeSuite("x", 16, 2, kind))
    assert set(trace.descriptors) == want
    families = {"gemm", "flash_attention"} | (
        {"flash_attention_bwd"} if kind == "train" else set())
    assert set(trace.families) == families
