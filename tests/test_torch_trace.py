"""The port's spans (``repro_torch.core.trace``) on the CPU:

  * with no profiler running, ``span`` hands back one shared null context
    and a serving run makes no profiler record at all;
  * under a CPU ``torch.profiler``, a two-layer mixture of experts served
    through ``ContinuousBatchingEngine`` (one admission, two decode steps)
    gives the scheduler's spans once a step, the layers' once a layer a
    forward, nested as the code nests them; each ``moe`` span's capacity
    and routed rows equal the rows the expert GEMMs were handed and the
    tokens times top-k; ``cast`` appears only where the dtype changes;
  * a gated-silu dense training step gives one ``matmul.recompute`` for
    each activation GEMM of its forward, with remat on or off, and one
    ``optim.update``;
  * tokens, loss and parameters are bit-identical with the profiler on and
    off.
"""
import collections
import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import trace, use
from repro_torch.models import LanguageModel
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import PageSpec
from repro_torch.optim import adamw
from repro_torch.runtime.batching import ContinuousBatchingEngine, Request
from repro_torch.runtime.steps import make_train_step

PROMPT = np.array([3, 17, 9, 250, 4], np.int32)
SLOTS = 2
matmul_mod = importlib.import_module("repro_torch.core.matmul")


def moe_cfg(dtype="bfloat16"):
    return reduced_config(get_config("phi3.5-moe-42b"), dtype=dtype,
                          kv_cache_dtype=dtype)


def serve(cfg, steps=2):
    """Generated tokens of one request over ``steps`` scheduler steps."""
    model = LanguageModel(cfg, device="cpu", seed=0)
    eng = ContinuousBatchingEngine(model, num_slots=SLOTS,
                                   spec=PageSpec(8, 4, 4))
    eng.submit(Request(0, PROMPT, 8))
    for _ in range(steps):
        eng.step()
    return list(eng.slots[0].generated)


def spans_of(prof, tmp_path):
    """(name, attrs, start, end) of every ``repro_torch.`` event."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = []
    for ev in json.loads(path.read_text())["traceEvents"]:
        name = ev.get("name", "")
        if ev.get("ph") != "X" or not name.startswith(trace.PREFIX):
            continue
        name, _, attrs = name[len(trace.PREFIX):].partition("|")
        attrs = dict(kv.split("=") for kv in attrs.split(",")) if attrs \
            else {}
        out.append((name, {k: int(v) if v.isdigit() else v
                           for k, v in attrs.items()},
                    float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
    return out


def inside(spans, outer):
    return [s for s in spans if any(o[2] <= s[2] and s[3] <= o[3]
                                    for o in outer)]


def named(spans, name):
    return [s for s in spans if s[0] == name]


@pytest.fixture
def engine_cpu():
    with use(backend="engine", device="cpu"):
        yield


def test_off_is_one_shared_null_context_and_records_nothing(engine_cpu,
                                                            monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert trace.span("sched.decode") is trace.span("moe", tokens=3)
    made = []

    def record(name):
        made.append(name)
        return trace._OFF

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", record)
    serve(moe_cfg())
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        trace.span("moe", tokens=3)
    assert made == ["repro_torch.moe|tokens=3"]


def test_serving_spans(engine_cpu, tmp_path, monkeypatch):
    cfg = moe_cfg()
    rows = []
    grouped = moe_mod._expert_gemm_grouped

    def seen(x4, w, epilogue=None):
        rows.append(x4.shape[0] * x4.shape[1] * x4.shape[2])
        return grouped(x4, w, epilogue)

    monkeypatch.setattr(moe_mod, "_expert_gemm_grouped", seen)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve(cfg)
    spans = spans_of(prof, tmp_path)
    count = collections.Counter(s[0] for s in spans)
    layers, forwards = cfg.num_layers, 3          # one prefill, two decodes
    for name in ("sched.admit", "sched.grow", "sched.decode",
                 "sched.readback"):
        assert count[name] == 2, name
    assert inside(named(spans, "sched.readback"),
                  named(spans, "sched.decode")) == named(spans,
                                                         "sched.readback")
    (prefill,) = named(spans, "sched.prefill")
    assert prefill[1] == {"rid": 0, "len": len(PROMPT)}
    assert inside([prefill], named(spans, "sched.admit")) == [prefill]
    for name in ("attention", "mlp", "moe", "moe.route"):
        assert count[name] == layers * forwards, name
    assert count["readout"] == forwards
    moes = named(spans, "moe")
    assert inside(moes, named(spans, "mlp")) == moes
    assert inside(named(spans, "moe.route"), moes) == named(spans,
                                                            "moe.route")
    # Three expert GEMMs a layer (gate, up, down), each over the capacity
    # rows; the tokens are the prompt's, then one a slot.
    k = cfg.num_experts_per_tok
    assert [m[1]["capacity_rows"] for m in moes] == rows[::3]
    assert [m[1]["tokens"] for m in moes] == \
        [len(PROMPT)] * layers + [SLOTS] * 2 * layers
    assert [m[1]["routed_rows"] for m in moes] == \
        [m[1]["tokens"] * k for m in moes]
    casts = named(spans, "cast")
    assert casts and inside(casts, named(spans, "attention")
                            + named(spans, "mlp")
                            + named(spans, "readout")) == casts
    assert {c[1]["bytes"] % 6 for c in casts} == {0}  # fp32 read, bf16 written


def test_no_cast_span_without_a_cast(engine_cpu, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve(moe_cfg("float32"), steps=1)
    count = collections.Counter(s[0] for s in spans_of(prof, tmp_path))
    assert count["moe"] and not count["cast"]


def train_once(cfg, seed=0):
    """(loss, parameters) after one AdamW step on a fixed batch."""
    model = LanguageModel(cfg, device="cpu", seed=seed)
    opt = adamw(1e-3)
    state = opt.init(dict(model.named_parameters()))
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen)
    out = make_train_step(cfg, opt)(model, state, {"tokens": ids[:, :-1],
                                                   "labels": ids[:, 1:]}, 0)
    return out["loss"], {n: p.detach().clone()
                         for n, p in model.named_parameters()}


@pytest.mark.parametrize("remat", [False, True])
def test_one_recompute_span_an_activation_gemm(engine_cpu, tmp_path,
                                               monkeypatch, remat):
    cfg = dataclasses.replace(reduced_config(get_config("qwen3-0.6b")),
                              remat=remat)
    assert cfg.mlp_gated and cfg.mlp_act == "silu"
    apply = matmul_mod._EngineGemm.apply
    activations = []

    def counted(a, b, c, bias, layout, epilogue, *rest):
        activations.append(epilogue in matmul_mod.ACTIVATIONS)
        return apply(a, b, c, bias, layout, epilogue, *rest)

    monkeypatch.setattr(matmul_mod._EngineGemm, "apply", counted)
    LanguageModel(cfg, device="cpu", seed=0)(
        torch.zeros((1, 4), dtype=torch.long))
    monkeypatch.undo()
    assert sum(activations) == cfg.num_layers
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_once(cfg)
    count = collections.Counter(s[0] for s in spans_of(prof, tmp_path))
    assert count["matmul.recompute"] == sum(activations)
    assert count["optim.update"] == 1


def test_bit_identical_with_the_profiler_on(engine_cpu):
    cfg = moe_cfg()
    off = serve(cfg)
    with profile(activities=[ProfilerActivity.CPU]):
        on = serve(cfg)
    assert on == off
    dense = reduced_config(get_config("qwen3-0.6b"))
    loss_off, params_off = train_once(dense)
    with profile(activities=[ProfilerActivity.CPU]):
        loss_on, params_on = train_once(dense)
    assert torch.equal(loss_on, loss_off)
    for name, p in params_off.items():
        assert torch.equal(params_on[name], p), name
