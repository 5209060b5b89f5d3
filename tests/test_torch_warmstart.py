"""The port's refit and warm start, on the CPU: the reference's
tests/test_warmstart.py cases that need no mesh, run against the port,
plus:

  * ``descriptor_from_cache_key`` equal to the reference's on the same
    keys, for every family, quant and transpose included;
  * refit coefficients equal to the reference's on the same records under
    ``TPU_V5E`` (rtol 1e-9: the same numpy solve on the same features);
  * ``synth_operands`` driving one ``execute()`` of every family;
  * zero-stall warm serving: a cold continuous run autotunes into a
    tuning cache and records its manifest; after a restart the warm run,
    preloading that cache, times nothing and misses no plan, every tuned
    plan served by the cache, with the cold run's tokens;
  * ``--warm-start``, ``--tuning-cache``, ``--tuning-cache-preload`` and
    ``--refit-model`` through the serve CLI.

Tolerances: recovered coefficients rel 5% (15% with outliers), as the
reference's tests; GEMM outputs atol = rtol = 1e-5 between runs of the
same plan.
"""
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core import (GemmDescriptor, TransposeDescriptor,
                              candidate_plans, engine, matmul, plan_gemm,
                              use)
from repro_torch.core import refit as refit_lib
from repro_torch.core import warmstart
from repro_torch.core.autotune import TuningCache
from repro_torch.core.descriptor import (FlashBwdDescriptor,
                                         FlashDecodeDescriptor,
                                         FlashDescriptor,
                                         GroupedGemmBwdDescriptor,
                                         GroupedGemmDescriptor, QuantSpec,
                                         SsdChunkBwdDescriptor,
                                         SsdChunkDescriptor,
                                         descriptor_from_cache_key)
from repro_torch.core.machine import (H100_SXM, REFIT_MODEL_VERSION, TPU_V5E,
                                      load_refit_model)

RNG = np.random.default_rng(11)


def rand(shape):
    return torch.from_numpy(RNG.standard_normal(shape).astype(np.float32))


@pytest.fixture(autouse=True)
def fresh_engine():
    engine.reset_stats()
    with use(device="cpu"):
        yield
    engine.reset_stats()


# ---------------------------------------------------------------------------
# Coefficient refit on synthetic timings
# ---------------------------------------------------------------------------

TRUE = dataclasses.replace(
    TPU_V5E, step_overhead_s=5e-7, launch_overhead_s=4e-6,
    extra_launch_factor=0.5, fused_tile_decode_s=1e-6, stitch_discount=0.4)

SHAPES = [(128, 128, 512), (256, 512, 512), (640, 640, 512),
          (512, 1024, 1024), (80, 80, 512), (1024, 256, 2048),
          (250, 250, 512), (640, 1280, 512), (896, 384, 1024)]


def _synthetic_records(machine, base=TPU_V5E):
    """(plan, us) pairs timed by ``machine``'s own cost model, planned
    under ``base``: block and lowering diversity identify every
    coefficient."""
    records = []
    for m, n, k in SHAPES:
        d = GemmDescriptor(m=m, n=n, k=k)
        for fb in (None, (256, 256), (128, 128), (512, 512)):
            try:
                p = plan_gemm(d, base, force_block=fb)
            except ValueError:
                continue
            for fused in (True, False):
                pp = dataclasses.replace(p, fused=fused)
                records.append((pp, pp.predicted_seconds(machine) * 1e6))
    return records


def test_refit_recovers_known_coefficients():
    records = _synthetic_records(TRUE)
    fit = refit_lib.fit_records(records, TPU_V5E)
    for name in ("step_overhead_s", "launch_overhead_s",
                 "extra_launch_factor", "fused_tile_decode_s",
                 "stitch_discount"):
        assert name in fit["fitted"], fit["fitted"]
        got, want = fit["coefficients"][name], getattr(TRUE, name)
        assert got == pytest.approx(want, rel=0.05), (name, got, want)
    assert fit["residual_us"]["after"] < fit["residual_us"]["before"]
    assert fit["residual_us"]["after"] < 1.0


def test_refit_coefficients_equal_reference():
    """The same records, as the reference's plans and as the port's, fit
    to the same coefficients under TPU_V5E (rtol 1e-9)."""
    from repro.core import refit as j_refit
    from repro.core.blocking import BlockingPlan as JBlockingPlan
    from repro.core.blocking import Region as JRegion
    from repro.core.descriptor import GemmDescriptor as JGemmDescriptor
    from repro.core.machine import TPU_V5E as J_TPU_V5E
    records = _synthetic_records(TRUE)
    jrecords = []
    for plan, us in records:
        d = plan.desc
        jp = JBlockingPlan(JGemmDescriptor(m=d.m, n=d.n, k=d.k),
                           tuple(JRegion(*dataclasses.astuple(r))
                                 for r in plan.regions),
                           plan.bk, plan.heterogeneous, fused=plan.fused)
        assert jp.predicted_seconds(J_TPU_V5E) == pytest.approx(
            plan.predicted_seconds(TPU_V5E), rel=1e-12)
        jrecords.append((jp, us))
    want = j_refit.fit_records(jrecords, J_TPU_V5E)
    got = refit_lib.fit_records(records, TPU_V5E)
    assert got["fitted"] == want["fitted"]
    for name, value in want["coefficients"].items():
        assert got["coefficients"][name] == pytest.approx(value, rel=1e-9), \
            name
    assert got["residual_us"] == pytest.approx(want["residual_us"])


def test_refit_reduces_misranks_vs_base_model():
    records = _synthetic_records(TRUE)
    pairs = [(records[i][0], records[i + 1][0],
              records[i][1], records[i + 1][1])
             for i in range(0, len(records), 2)]
    fit = refit_lib.fit_records(records, TPU_V5E)
    after_machine = refit_lib.apply_fit(TPU_V5E, {**fit, "fingerprint": "t"})
    bad_before, considered = refit_lib.count_misranks(pairs, TPU_V5E)
    bad_after, _ = refit_lib.count_misranks(pairs, after_machine)
    assert considered > 0
    assert bad_after == 0
    assert bad_after <= bad_before


def test_refit_unfitted_coefficients_keep_base_values():
    d = GemmDescriptor(m=128, n=128, k=512)
    p = plan_gemm(d, TPU_V5E)
    assert len(p.regions) == 1
    pp = dataclasses.replace(p, fused=True)
    records = [(pp, pp.predicted_seconds(TRUE) * 1e6)]
    fit = refit_lib.fit_records(records, TPU_V5E)
    assert "stitch_discount" not in fit["fitted"]
    assert fit["coefficients"]["stitch_discount"] == TPU_V5E.stitch_discount
    assert fit["coefficients"]["extra_launch_factor"] == \
        TPU_V5E.extra_launch_factor


def test_refit_robust_to_outliers():
    records = _synthetic_records(TRUE)
    corrupted = list(records)
    for i in (0, 7, 20):
        plan, us = corrupted[i]
        corrupted[i] = (plan, us * 50.0)
    fit = refit_lib.fit_records(corrupted, TPU_V5E)
    assert fit["coefficients"]["step_overhead_s"] == pytest.approx(
        TRUE.step_overhead_s, rel=0.15)
    assert fit["coefficients"]["launch_overhead_s"] == pytest.approx(
        TRUE.launch_overhead_s, rel=0.15)


def test_refit_rejects_empty():
    with pytest.raises(ValueError):
        refit_lib.fit_records([], TPU_V5E)


def test_refit_on_h100_plans():
    """H100_SXM's own plans identify its coefficients too (its model
    charges no stitch: the region kernel writes straight into C)."""
    true = dataclasses.replace(H100_SXM, step_overhead_s=4e-8,
                               launch_overhead_s=6e-6,
                               extra_launch_factor=0.5,
                               fused_tile_decode_s=2e-8)
    records = []
    for m, n, k in SHAPES:
        d = GemmDescriptor(m=m, n=n, k=k, in_dtype="bfloat16",
                           out_dtype="bfloat16")
        for plan in candidate_plans(d, H100_SXM, 24):
            records.append((plan, plan.predicted_seconds(true) * 1e6))
    fit = refit_lib.fit_records(records, H100_SXM)
    for name in ("step_overhead_s", "launch_overhead_s",
                 "fused_tile_decode_s"):
        assert fit["coefficients"][name] == pytest.approx(
            getattr(true, name), rel=0.05), name
    # H100_SXM charges no stitch; the fit finds none in these timings.
    assert fit["coefficients"]["stitch_discount"] == pytest.approx(0.0,
                                                                   abs=1e-6)


# ---------------------------------------------------------------------------
# Cache-entry parsing and the fit_cache_entries payload
# ---------------------------------------------------------------------------

def _cache_with_synthetic_entries(path, machine):
    cache = TuningCache(path)
    for plan, us in _synthetic_records(machine):
        cache.store(TPU_V5E.tuning_key, plan.desc, plan, us, mode="cuda")
    return cache


def test_fit_cache_entries_payload(tmp_path):
    path = str(tmp_path / "cache.json")
    _cache_with_synthetic_entries(path, TRUE)
    entries = json.load(open(path))["entries"]
    model = refit_lib.fit_cache_entries(entries, TPU_V5E)
    assert model["version"] == REFIT_MODEL_VERSION
    assert model["kind"] == "machine-refit"
    assert model["base"] == TPU_V5E.name
    assert model["fingerprint"]
    assert model["skipped"] == 0
    assert model["entries"] > 0
    assert model["coefficients"]["step_overhead_s"] == pytest.approx(
        TRUE.step_overhead_s, rel=0.05)
    with pytest.raises(ValueError):  # nothing timed on the CPU
        refit_lib.fit_cache_entries(entries, TPU_V5E, mode="cpu")

    out = str(tmp_path / "model.json")
    refit_lib.save_refit_model(out, model)
    fitted = load_refit_model(out, base=TPU_V5E)
    assert fitted.refit_fingerprint == model["fingerprint"]
    assert fitted.tuning_key == TPU_V5E.name + "+refit"
    assert fitted.fingerprint.endswith("+refit")
    assert fitted.step_overhead_s == pytest.approx(TRUE.step_overhead_s,
                                                   rel=0.05)
    assert fitted.tuning_key != TPU_V5E.tuning_key


def test_reference_reads_the_port_refit_model(tmp_path):
    """The refit-model JSON is the reference's format: its loader applies
    the port's file with the same coefficients."""
    from repro.core.machine import TPU_V5E as J_TPU_V5E
    from repro.core.machine import load_refit_model as j_load
    path = str(tmp_path / "cache.json")
    _cache_with_synthetic_entries(path, TRUE)
    model = refit_lib.fit_cache_entries(json.load(open(path))["entries"],
                                        TPU_V5E)
    out = str(tmp_path / "model.json")
    refit_lib.save_refit_model(out, model)
    theirs, ours = j_load(out, base=J_TPU_V5E), load_refit_model(
        out, base=TPU_V5E)
    assert theirs.tuning_key == ours.tuning_key == "tpu_v5e+refit"
    for name in model["coefficients"]:
        assert getattr(theirs, name) == getattr(ours, name)


def test_parse_entry_degrades_to_none():
    assert refit_lib.parse_entry("garbage-key", {"us": 1.0}) is None
    assert refit_lib.parse_entry(
        "h100_sxm|cuda|('gemm', 'not-a-valid-tuple'", {"us": 1.0}) is None
    d = GemmDescriptor(m=64, n=64, k=64)
    key = f"h100_sxm|cuda|{d.cache_key()!r}"
    assert refit_lib.parse_entry(key, {"family": "gemm"}) is None
    assert refit_lib.parse_entry(key, {"us": 1.0}) is None


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_cli", os.path.join(os.path.dirname(__file__), os.pardir,
                                    "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tune_torch_cli_refit_roundtrip(tmp_path):
    """``tools/tune_torch.py refit CACHE -o MODEL`` recovers the machine
    that generated the timings; a missing input fails loudly."""
    cache_path = str(tmp_path / "cache.json")
    _cache_with_synthetic_entries(cache_path, TRUE)
    tune = _tool("tune_torch")
    out = str(tmp_path / "model.json")
    assert tune.main(["refit", cache_path, "-o", out, "--base",
                      "tpu_v5e"]) == 0
    fitted = load_refit_model(out, base=TPU_V5E)
    assert fitted.refit_fingerprint
    assert fitted.step_overhead_s == pytest.approx(TRUE.step_overhead_s,
                                                   rel=0.05)
    with pytest.raises(FileNotFoundError):
        tune.main(["refit", str(tmp_path / "nope.json"), "-o", out])
    assert tune.main(["refit", cache_path, "-o", out, "--mode", "cpu"]) == 1


# ---------------------------------------------------------------------------
# load_refit_model degradation
# ---------------------------------------------------------------------------

def _good_model(tmp_path, **overrides):
    model = {"version": REFIT_MODEL_VERSION, "kind": "machine-refit",
             "base": TPU_V5E.name, "fingerprint": "abc123",
             "coefficients": {"step_overhead_s": 1e-6}}
    model.update(overrides)
    path = str(tmp_path / "m.json")
    with open(path, "w") as f:
        json.dump(model, f)
    return path


@pytest.mark.parametrize("mutation", [
    {"version": 99},
    {"kind": "something-else"},
    {"base": "other_machine"},
    {"fingerprint": ""},
    {"coefficients": {}},
    {"coefficients": {"not_a_coeff": 1.0}},
    {"coefficients": {"step_overhead_s": -1.0}},
    {"coefficients": {"step_overhead_s": float("nan")}},
    {"coefficients": {"collective_efficiency": {"all_to_all": -2.0}}},
])
def test_load_refit_model_rejects_bad_payloads(tmp_path, mutation):
    path = _good_model(tmp_path, **mutation)
    with pytest.warns(UserWarning):
        m = load_refit_model(path, base=TPU_V5E)
    assert m == TPU_V5E
    assert m.refit_fingerprint is None


def test_load_refit_model_missing_and_corrupt(tmp_path):
    with pytest.warns(UserWarning):
        assert load_refit_model(str(tmp_path / "nope.json"),
                                base=TPU_V5E) == TPU_V5E
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        f.write("{this is not json")
    with pytest.warns(UserWarning):
        assert load_refit_model(bad, base=TPU_V5E) == TPU_V5E


def test_load_refit_model_applies_good_payload(tmp_path):
    path = _good_model(tmp_path)
    m = load_refit_model(path, base=TPU_V5E)
    assert m.step_overhead_s == 1e-6
    assert m.refit_fingerprint == "abc123"
    assert m.tuning_key == "tpu_v5e+refit"
    # a mesh fit's network coefficients are applied too (+net+refit)
    path = _good_model(tmp_path, base=H100_SXM.name, coefficients={
        "launch_overhead_s": 5e-6, "ici_bandwidth_gbps": 100.0,
        "collective_launch_s": 3e-6,
        "collective_efficiency": {"all_gather": 1.0, "all_to_all": 0.5}})
    m = load_refit_model(path)
    assert m.launch_overhead_s == 5e-6
    assert m.ici_bandwidth_gbps == 100.0 and m.collective_launch_s == 3e-6
    assert m.collective_efficiency == {"all_gather": 1.0, "all_to_all": 0.5}
    assert m.network_calibrated and m.tuning_key == "h100_sxm+net+refit"


# ---------------------------------------------------------------------------
# Descriptor cache-key inversion + manifests
# ---------------------------------------------------------------------------

DESCS = [
    GemmDescriptor(m=64, n=128, k=256, layout="nt", epilogue="silu",
                   quant=QuantSpec(dtype="int8")),
    GemmDescriptor(m=64, n=128, k=256, in_dtype="bfloat16",
                   quant=QuantSpec(dtype="float8_e4m3", scheme="per_tile",
                                   weight_only=True)),
    GemmDescriptor(m=8, n=16, k=32, batch=3, accumulate=True,
                   epilogue="bias_gelu", edge="pad", out_dtype="bfloat16"),
    TransposeDescriptor(rows=128, cols=64, batch=2),
    TransposeDescriptor(rows=100, cols=300, dtype="bfloat16"),
    FlashDescriptor(batch_heads=8, sq=100, sk=130, d=64, causal=False,
                    dtype="bfloat16"),
    FlashBwdDescriptor(batch_heads=8, sq=128, sk=128, d=64),
    FlashDecodeDescriptor(num_seqs=4, pages=64, page_size=16,
                          max_blocks=8, num_heads=4, num_kv_heads=2,
                          head_dim=16),
    GroupedGemmDescriptor(t=96, k=64, n=128, num_experts=4,
                          epilogue="silu", quant=QuantSpec(dtype="int8")),
    GroupedGemmBwdDescriptor(t=96, k=64, n=128, num_experts=4,
                             dtype="bfloat16"),
    SsdChunkDescriptor(groups=4, q=64, n=32, p=64),
    SsdChunkDescriptor(groups=4, q=64, n=32, p=64, chunks=3),
    SsdChunkBwdDescriptor(groups=4, q=64, n=32, p=64, chunks=3),
]


@pytest.mark.parametrize("desc", DESCS, ids=lambda d: d.family)
def test_descriptor_cache_key_roundtrip(desc):
    back = descriptor_from_cache_key(desc.cache_key())
    assert back == desc and type(back) is type(desc)
    assert back.cache_key() == desc.cache_key()


@pytest.mark.parametrize("desc", DESCS, ids=lambda d: d.family)
def test_descriptor_from_cache_key_equals_reference(desc):
    """The reference rebuilds the same descriptor from the port's key, and
    the port the same from the reference's."""
    from repro.core.descriptor import \
        descriptor_from_cache_key as j_from_key
    theirs = j_from_key(desc.cache_key())
    assert theirs.cache_key() == desc.cache_key()
    assert type(theirs).__name__ == type(desc).__name__
    assert dataclasses.asdict(descriptor_from_cache_key(
        theirs.cache_key())) == dataclasses.asdict(desc)


def test_descriptor_cache_key_rejects_unknown():
    with pytest.raises(ValueError):
        descriptor_from_cache_key(("no_such_family", 1, 2))
    with pytest.raises(ValueError):
        descriptor_from_cache_key(("gemm", 1, 2))
    with pytest.raises(ValueError):
        descriptor_from_cache_key(())
    # a mesh key round-trips, in both packages, to the same descriptor
    from repro.core.descriptor import \
        descriptor_from_cache_key as j_from_key
    from repro_torch.core import MeshSpec
    mesh_key = GemmDescriptor(m=8, n=8, k=8).cache_key()[:-1] + (
        ("model", 4),)
    desc = descriptor_from_cache_key(mesh_key)
    assert desc.mesh == MeshSpec("model", 4)
    assert desc.cache_key() == mesh_key == j_from_key(mesh_key).cache_key()
    with pytest.raises(ValueError, match="mesh size"):
        descriptor_from_cache_key(GemmDescriptor(m=8, n=6, k=8).cache_key()
                                  [:-1] + (("model", 4),))


def test_manifest_roundtrip(tmp_path):
    path = str(tmp_path / "manifest.json")
    n = warmstart.save_manifest(path, DESCS + DESCS)
    assert n == len(DESCS)
    back = warmstart.load_manifest(path)
    assert sorted(repr(d.cache_key()) for d in back) == \
        sorted(repr(d.cache_key()) for d in DESCS)


def test_manifest_degradation(tmp_path):
    missing = str(tmp_path / "nope.json")
    with pytest.warns(UserWarning):
        assert warmstart.load_manifest(missing) == []
    stale = str(tmp_path / "stale.json")
    with open(stale, "w") as f:
        json.dump({"version": 999, "descriptors": []}, f)
    with pytest.warns(UserWarning):
        assert warmstart.load_manifest(stale) == []
    mixed = str(tmp_path / "mixed.json")
    good = repr(GemmDescriptor(m=32, n=32, k=64).cache_key())
    with open(mixed, "w") as f:
        json.dump({"version": warmstart.MANIFEST_VERSION,
                   "descriptors": [good, "('bogus_family', 1)"]}, f)
    with pytest.warns(UserWarning):
        back = warmstart.load_manifest(mixed)
    assert len(back) == 1 and back[0].family == "gemm"


def test_reference_reads_the_port_manifest(tmp_path):
    from repro.core import warmstart as j_warmstart
    path = str(tmp_path / "manifest.json")
    warmstart.save_manifest(path, DESCS)
    assert sorted(repr(d.cache_key()) for d in
                  j_warmstart.load_manifest(path)) == \
        sorted(repr(d.cache_key()) for d in DESCS)


@pytest.mark.parametrize("desc", [d for d in DESCS
                                  if getattr(d, "edge", "mask") == "mask"],
                         ids=lambda d: d.family)
def test_synth_operands_drive_every_family(desc):
    """Zero operands of the reference's shapes on the configured device run
    one ``execute()`` under the family's model plan."""
    operands, kw = warmstart.synth_operands(desc, "cpu")
    assert all(t.device.type == "cpu" for t in operands)
    fam = engine.get_family(desc.family)
    out = fam.execute(desc, engine.plan_for(desc), *operands, **kw)
    first = out[0] if isinstance(out, tuple) else out
    assert torch.isfinite(first.float()).all()


# ---------------------------------------------------------------------------
# The warm start: zero autotune timings, zero plan misses
# ---------------------------------------------------------------------------

def _all_counts(stats, prefix):
    return sum(v for b in stats.values() for k, v in b.items()
               if k.startswith(prefix))


def test_engine_warmup_zero_stall_serving(tmp_path):
    cache = str(tmp_path / "tune.json")
    manifest = str(tmp_path / "manifest.json")
    a, b = rand((56, 72)), rand((72, 88))
    x = rand((88, 120))
    from repro_torch.kernels.transpose import transpose

    # Fused plans: their kernel state is what the kernel cache holds.
    with use(autotune=True, tuning_cache=cache, autotune_budget=8,
             fused="on"):
        out_a = matmul(a, b)
        out_t = transpose(x)
    assert engine.save_manifest(manifest) == 2

    engine.reset_stats()
    with use(autotune=False, tuning_cache_preload=cache, fused="on"):
        counts = engine.warmup(manifest=manifest)
        assert counts == {"gemm": 1, "transpose": 1}
        s = engine.stats()
        assert s["gemm"]["plan_source_tuned_cache"] == 1
        assert s["transpose"]["plan_source_tuned_cache"] == 1
        assert s["gemm"]["warmups"] == 1 and s["transpose"]["warmups"] == 1
        assert _all_counts(s, "autotune_timings") == 0
        assert _all_counts(s, "warmup_failures") == 0

        engine.reset_stats(entries=False)
        out_a2 = matmul(a, b)
        out_t2 = transpose(x)
        s = engine.stats()

    assert _all_counts(s, "autotune_timings") == 0
    assert _all_counts(s, "plan_misses") == 0
    assert _all_counts(s, "kernel_misses") == 0
    assert _all_counts(s, "kernel_hits") > 0
    assert s["gemm"]["plan_hits"] >= 1 and s["transpose"]["plan_hits"] >= 1
    torch.testing.assert_close(out_a2, out_a, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out_t2, out_t)


def test_warmup_requires_a_population():
    with use(warm_start=""):
        with pytest.raises(ValueError):
            engine.warmup()


def test_warmup_build_failure_degrades(monkeypatch):
    d = GemmDescriptor(m=32, n=64, k=64)

    def boom(*a, **kw):
        raise RuntimeError("synthetic build failure")

    monkeypatch.setattr(warmstart, "synth_operands", boom)
    with pytest.warns(UserWarning, match="warmup build failed"):
        counts = engine.warmup([d])
    assert counts == {"gemm": 1}
    st = engine.stats()["gemm"]
    assert st["warmups"] == 1 and st["warmup_failures"] == 1
    assert st["plan_misses"] == 1  # the plan is warm all the same


def test_config_warm_start_plumbs_through(tmp_path):
    manifest = str(tmp_path / "m.json")
    warmstart.save_manifest(manifest, [GemmDescriptor(m=32, n=32, k=64)])
    with use(warm_start=manifest):
        counts = engine.warmup()
    assert counts == {"gemm": 1}


def _qwen():
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import LanguageModel
    return LanguageModel(reduced_config(get_config("qwen3-0.6b")),
                         device="cpu", seed=0)


def test_continuous_serving_warm_step(tmp_path):
    """A continuous run after warmup on the cold run's manifest: zero
    autotune timings, zero plan misses, the cold run's tokens."""
    from repro_torch.models.attention import PageSpec
    from repro_torch.runtime.batching import (ContinuousBatchingEngine,
                                              poisson_trace)
    model = _qwen()
    reqs = poisson_trace(num_requests=2, rate=1.0, prompt_lens=6, max_new=3,
                         vocab_size=model.cfg.vocab_size, seed=5)
    cold = ContinuousBatchingEngine(model, num_slots=2,
                                    spec=PageSpec(24, 8, 6)).run(reqs)
    manifest = str(tmp_path / "manifest.json")
    assert engine.save_manifest(manifest) > 0
    engine.reset_stats()
    serving = ContinuousBatchingEngine(model, num_slots=2,
                                       spec=PageSpec(24, 8, 6))
    w = serving.warmup(prompt_lens={len(r.prompt) for r in reqs},
                       manifest=manifest)
    assert sum(w["kernels"].values()) > 0
    assert w["prefill_lengths"] == [6]
    engine.reset_stats(entries=False)
    warm = serving.run(reqs)
    s = engine.stats()
    assert _all_counts(s, "autotune_timings") == 0
    assert _all_counts(s, "plan_misses") == 0
    for rid, toks in cold["outputs"].items():
        np.testing.assert_array_equal(warm["outputs"][rid], toks)
    ph = warm["metrics"]["phase_seconds"]
    assert set(ph) == {"admission", "prefill", "decode", "eviction"}


def test_autotuned_cold_then_warm_continuous_run(tmp_path):
    """The chip's ``continuous_warm`` phase in small: a cold run autotunes
    into a tuning cache and records the manifest; after a restart the warm
    run preloads that cache, times nothing, misses no plan, resolves from
    the cache exactly the descriptors the cold run autotuned, and emits
    the cold run's tokens (the same plans replay)."""
    from repro_torch.launch.serve import run_continuous
    model = _qwen()
    cache = str(tmp_path / "tune.json")
    manifest = str(tmp_path / "manifest.json")
    kw = dict(num_slots=3, num_pages=9, page_size=4, max_blocks=8,
              num_requests=4, rate=2.0, prompt_len=10, max_new=8, seed=1,
              check=False)
    with use(autotune=True, autotune_budget=4, tuning_cache=cache):
        cold = run_continuous(model, warm_start=manifest, **kw)
    cold_st = cold["engine_stats"]
    tuned = _all_counts(cold_st, "plan_source_autotuned")
    assert tuned > 0 and cold["metrics"]["evictions"] > 0
    assert _all_counts(cold_st, "autotune_failures") == 0
    assert os.path.exists(manifest)
    engine.reset_stats()
    with use(tuning_cache_preload=cache):
        warm = run_continuous(model, warm_start=manifest, **kw)
    w = warm["warmup"]
    assert w["post_autotune_timings"] == 0 and w["post_plan_misses"] == 0
    assert _all_counts(w["engine_stats"], "plan_source_tuned_cache") == tuned
    assert _all_counts(w["engine_stats"], "warmup_failures") == 0
    for rid, toks in cold["outputs"].items():
        np.testing.assert_array_equal(warm["outputs"][rid], toks)


def test_serve_cli_warm_start_and_tuning_flags(tmp_path, capsys,
                                               monkeypatch):
    """``--warm-start`` records on the first run and warms the second;
    ``--tuning-cache`` / ``--tuning-cache-preload`` / ``--refit-model``
    reach the engine's configuration."""
    from repro_torch.core import config as engine_config
    from repro_torch.launch.serve import main as serve_main
    # The CLI configures the process-wide default: put it back afterwards,
    # and step out of this module's thread-local override meanwhile.
    monkeypatch.setattr(engine_config, "_DEFAULT", engine_config._DEFAULT)
    monkeypatch.setattr(engine_config._tls, "stack", [])
    manifest = str(tmp_path / "manifest.json")
    cache = str(tmp_path / "tune.json")
    pre = str(tmp_path / "fleet.json")
    model_path = _good_model(tmp_path, base=H100_SXM.name)
    args = ["--arch", "qwen3-0.6b", "--device", "cpu", "--continuous",
            "--prompt-len", "24", "--gen", "12", "--warm-start", manifest,
            "--tuning-cache", cache, "--tuning-cache-preload", pre,
            "--refit-model", model_path]
    serve_main(args)
    out = capsys.readouterr().out
    assert f"warm-start: recorded manifest -> {manifest}" in out
    assert "token_identical=True" in out
    cfg = engine_config.get_config()
    assert (cfg.tuning_cache, cfg.tuning_cache_preload) == (cache, pre)
    assert cfg.machine.tuning_key == "h100_sxm+refit"
    assert cfg.machine.step_overhead_s == 1e-6
    engine.reset_stats()
    serve_main(args)
    out = capsys.readouterr().out
    assert "warm-start: warmed" in out
    assert "autotune_timings=0 plan_misses=0" in out
