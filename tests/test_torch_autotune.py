"""The port's calibration and autotuning: probe-calibrated machine models,
candidate enumeration, plan records, the persistent tuning cache and the
engine's three-tier plan resolution -- the reference's
tests/test_autotune.py cases that need no mesh and no jit tracing, run
against the port on the CPU -- plus:

  * ``candidate_plans`` under ``TPU_V5E`` equal to the reference's, knob
    for knob and in order, over a sweep of descriptors of every family;
  * every ``H100_SXM`` candidate one the CUDA executors run on a kernel
    (the GEMM's K panel, the instantiated block shapes, fused quantized
    plans), and equal to the plain version on the CPU;
  * ``search`` leaves its operands as they were, for every family it
    times;
  * a tuning cache the port wrote, read by the reference's
    ``TuningCache`` and refit parser and merged by ``tools/tune.py merge``;
  * a ``gpu`` test that runs every H100 candidate of each family on the
    card against its plain version, and a search there with no failure.

The reference package is imported inside the tests that use it, so the
``gpu`` test also runs where JAX is not installed.  Tolerances: fp32
results atol = rtol = 1e-4 (another summation order), bf16 2e-2.
"""
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core import (FlashDescriptor, GemmDescriptor,
                              GroupedGemmDescriptor, SsdChunkDescriptor,
                              TransposeDescriptor, autotune, candidate_plans,
                              engine, matmul, plan_flash, plan_gemm, plan_ssd,
                              plan_transpose, use)
from repro_torch.core.descriptor import (FlashBwdDescriptor,
                                         FlashDecodeDescriptor,
                                         GroupedGemmBwdDescriptor, QuantSpec,
                                         SsdChunkBwdDescriptor,
                                         descriptor_from_cache_key)
from repro_torch.core.jit_cache import GLOBAL_KERNEL_CACHE
from repro_torch.core.machine import H100_SXM, MachineModel, TPU_V5E
from repro_torch.core.microbench import ProbeResult

RNG = np.random.default_rng(7)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def rand(shape, dtype=torch.float32):
    return torch.from_numpy(RNG.standard_normal(shape).astype(np.float32)) \
        .to(dtype)


@pytest.fixture(autouse=True)
def fresh_engine():
    engine.reset_stats()
    with use(device="cpu"):
        yield
    engine.reset_stats()


# ---------------------------------------------------------------------------
# Microbench-calibrated machine models
# ---------------------------------------------------------------------------

PROBES = {
    "matmul_float32": ProbeResult("matmul_float32", 50.0, "GFLOP/s"),
    "copy_bw": ProbeResult("copy_bw", 12.5, "GB/s"),
    "dispatch_latency": ProbeResult("dispatch_latency", 3.0, "us"),
    "target_peak_float32": ProbeResult("target_peak_float32", 98500.0,
                                       "GFLOP/s"),  # echo entry: ignored
}


def test_from_probes_overrides_measured_constants():
    m = MachineModel.from_probes(PROBES, base=H100_SXM, name="cal")
    assert m.name == "cal"
    assert m.peak("float32") == pytest.approx(50e9)
    assert m.hbm_bw == pytest.approx(12.5e9)
    assert m.step_overhead_s == pytest.approx(3e-6)
    assert m.launch_overhead_s == pytest.approx(3e-6)
    # unprobed constants, legality among them, come from the base
    assert m.vmem_bytes == H100_SXM.vmem_bytes
    assert m.k_panel == H100_SXM.k_panel
    assert m.peak("bfloat16") == H100_SXM.peak("bfloat16")


def test_from_probes_partial_and_iterable():
    m = MachineModel.from_probes([ProbeResult("copy_bw", 100.0, "GB/s")])
    assert m.hbm_bw == pytest.approx(100e9)
    assert m.step_overhead_s == H100_SXM.step_overhead_s  # default base


def test_from_probes_matches_reference():
    """The same probes over TPU_V5E give the reference's constants."""
    from repro.core.machine import MachineModel as JMachineModel
    from repro.core.machine import TPU_V5E as J_TPU_V5E
    from repro.core.microbench import ProbeResult as JProbeResult
    probes = [JProbeResult(p.name, p.value, p.unit) for p in PROBES.values()]
    want = JMachineModel.from_probes(probes, base=J_TPU_V5E, name="cal")
    got = MachineModel.from_probes(PROBES, base=TPU_V5E, name="cal")
    assert got.peak_flops == want.peak_flops
    for f in ("hbm_bw", "step_overhead_s", "launch_overhead_s", "name"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.tuning_key == want.tuning_key == "cal"


def test_calibrated_overhead_feeds_cost_model():
    slow = dataclasses.replace(TPU_V5E, step_overhead_s=1e-3)
    d = GemmDescriptor(m=640, n=640, k=512)
    plan = plan_gemm(d, TPU_V5E)
    assert plan.predicted_seconds(slow) > plan.predicted_seconds(TPU_V5E)


def test_same_name_different_constants_plan_separately():
    """Two calibrations of one host share a name but not plans: the plan
    cache keys on the constants fingerprint, not the name alone."""
    m1 = MachineModel.from_probes(
        [ProbeResult("matmul_float32", 50.0, "GFLOP/s")], base=TPU_V5E)
    m2 = MachineModel.from_probes(
        [ProbeResult("matmul_float32", 500.0, "GFLOP/s")], base=TPU_V5E)
    assert m1.name == m2.name and m1.fingerprint != m2.fingerprint
    assert m1.tuning_key == m2.tuning_key  # measured winners survive drift
    d = GemmDescriptor(m=640, n=640, k=512)
    engine.plan_for(d, machine=m1)
    engine.plan_for(d, machine=m2)
    assert engine.stats()["gemm"]["planner_calls"] == 2
    engine.plan_for(d, machine=m1)
    assert engine.stats()["gemm"]["planner_calls"] == 2


def test_calibrate_smoke():
    from repro_torch.core.microbench import calibrate, characterize
    probes = characterize(size=64, mbytes=1)
    assert probes["matmul_float32"].value > 0
    assert probes["target_peak_bfloat16"].value == \
        pytest.approx(H100_SXM.peak("bfloat16") / 1e9)
    m = calibrate(size=64, mbytes=1)
    assert m.name == "calibrated_host"
    assert m.peak("float32") > 0 and m.hbm_bw > 0
    assert m.step_overhead_s > 0
    assert m.k_panel == H100_SXM.k_panel  # legality stays the base's


def test_calibrate_without_a_card_raises():
    from repro_torch.core.microbench import calibrate
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with use(device="cuda"), pytest.raises(RuntimeError, match="CUDA"):
        calibrate(size=64, mbytes=1)


# ---------------------------------------------------------------------------
# Candidate enumeration
# ---------------------------------------------------------------------------

def test_gemm_candidates_ranked_and_agree_with_planner():
    d = GemmDescriptor(m=300, n=500, k=128)
    cands = candidate_plans(d, TPU_V5E, top_k=6)
    assert 1 <= len(cands) <= 6
    times = [p.predicted_seconds(TPU_V5E) for p in cands]
    assert times == sorted(times)
    assert (cands[0].predicted_seconds(TPU_V5E)
            <= plan_gemm(d, TPU_V5E).predicted_seconds(TPU_V5E) * (1 + 1e-9))
    for p in cands:
        p.validate()
    knobs = [(p.regions, p.bk, p.fused) for p in cands]
    assert len(set(knobs)) == len(knobs)
    full = candidate_plans(d, TPU_V5E, top_k=256)
    assert any(p.fused for p in full) and any(not p.fused for p in full)


def test_flash_and_transpose_candidates():
    fd = FlashDescriptor(batch_heads=4, sq=256, sk=256, d=64)
    fc = candidate_plans(fd, TPU_V5E, top_k=4)
    assert fc[0].block_q == plan_flash(fd, TPU_V5E).block_q
    assert fc[0].block_k == plan_flash(fd, TPU_V5E).block_k
    td = TransposeDescriptor(rows=200, cols=300)
    tc = candidate_plans(td, TPU_V5E, top_k=3)
    assert tc[0].bt == plan_transpose(td, TPU_V5E).bt


def test_ssd_has_single_candidate():
    d = SsdChunkDescriptor(groups=4, q=64, n=32, p=64)
    cands = candidate_plans(d, TPU_V5E, top_k=8)
    assert len(cands) == 1
    assert cands[0] == plan_ssd(d, TPU_V5E)


def test_unknown_family_candidates_rejected():
    class FakeDesc:
        family = "conv"
    with pytest.raises(KeyError, match="candidate enumerator"):
        candidate_plans(FakeDesc())


SWEEP = [
    *(GemmDescriptor(m=m, n=n, k=k, in_dtype=dt, out_dtype=dt, layout=lay,
                     epilogue=epi)
      for m, n, k in ((300, 500, 128), (80, 80, 64), (1, 4096, 1024),
                      (8, 3072, 1024), (77, 1024, 96), (640, 640, 512))
      for dt in ("float32", "bfloat16")
      for lay, epi in (("nn", None), ("nt", "silu"))),
    GemmDescriptor(m=4, n=64, k=32, batch=3, accumulate=True,
                   epilogue="bias_gelu"),
    GemmDescriptor(m=64, n=128, k=256, quant=QuantSpec(dtype="int8")),
    GemmDescriptor(m=64, n=128, k=256, in_dtype="bfloat16",
                   quant=QuantSpec(dtype="int8", weight_only=True)),
    *(FlashDescriptor(batch_heads=4, sq=sq, sk=sk, d=64, causal=c)
      for sq, sk, c in ((256, 256, True), (100, 130, False),
                        (2048, 2048, True))),
    FlashBwdDescriptor(batch_heads=4, sq=256, sk=256, d=64, dtype="bfloat16"),
    FlashDecodeDescriptor(num_seqs=4, pages=64, page_size=16, max_blocks=8,
                          num_heads=4, num_kv_heads=2, head_dim=16),
    *(GroupedGemmDescriptor(t=t, k=k, n=n, num_experts=e, dtype=dt,
                            epilogue=epi)
      for t, k, n, e in ((512, 64, 128, 4), (4096, 4096, 6400, 16),
                         (37, 48, 80, 3))
      for dt, epi in (("float32", None), ("bfloat16", "silu"))),
    GroupedGemmBwdDescriptor(t=512, k=64, n=128, num_experts=4),
    *(SsdChunkDescriptor(groups=g, q=q, n=n, p=p, chunks=c)
      for g, q, n, p, c in ((4, 64, 32, 64, 0), (4, 64, 32, 64, 3),
                            (96, 256, 128, 64, 4))),
    SsdChunkBwdDescriptor(groups=4, q=64, n=32, p=64, chunks=3),
    *(TransposeDescriptor(rows=r, cols=c) for r, c in ((200, 300),
                                                      (4096, 4096),
                                                      (72, 136))),
]


def _ref_desc(desc):
    """The reference's descriptor of the same fields."""
    from repro.core import descriptor as jd
    return jd.descriptor_from_cache_key(desc.cache_key())


def _knobs(plan):
    d = dataclasses.asdict(plan)
    d.pop("desc")
    return d


@pytest.mark.parametrize("desc", SWEEP, ids=lambda d: d.family)
def test_tpu_v5e_candidates_equal_reference(desc):
    from repro.core.blocking import candidate_plans as j_candidate_plans
    from repro.core.machine import TPU_V5E as J_TPU_V5E
    for top_k in (1, 3, 8, 256):
        want = j_candidate_plans(_ref_desc(desc), J_TPU_V5E, top_k=top_k)
        got = candidate_plans(desc, TPU_V5E, top_k=top_k)
        assert [_knobs(p) for p in got] == [_knobs(p) for p in want]


def _executor_legal(plan):
    """What the CUDA executors check (kernels/*/ops.py and kernel.py)."""
    from repro_torch.kernels.gemm.kernel import K_PANEL, TEMPLATE_SHAPES
    from repro_torch.core.blocking import (grouped_smem_bytes,
                                           ssd_kernel_legal)
    from repro_torch.core.blocking import BlockingPlan, FlashPlan, \
        GroupedGemmPlan, SsdChunkPlan, TransposePlan
    if getattr(plan.desc, "quant", None) is not None and not plan.fused:
        return False  # the non-fused quant lowering runs no kernel
    if isinstance(plan, BlockingPlan):
        return plan.bk == K_PANEL and all(
            (r.bm, r.bn) in TEMPLATE_SHAPES for r in plan.regions)
    if isinstance(plan, FlashPlan):
        return (plan.block_q, plan.block_k) in H100_SXM.flash_blocks
    if isinstance(plan, GroupedGemmPlan):
        return (plan.bm, plan.bk, plan.bn) in H100_SXM.grouped_blocks and \
            grouped_smem_bytes(plan.bm, plan.bk, plan.bn) <= \
            H100_SXM.grouped_smem_bytes
    if isinstance(plan, TransposePlan):
        return plan.bt in H100_SXM.transpose_tiles
    if isinstance(plan, SsdChunkPlan):
        return ssd_kernel_legal(plan.desc, H100_SXM)
    return True


@pytest.mark.parametrize("desc", SWEEP, ids=lambda d: d.family)
def test_h100_candidates_are_executor_legal(desc):
    cands = candidate_plans(desc, H100_SXM, top_k=256)
    assert cands
    assert all(_executor_legal(p) for p in cands), \
        [p for p in cands if not _executor_legal(p)]
    if desc.family in ("gemm", "flash_attention", "grouped_gemm") \
            and getattr(desc, "quant", None) is None:
        # Both lowerings are candidates, so autotune can pick the region,
        # dense-grid and pad/scatter kernels the planner never selects.
        assert {p.fused for p in cands} == {True, False}


# ---------------------------------------------------------------------------
# Each family's H100 candidates on the CPU (and on the card)
# ---------------------------------------------------------------------------

def _family_cases(device, dtype):
    """(label, descriptor, operands, kw, plain result) per family, at
    small shapes on ``device``; the plain results are torch compositions
    in fp32."""
    from repro_torch.kernels.epilogue import apply_epilogue
    from repro_torch.kernels.flash_attention.ref import ref_flat
    from repro_torch.kernels.grouped_gemm.ref import ref_grouped_gemm
    from repro_torch.kernels.ssd_chunk.ref import ref_ssd_chunk_scan
    gen = torch.Generator(device="cpu").manual_seed(3)

    def r(*shape, dt=dtype, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device, dt)

    cases = []
    a, b = r(40, 96), r(300, 96, scale=0.1)
    cases.append(("gemm_nt", GemmDescriptor.from_operands(
        a, b, layout="nt", out_dtype=torch.float32), (a, b), {},
        a.float() @ b.float().T))
    a, b = r(8, 64), r(64, 200, scale=0.1)
    cases.append(("gemm_decode", GemmDescriptor.from_operands(
        a, b, out_dtype=torch.float32), (a, b), {}, a.float() @ b.float()))
    q, k, v = r(4, 100, 64), r(4, 100, 64), r(4, 100, 64)
    cases.append(("flash", FlashDescriptor(
        batch_heads=4, sq=100, sk=100, d=64,
        dtype=str(dtype).split(".")[1]), (q, k, v), {},
        ref_flat(True, q.float(), k.float(), v.float())))
    x, w = r(96, 64), r(4, 64, 128, scale=0.1)
    sizes = torch.tensor([30, 0, 50, 16], dtype=torch.int32, device=device)
    cases.append(("grouped", GroupedGemmDescriptor.from_operands(
        x, w, epilogue="silu"), (x, w, sizes), {},
        apply_epilogue(ref_grouped_gemm(x.float(), w.float(), sizes),
                       "silu")))
    g, nc, qq, n, p = 4, 3, 64, 128, 64
    c_, b_ = r(g, nc, qq, n, scale=0.3), r(g, nc, qq, n, scale=0.3)
    lmat = torch.tril(torch.rand((g, nc, qq, qq), generator=gen)).to(device)
    xdt = r(g, nc, qq, p, dt=torch.float32, scale=0.3)
    di = torch.rand((g, nc, qq), generator=gen).to(device)
    do = torch.rand((g, nc, qq), generator=gen).to(device)
    s0 = r(g, p, n, dt=torch.float32, scale=0.1)
    ops = (c_, b_, lmat, xdt, di, do, s0)
    cases.append(("ssd_scan", SsdChunkDescriptor.from_scan_operands(c_, xdt),
                  ops, {}, ref_ssd_chunk_scan(*(t.float() for t in ops))[0]))
    t = r(72, 136)
    cases.append(("transpose", TransposeDescriptor.from_operands(t), (t,), {},
                  t.float().T))
    return cases


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _check_all_candidates(device, dtype):
    tol = TOL[dtype]
    for label, desc, ops, kw, want in _family_cases(device, dtype):
        fam = engine.get_family(desc.family)
        cands = candidate_plans(desc, H100_SXM, top_k=256)
        assert cands, label
        for plan in cands:
            got = _first(fam.execute(desc, plan, *ops, **kw)).float()
            torch.testing.assert_close(got, want.to(got.device), atol=tol,
                                       rtol=tol, msg=f"{label} {plan}")


def test_h100_candidates_run_on_the_cpu():
    with use(machine=H100_SXM):
        _check_all_candidates(torch.device("cpu"), torch.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_h100_candidates_run_on_the_card(cuda_device):
    """Every H100 candidate of each family runs on its kernel on the card
    and agrees with the plain version; a search over them fails no
    candidate."""
    with use(machine=H100_SXM, device="cuda"):
        for dtype in (torch.bfloat16, torch.float32):
            _check_all_candidates(cuda_device, dtype)
        engine.reset_stats()
        with use(autotune=True, autotune_budget=8):
            for _, desc, ops, kw, _ in _family_cases(cuda_device,
                                                     torch.bfloat16):
                engine.dispatch(desc, *ops, **kw)
        st = engine.stats()
    assert sum(row["autotune_failures"] for row in st.values()) == 0
    assert sum(row["autotune_timings"] for row in st.values()) > 0


# ---------------------------------------------------------------------------
# search leaves its operands alone
# ---------------------------------------------------------------------------

def test_search_leaves_operands_unchanged():
    """Every family ``search`` times (gemm, flash, grouped, ssd_chunk,
    transpose): the operands after the search are bit-equal to copies taken
    before, and every timed family has more than one candidate."""
    for label, desc, ops, kw, _ in _family_cases(torch.device("cpu"),
                                                 torch.float32):
        before = [t.clone() for t in ops]
        fam = engine.get_family(desc.family)
        plan, timed = autotune.search(fam.execute, desc, H100_SXM, ops, kw,
                                      budget=8)
        assert plan is not None and timed >= 2, label
        for t, b in zip(ops, before):
            assert torch.equal(t, b), label
        log = autotune.TIMED[desc.cache_key()]
        assert len(log) == timed and all(s is not None for _, s in log)


# ---------------------------------------------------------------------------
# Plan <-> record round trips
# ---------------------------------------------------------------------------

ROUNDTRIP_CASES = [
    plan_gemm(GemmDescriptor(m=300, n=500, k=128), TPU_V5E),
    plan_flash(FlashDescriptor(batch_heads=4, sq=256, sk=128, d=64), TPU_V5E),
    plan_transpose(TransposeDescriptor(rows=100, cols=300), TPU_V5E),
    plan_ssd(SsdChunkDescriptor(groups=4, q=64, n=32, p=64), TPU_V5E),
    candidate_plans(GroupedGemmDescriptor(t=64, k=32, n=64, num_experts=4),
                    H100_SXM)[0],
]


@pytest.mark.parametrize("plan", ROUNDTRIP_CASES,
                         ids=lambda p: p.desc.family)
def test_plan_record_roundtrip(plan):
    record = autotune.plan_to_record(plan)
    assert json.loads(json.dumps(record)) == record
    back = autotune.plan_from_record(plan.desc, record)
    assert back is not None
    assert back.plan_source == "autotuned"
    assert dataclasses.replace(back, plan_source=plan.plan_source) == plan


@pytest.mark.parametrize("plan", ROUNDTRIP_CASES,
                         ids=lambda p: p.desc.family)
def test_plan_record_equals_reference(plan):
    """The port's record of a plan is the reference's record of the same
    plan, so both packages replay each other's winners."""
    from repro.core import autotune as j_autotune
    want_plan = j_autotune.plan_from_record(
        _ref_desc(plan.desc), autotune.plan_to_record(plan))
    assert want_plan is not None
    assert j_autotune.plan_to_record(want_plan) == \
        autotune.plan_to_record(plan)


def test_forced_fused_mode_filters_candidates(tmp_path):
    path = str(tmp_path / "tune.json")
    a, b = rand((48, 64)), rand((64, 80))
    with use(autotune=True, autotune_budget=6, tuning_cache=path,
             fused="off"):
        matmul(a, b)
    entries = json.load(open(path))["entries"]
    assert entries and all(rec["fused"] is False
                           for rec in entries.values())


def test_plan_from_record_degrades_to_none():
    d = GemmDescriptor(m=64, n=64, k=64)
    assert autotune.plan_from_record(d, {"family": "transpose", "bt": 64}) \
        is None
    assert autotune.plan_from_record(d, {"family": "gemm"}) is None
    assert autotune.plan_from_record(d, {}) is None
    rec = autotune.plan_to_record(plan_gemm(d))
    other = GemmDescriptor(m=64, n=64, k=64, in_dtype="bfloat16")
    assert autotune.plan_from_record(other, rec) is None  # dtype guard


# ---------------------------------------------------------------------------
# Tuning cache persistence
# ---------------------------------------------------------------------------

def test_tuning_cache_roundtrip(tmp_path):
    path = str(tmp_path / "tune.json")
    d = GemmDescriptor(m=80, n=80, k=64)
    plan = plan_gemm(d)
    cache = autotune.TuningCache(path)
    assert len(cache) == 0
    assert cache.lookup(H100_SXM.tuning_key, d, mode="cpu") is None
    cache.store(H100_SXM.tuning_key, d, plan, 123.4, mode="cpu")
    reread = autotune.TuningCache(path)
    record = reread.lookup(H100_SXM.tuning_key, d, mode="cpu")
    assert record is not None and record["us"] == pytest.approx(123.4)
    rebuilt = autotune.plan_from_record(d, record)
    assert rebuilt.regions == plan.regions and rebuilt.bk == plan.bk
    # keyed by machine and by device: a CPU-timed winner never serves the
    # card
    assert reread.lookup(TPU_V5E.tuning_key, d, mode="cpu") is None
    assert reread.lookup(H100_SXM.tuning_key, d, mode="cuda") is None


def test_tuning_cache_corrupt_file_degrades(tmp_path):
    path = tmp_path / "tune.json"
    path.write_text("{not json")
    with pytest.warns(UserWarning, match="corrupt tuning cache"):
        cache = autotune.TuningCache(str(path))
    assert len(cache) == 0
    d = GemmDescriptor(m=80, n=80, k=64)
    cache.store(H100_SXM.tuning_key, d, plan_gemm(d), 1.0, mode="cpu")
    assert len(autotune.TuningCache(str(path))) == 1


def test_tuning_cache_wrong_schema_degrades(tmp_path):
    path = tmp_path / "tune.json"
    path.write_text(json.dumps([1, 2, 3]))
    with pytest.warns(UserWarning, match="corrupt tuning cache"):
        assert len(autotune.TuningCache(str(path))) == 0


def _load_tune_cli():
    spec = importlib.util.spec_from_file_location(
        "tune_cli", os.path.join(os.path.dirname(__file__), os.pardir,
                                 "tools", "tune.py"))
    tune = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tune)
    return tune


def test_port_cache_read_by_reference_and_merged(tmp_path):
    """A cache the port's autotuner wrote is the reference's format: its
    ``TuningCache`` loads every entry, its refit parser rebuilds every plan
    with the port's knobs, and ``tools/tune.py merge`` unions it with a
    second port cache."""
    from repro.core.autotune import TuningCache as JTuningCache
    from repro.core.refit import parse_entry as j_parse_entry
    from repro_torch.kernels.transpose import transpose
    one, two = str(tmp_path / "one.json"), str(tmp_path / "two.json")
    with use(autotune=True, autotune_budget=3, tuning_cache=one):
        matmul(rand((80, 64)), rand((64, 80)))
        transpose(rand((72, 136)))
    with use(autotune=True, autotune_budget=3, tuning_cache=two):
        matmul(rand((56, 48)), rand((48, 88)))
    entries = json.load(open(one))["entries"]
    assert len(JTuningCache(one)) == len(entries) == 2
    for key, rec in entries.items():
        machine_key, mode, jplan = j_parse_entry(key, rec)
        assert (machine_key, mode) == (H100_SXM.tuning_key, "cpu")
        plan = autotune.plan_from_record(
            descriptor_from_cache_key(jplan.desc.cache_key()), rec)
        assert _knobs(plan) == _knobs(jplan)
    merged = str(tmp_path / "merged.json")
    tune = _load_tune_cli()
    assert tune.main(["merge", merged, one, two]) == 0
    assert len(JTuningCache(merged)) == 3
    assert len(autotune.TuningCache(merged)) == 3


# ---------------------------------------------------------------------------
# Three-tier dispatch
# ---------------------------------------------------------------------------

def _gemm_operands(m=80, n=80, k=64):
    return rand((m, k)), rand((k, n))


def test_tier_model_default():
    a, b = _gemm_operands()
    matmul(a, b)
    s = engine.stats()["gemm"]
    assert s["plan_source_model"] == 1
    assert s["plan_source_autotuned"] == 0
    assert s["plan_source_tuned_cache"] == 0
    assert s["autotune_timings"] == 0
    assert engine.plan_for(GemmDescriptor(m=80, n=80, k=64)
                           ).plan_source == "model"


def test_tier_autotune_then_tuned_cache_warm_start(tmp_path):
    path = str(tmp_path / "tune.json")
    a, b = _gemm_operands()
    ref = a @ b
    with use(autotune=True, tuning_cache=path, autotune_budget=3):
        out = matmul(a, b)
        out2 = matmul(a, b)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(out2, ref, atol=1e-4, rtol=1e-4)
    s = engine.stats()["gemm"]
    assert s["plan_source_autotuned"] == 1
    assert s["plan_source_tuned_cache"] == 0
    assert 0 < s["autotune_timings"] <= 3
    assert s["autotune_failures"] == 0
    data = json.load(open(path))
    assert data["version"] == autotune.TUNING_CACHE_VERSION
    assert len(data["entries"]) == 1
    (key, record), = data["entries"].items()
    assert key.startswith("h100_sxm|cpu|('gemm',")
    assert record["family"] == "gemm" and record["us"] > 0

    engine.reset_stats()  # a restart: the file stays
    with use(autotune=True, tuning_cache=path, autotune_budget=3):
        out3 = matmul(a, b)
    torch.testing.assert_close(out3, ref, atol=1e-4, rtol=1e-4)
    s = engine.stats()["gemm"]
    assert s["plan_source_tuned_cache"] == 1
    assert s["plan_source_autotuned"] == 0
    assert s["autotune_timings"] == 0


def test_tier_order_tuned_cache_preempts_autotune(tmp_path):
    path = str(tmp_path / "tune.json")
    d = GemmDescriptor(m=80, n=80, k=64)
    pinned = plan_gemm(d, force_block=(16, 64), heterogeneous=False)
    autotune.TuningCache(path).store(H100_SXM.tuning_key, d, pinned, 1.0,
                                     mode="cpu")
    engine.reset_stats()
    a, b = _gemm_operands()
    with use(autotune=True, tuning_cache=path):
        matmul(a, b)
    s = engine.stats()["gemm"]
    assert s["plan_source_tuned_cache"] == 1 and s["autotune_timings"] == 0
    with use(autotune=True, tuning_cache=path):
        plan = engine.plan_for(d)
    assert plan.plan_source == "autotuned"
    assert plan.regions == pinned.regions


def test_preload_serves_after_the_writable_cache(tmp_path):
    """The read-only preload serves what the writable cache lacks and is
    never written."""
    pre, own = str(tmp_path / "fleet.json"), str(tmp_path / "own.json")
    d = GemmDescriptor(m=80, n=80, k=64)
    autotune.TuningCache(pre).store(
        H100_SXM.tuning_key, d,
        plan_gemm(d, force_block=(16, 64), heterogeneous=False), 1.0,
        mode="cpu")
    before = open(pre).read()
    engine.reset_stats()
    a, b = _gemm_operands()
    with use(autotune=True, tuning_cache=own, tuning_cache_preload=pre):
        matmul(a, b)
        matmul(rand((56, 48)), rand((48, 88)))  # autotuned into ``own``
    s = engine.stats()["gemm"]
    assert s["plan_source_tuned_cache"] == 1
    assert s["plan_source_autotuned"] == 1
    assert open(pre).read() == before
    assert len(json.load(open(own))["entries"]) == 1


def test_corrupt_cache_falls_back_to_model(tmp_path):
    path = tmp_path / "tune.json"
    path.write_text("][ definitely not json")
    a, b = _gemm_operands()
    with pytest.warns(UserWarning, match="corrupt tuning cache"):
        with use(tuning_cache=str(path)):
            out = matmul(a, b)
    torch.testing.assert_close(out, a @ b, atol=1e-4, rtol=1e-4)
    s = engine.stats()["gemm"]
    assert s["plan_source_model"] == 1 and s["plan_source_tuned_cache"] == 0


def test_autotuned_winner_overwrites_a_model_plan(tmp_path):
    """A resolution without operands (``plan_for``) before the cache holds
    a winner caches a model plan on the tuned tier's key; a later search
    replaces it there, rather than leaving it served."""
    path = str(tmp_path / "tune.json")
    a, b = _gemm_operands()
    d = GemmDescriptor(m=80, n=80, k=64)
    with use(autotune=True, tuning_cache=path, autotune_budget=3):
        assert engine.plan_for(d).plan_source == "model"
        matmul(a, b)
        assert engine.plan_for(d).plan_source == "autotuned"


def test_env_budget_malformed_falls_back(monkeypatch):
    from repro_torch.core import config
    monkeypatch.setenv("REPRO_AUTOTUNE_BUDGET", "abc")
    with pytest.warns(UserWarning, match="REPRO_AUTOTUNE_BUDGET"):
        assert config._env_default().autotune_budget == 8
    monkeypatch.setenv("REPRO_AUTOTUNE_BUDGET", "0")
    with pytest.warns(UserWarning, match="REPRO_AUTOTUNE_BUDGET"):
        assert config._env_default().autotune_budget == 8
    monkeypatch.setenv("REPRO_AUTOTUNE_BUDGET", "5")
    assert config._env_default().autotune_budget == 5


def test_env_seeds_the_tuning_settings(monkeypatch, tmp_path):
    from repro_torch.core import config
    for var, val in (("REPRO_AUTOTUNE", "1"),
                     ("REPRO_TUNING_CACHE", str(tmp_path / "a.json")),
                     ("REPRO_TUNING_CACHE_PRELOAD", str(tmp_path / "b.json")),
                     ("REPRO_WARM_START", str(tmp_path / "m.json"))):
        monkeypatch.setenv(var, val)
    cfg = config._env_default()
    assert cfg.autotune
    assert cfg.tuning_cache.endswith("a.json")
    assert cfg.tuning_cache_preload.endswith("b.json")
    assert cfg.warm_start.endswith("m.json")
    with use(tuning_cache="", warm_start=""):
        assert not config.get_config().tuning_cache
    with pytest.raises(ValueError, match="autotune_budget"):
        config.EngineConfig(autotune_budget=0)


def test_search_short_circuits_single_candidate():
    d = SsdChunkDescriptor(groups=2, q=32, n=16, p=32)
    executed = []
    plan, timed = autotune.search(
        lambda *a, **k: executed.append(1), d, H100_SXM, (), {}, budget=8)
    assert plan is None and timed == 0 and not executed


def test_meta_operands_skip_the_search(tmp_path):
    """Operands without data (meta tensors) cannot be timed: the tier is
    not taken."""
    assert not autotune.can_autotune((torch.empty(4, device="meta"),), {})
    assert autotune.can_autotune((torch.empty(4),), {"bias": None})


def test_failing_candidate_is_counted(tmp_path, monkeypatch):
    """A candidate that raises is skipped with a warning and counted as
    ``autotune_failures``; the search still picks among the others."""
    from repro_torch.kernels.gemm import ops as gemm_ops
    real = gemm_ops.execute
    calls = []

    def flaky(desc, plan, *a, **kw):
        if not plan.fused:
            raise RuntimeError("synthetic launch failure")
        calls.append(1)
        return real(desc, plan, *a, **kw)

    fam = engine.get_family("gemm")
    monkeypatch.setitem(engine._REGISTRY, "gemm",
                        dataclasses.replace(fam, execute=flaky))
    a, b = _gemm_operands()
    with use(autotune=True, tuning_cache=str(tmp_path / "t.json"),
             autotune_budget=8):
        with pytest.warns(UserWarning, match="autotune candidate failed"):
            matmul(a, b)
        winner = engine.plan_for(GemmDescriptor(m=80, n=80, k=64))
    s = engine.stats()["gemm"]
    assert s["autotune_failures"] > 0
    assert s["plan_source_autotuned"] == 1
    assert winner.plan_source == "autotuned" and winner.fused


def test_autotune_other_families(tmp_path):
    path = str(tmp_path / "tune.json")
    from repro_torch.kernels.transpose import transpose
    x = rand((72, 136))
    with use(autotune=True, tuning_cache=path, autotune_budget=2):
        out = transpose(x)
    torch.testing.assert_close(out, x.T)
    s = engine.stats()["transpose"]
    assert s["plan_source_autotuned"] == 1 and s["autotune_timings"] > 0
    engine.reset_stats()
    with use(autotune=True, tuning_cache=path):
        transpose(x)
    s = engine.stats()["transpose"]
    assert s["plan_source_tuned_cache"] == 1 and s["autotune_timings"] == 0


def test_reset_stats_keeps_entries_for_phase_boundaries():
    a, b = _gemm_operands()
    with use(fused="on"):
        matmul(a, b)
    kernels_built = len(GLOBAL_KERNEL_CACHE)
    assert kernels_built > 0
    engine.reset_stats(entries=False)
    s = engine.stats()
    assert all(v == 0 for fam in s.values() for v in fam.values())
    with use(fused="on"):
        matmul(a, b)
    s = engine.stats()["gemm"]
    assert s["plan_hits"] == 1 and s["plan_misses"] == 0
    assert s["kernel_misses"] == 0 and s["kernel_hits"] >= 1
    assert len(GLOBAL_KERNEL_CACHE) == kernels_built


# ---------------------------------------------------------------------------
# matmul(plan=, backend_override=) and gemm(edge="pad")
# ---------------------------------------------------------------------------

def test_matmul_plan_and_backend_override():
    a, b = rand((3, 20, 40)), rand((40, 70))
    plan = plan_gemm(GemmDescriptor(m=60, n=70, k=40), force_block=(16, 64),
                     heterogeneous=False)
    engine.reset_stats()
    out = matmul(a, b, plan=plan)
    torch.testing.assert_close(out, a @ b, atol=1e-4, rtol=1e-4)
    s = engine.stats()["gemm"]
    assert s["plan_misses"] == 0 and s["launches"] == 1
    with use(backend="engine"):
        torch.testing.assert_close(matmul(a, b, backend_override="torch"),
                                   a @ b, atol=1e-4, rtol=1e-4)
    assert engine.stats()["gemm"]["launches"] == 1  # the override ran torch


@pytest.mark.parametrize("layout,epilogue,accumulate", [
    ("nn", None, False), ("nt", "bias_silu", True)])
def test_gemm_pad_edge_matches_reference(layout, epilogue, accumulate):
    """``edge="pad"`` on the multi-launch lowering pads each region to
    whole blocks and runs the region kernel on the padded shape: equal to
    the reference's Pallas padded GEMM under the same TPU_V5E plan, and
    to the masked lowering under H100_SXM (atol = rtol = 1e-4, fp32)."""
    import jax.numpy as jnp

    import repro.core as jcore
    from repro.kernels.gemm import gemm as j_gemm
    from repro_torch.kernels.gemm import gemm
    m, n, k = 77, 130, 96
    rng = np.random.default_rng(5)
    arrs = [rng.standard_normal((m, k)),
            rng.standard_normal((k, n) if layout == "nn" else (n, k)) / 10,
            rng.standard_normal(n) if epilogue else None,
            rng.standard_normal((m, n)) if accumulate else None]
    j = [None if x is None else jnp.asarray(x, jnp.float32) for x in arrs]
    t = [None if x is None else torch.tensor(x, dtype=torch.float32)
         for x in arrs]
    with jcore.use(backend="pallas"):
        want = j_gemm(j[0], j[1], j[3], layout=layout, epilogue=epilogue,
                      bias=j[2], edge="pad", fused=False)
    with use(machine="tpu_v5e"):
        got = gemm(t[0], t[1], t[3], layout=layout, epilogue=epilogue,
                   bias=t[2], edge="pad", fused=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    with use(machine=H100_SXM):
        pad = gemm(t[0], t[1], t[3], layout=layout, epilogue=epilogue,
                   bias=t[2], edge="pad", fused=False)
        mask = gemm(t[0], t[1], t[3], layout=layout, epilogue=epilogue,
                    bias=t[2], fused=False)
    torch.testing.assert_close(pad, mask, atol=1e-4, rtol=1e-4)
