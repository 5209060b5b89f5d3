"""The port's mesh planning against the reference's, case by case as
tests/test_mesh_planning.py runs them before its eight-device test.

Under ``TPU_V5E`` every mesh plan, cache key, local descriptor,
communication event, comm-charged prediction, candidate list and tuning
key must equal the reference's; ``H100_SXM`` adds the port's own network
figures (NVLink 4).  Nothing here needs more than one process: the
execution across ranks is tests/test_torch_mesh_exec.py's.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import autotune as j_autotune
from repro.core.machine import CPU_HOST as J_CPU_HOST
from repro.core.machine import TPU_V5E as J_TPU_V5E

from repro_torch.core import (H100_SXM, MESH_STRATEGIES, TPU_V5E,
                              GemmDescriptor, GroupedGemmDescriptor,
                              MeshSpec, autotune, candidate_plans, engine,
                              matmul, mesh_comm_events, mesh_comm_seconds,
                              mesh_local_desc, plan_gemm, plan_grouped, use)
from repro_torch.core.machine import MachineModel
from repro_torch.core.microbench import (probe_all_gather, probe_all_to_all,
                                         probe_collective_latency, probe_psum)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(11)


@pytest.fixture(autouse=True)
def fresh_engine():
    engine.reset_stats()
    yield
    engine.reset_stats()


def _j(desc):
    """The reference's descriptor of the same fields."""
    return jcore.descriptor.descriptor_from_cache_key(desc.cache_key())


def _grouped_desc(nt, e, cap, k, n, s):
    return GroupedGemmDescriptor(t=nt * e * cap, k=k, n=n, num_experts=e,
                                 mesh=MeshSpec("model", s))


def _knobs(plan):
    """Every field of a plan but its descriptor (the reference's and the
    port's dataclasses carry the same ones)."""
    d = dataclasses.asdict(plan)
    d.pop("desc")
    return d


# The mesh descriptors of the reference's tests, plus dtype and epilogue
# variants.
GROUPED = [(8, 8, 16, 512, 512, 8), (64, 8, 64, 64, 64, 8),
           (64, 8, 16, 256, 256, 2), (16, 8, 16, 256, 256, 8),
           (8, 8, 16, 256, 256, 8), (8, 8, 16, 64, 96, 8),
           (32, 16, 8, 4096, 6400, 2), (4, 16, 8, 4096, 6400, 2)]
GEMMS = [dict(m=8, n=1024, k=4096), dict(m=4096, n=1024, k=8),
         dict(m=64, n=256, k=32), dict(m=640, n=640, k=512),
         dict(m=300, n=512, k=128, in_dtype="bfloat16",
              out_dtype="bfloat16", epilogue="silu")]


# ---------------------------------------------------------------------------
# MeshSpec: validation and cache keys
# ---------------------------------------------------------------------------

def test_meshspec_validates():
    for spec in (MeshSpec, jcore.MeshSpec):
        with pytest.raises(ValueError):
            spec(axis="", size=2)
        with pytest.raises(ValueError):
            spec(axis="model", size=0)
    assert MeshSpec() == MeshSpec("model", 1)
    assert dataclasses.astuple(MeshSpec()) == \
        dataclasses.astuple(jcore.MeshSpec())


@pytest.mark.parametrize("make", [
    lambda m: m.GemmDescriptor(m=8, n=100, k=8, mesh=m.MeshSpec("model", 8)),
    lambda m: m.GroupedGemmDescriptor(t=64, k=8, n=8, num_experts=6,
                                      mesh=m.MeshSpec("model", 4)),
    lambda m: m.GroupedGemmDescriptor(t=66, k=8, n=8, num_experts=8,
                                      mesh=m.MeshSpec("model", 4)),
])
def test_descriptor_mesh_divisibility(make):
    import repro_torch.core as tcore
    for pkg in (tcore, jcore):
        with pytest.raises(ValueError, match="mesh size"):
            make(pkg)


def test_mesh_participates_in_cache_key():
    base = GroupedGemmDescriptor(t=64, k=8, n=8, num_experts=8)
    m4 = dataclasses.replace(base, mesh=MeshSpec("model", 4))
    m8 = dataclasses.replace(base, mesh=MeshSpec("model", 8))
    keys = {base.cache_key(), m4.cache_key(), m8.cache_key()}
    assert len(keys) == 3, "mesh must key plans and kernels"
    for d in (base, m4, m8, GemmDescriptor(m=8, n=64, k=8,
                                           mesh=MeshSpec("data", 2))):
        jd = _j(d)
        assert jd.cache_key() == d.cache_key()
        assert (jd.flops, jd.in_bytes, jd.out_bytes) == \
            (d.flops, d.in_bytes, d.out_bytes)


def test_backward_descriptor_drops_the_mesh():
    from repro_torch.core.descriptor import GroupedGemmBwdDescriptor
    d = _grouped_desc(8, 8, 16, 64, 96, 8)
    bd = GroupedGemmBwdDescriptor.from_forward(d)
    assert bd.mesh is None and bd.t == d.t
    j_bd = jcore.descriptor.GroupedGemmBwdDescriptor.from_forward(_j(d))
    assert bd.cache_key() == j_bd.cache_key()


# ---------------------------------------------------------------------------
# Local descriptors and communication events
# ---------------------------------------------------------------------------

def test_mesh_local_desc_grouped():
    d = GroupedGemmDescriptor(t=1024, k=64, n=32, num_experts=8,
                              mesh=MeshSpec("model", 4))
    g = mesh_local_desc(d, "gathered")
    assert (g.t, g.num_experts, g.mesh) == (256, 8, None)
    dd = mesh_local_desc(d, "distributed")
    assert (dd.t, dd.num_experts, dd.mesh) == (256, 2, None)
    with pytest.raises(ValueError):
        mesh_local_desc(d, "telepathy")
    for comm in MESH_STRATEGIES:
        assert mesh_local_desc(d, comm).cache_key() == \
            jcore.mesh_local_desc(_j(d), comm).cache_key()


def test_mesh_local_desc_gemm():
    d = GemmDescriptor(m=64, n=256, k=32, mesh=MeshSpec("model", 4))
    assert mesh_local_desc(d, "gathered").n == 256
    assert mesh_local_desc(d, "distributed").n == 64
    assert mesh_local_desc(d, "gathered").mesh is None
    for comm in MESH_STRATEGIES:
        assert mesh_local_desc(d, comm).cache_key() == \
            jcore.mesh_local_desc(_j(d), comm).cache_key()


def test_mesh_comm_events_bytes():
    s, e, t, k, n = 4, 8, 1024, 64, 32
    d = GroupedGemmDescriptor(t=t, k=k, n=n, num_experts=e,
                              mesh=MeshSpec("model", s))
    frac = (s - 1) / s
    (cg, bg), = mesh_comm_events(d, "gathered")
    assert cg == "all_gather" and bg == int(frac * e * k * n * 4)
    ev = mesh_comm_events(d, "distributed")
    assert [c for c, _ in ev] == ["all_to_all", "all_to_all"]
    assert ev[0][1] == int(frac * (t // s) * k * 4)
    assert ev[1][1] == int(frac * (t // s) * n * 4)
    d1 = dataclasses.replace(d, mesh=MeshSpec("model", 1))
    assert mesh_comm_events(d1, "gathered") == ()


@pytest.mark.parametrize("case", GROUPED + [None], ids=str)
def test_comm_events_and_seconds_equal_reference(case):
    descs = [_grouped_desc(*case)] if case else [
        GemmDescriptor(mesh=MeshSpec("model", 8), **kw) for kw in GEMMS[:2]]
    for d in descs:
        for comm in MESH_STRATEGIES:
            assert mesh_comm_events(d, comm) == \
                jcore.mesh_comm_events(_j(d), comm)
            assert mesh_comm_seconds(d, TPU_V5E, comm) == \
                jcore.mesh_comm_seconds(_j(d), J_TPU_V5E, comm)


# ---------------------------------------------------------------------------
# Calibrated network model and provenance
# ---------------------------------------------------------------------------

def test_collective_seconds_uses_calibration():
    kw = dict(ici_bandwidth_gbps=100.0, collective_launch_s=2e-6,
              collective_efficiency={"all_gather": 1.0, "all_to_all": 0.5})
    cal = dataclasses.replace(TPU_V5E, **kw)
    j_cal = dataclasses.replace(J_TPU_V5E, **kw)
    nbytes = 1e8
    ag = cal.collective_seconds(nbytes, collective="all_gather")
    assert ag == pytest.approx(2e-6 + nbytes / 100e9)
    a2a = cal.collective_seconds(nbytes, collective="all_to_all")
    assert a2a == pytest.approx(2e-6 + nbytes / 50e9)
    un = TPU_V5E.collective_seconds(nbytes)
    assert un > 0 and TPU_V5E.network_calibrated is False
    for c in ("all_gather", "all_to_all", "psum"):
        for chips in (1, 4):
            assert cal.collective_seconds(nbytes, chips, c) == \
                j_cal.collective_seconds(nbytes, chips, c)
            assert TPU_V5E.collective_seconds(nbytes, chips, c) == \
                J_TPU_V5E.collective_seconds(nbytes, chips, c)


def test_h100_network_is_nvlink4():
    """NVIDIA's H100 SXM5 data sheet: 18 NVLink 4 links, 900 GB/s."""
    assert H100_SXM.ici_links == 18
    assert H100_SXM.ici_links * H100_SXM.ici_bw_per_link == 900e9
    assert not H100_SXM.network_calibrated
    assert H100_SXM.collective_seconds(50e9) == pytest.approx(
        1.0 + H100_SXM.launch_overhead_s)
    assert (TPU_V5E.ici_bw_per_link, TPU_V5E.ici_links) == \
        (J_TPU_V5E.ici_bw_per_link, J_TPU_V5E.ici_links)


@pytest.mark.parametrize("machine", [TPU_V5E, H100_SXM], ids=lambda m: m.name)
def test_net_provenance_in_fingerprint_and_tuning_key(machine):
    cal = dataclasses.replace(machine, ici_bandwidth_gbps=10.0)
    assert cal.fingerprint.endswith("+net")
    assert cal.tuning_key == machine.name + "+net"
    assert not machine.fingerprint.endswith("+net")
    assert machine.tuning_key == machine.name
    both = dataclasses.replace(cal, refit_fingerprint="abc")
    assert both.tuning_key == machine.name + "+net+refit"
    j_cal = dataclasses.replace(J_CPU_HOST, name=machine.name,
                                ici_bandwidth_gbps=10.0,
                                refit_fingerprint="abc")
    assert both.tuning_key == j_cal.tuning_key


def test_one_device_probes_report_uncalibrated():
    """Without a process group of two ranks every collective probe returns
    an explicit 0 "(uncalibrated)", and ``from_probes`` leaves the network
    fields None; ``characterize`` always lists them."""
    import torch.distributed as dist
    assert not (dist.is_available() and dist.is_initialized())
    probes = {p.name: p for p in (probe_all_gather(), probe_all_to_all(),
                                  probe_psum(), probe_collective_latency())}
    assert set(probes) == {"all_gather_bw", "all_to_all_bw", "psum_bw",
                           "collective_latency"}
    for p in probes.values():
        assert p.value == 0.0 and "uncalibrated" in p.unit
    m = MachineModel.from_probes(probes, base=TPU_V5E, name="one_dev")
    assert m.ici_bandwidth_gbps is None and not m.network_calibrated
    assert m.tuning_key == "one_dev"


def test_from_probes_folds_the_network_like_the_reference():
    from repro.core.microbench import ProbeResult as JProbe
    from repro_torch.core.microbench import ProbeResult
    vals = [("all_gather_bw", 40.0, "GB/s"), ("all_to_all_bw", 20.0, "GB/s"),
            ("psum_bw", 10.0, "GB/s"), ("collective_latency", 12.0, "us"),
            ("dispatch_latency", 3.0, "us")]
    m = MachineModel.from_probes([ProbeResult(*v) for v in vals],
                                 base=TPU_V5E, name="cal")
    jm = jcore.MachineModel.from_probes([JProbe(*v) for v in vals],
                                        base=J_TPU_V5E, name="cal")
    for f in ("ici_bandwidth_gbps", "collective_launch_s",
              "collective_efficiency", "step_overhead_s",
              "launch_overhead_s"):
        assert getattr(m, f) == getattr(jm, f), f
    assert m.tuning_key == jm.tuning_key == "cal+net"
    # without a latency probe the launch cost is the dispatch latency
    m2 = MachineModel.from_probes([ProbeResult(*vals[0]),
                                   ProbeResult(*vals[-1])], base=TPU_V5E)
    assert m2.collective_launch_s == 3e-6
    assert m2.collective_efficiency == {"all_gather": 1.0}


# ---------------------------------------------------------------------------
# Comm-charged arbitration
# ---------------------------------------------------------------------------

def test_arbitration_flips_with_config():
    heavy_w = _grouped_desc(8, 8, 16, 512, 512, 8)
    assert plan_grouped(heavy_w, TPU_V5E).comm == "distributed"
    heavy_t = _grouped_desc(64, 8, 64, 64, 64, 8)
    assert plan_grouped(heavy_t, TPU_V5E).comm == "gathered"


def test_arbitration_flips_with_mesh_size():
    small = _grouped_desc(64, 8, 16, 256, 256, 2)
    large = _grouped_desc(16, 8, 16, 256, 256, 8)
    assert plan_grouped(small, TPU_V5E).comm == "gathered"
    assert plan_grouped(large, TPU_V5E).comm == "distributed"


@pytest.mark.parametrize("case", GROUPED, ids=str)
def test_grouped_mesh_plans_equal_reference(case):
    d = _grouped_desc(*case)
    plan, jplan = plan_grouped(d, TPU_V5E), jcore.plan_grouped(_j(d))
    assert _knobs(plan) == _knobs(jplan)
    assert plan.predicted_seconds(TPU_V5E) == \
        jplan.predicted_seconds(J_TPU_V5E)
    sched, jsched = plan.tile_schedule(), jplan.tile_schedule()
    assert (sched.t, sched.num_experts, sched.bm, sched.bk, sched.bn) == \
        (jsched.t, jsched.num_experts, jsched.bm, jsched.bk, jsched.bn)
    assert plan.local_desc.cache_key() == jplan.local_desc.cache_key()
    # the mesh-free problem still plans exactly as the reference's
    free = dataclasses.replace(d, mesh=None)
    assert _knobs(plan_grouped(free, TPU_V5E)) == \
        _knobs(jcore.plan_grouped(_j(free)))


def test_plan_charges_comm_seconds():
    d = _grouped_desc(8, 8, 16, 256, 256, 8)
    for machine in (TPU_V5E, H100_SXM):
        for comm in MESH_STRATEGIES:
            local = plan_grouped(mesh_local_desc(d, comm), machine)
            pin = dataclasses.replace(local, desc=d, comm=comm)
            assert pin.predicted_seconds(machine) == pytest.approx(
                local.predicted_seconds(machine)
                + mesh_comm_seconds(d, machine, comm))


def test_candidate_plans_mesh_strategies():
    d = _grouped_desc(8, 8, 16, 256, 256, 8)
    cands = candidate_plans(d, TPU_V5E)
    assert {p.comm for p in cands} == set(MESH_STRATEGIES)
    assert len(cands) == 2
    best = min(cands, key=lambda p: p.predicted_seconds(TPU_V5E))
    assert best.comm == plan_grouped(d, TPU_V5E).comm


@pytest.mark.parametrize("case", GROUPED[:4] + GEMMS[:2], ids=str)
def test_candidate_plans_equal_reference(case):
    d = _grouped_desc(*case) if isinstance(case, tuple) else \
        GemmDescriptor(mesh=MeshSpec("model", 8), **case)
    for top_k in (1, 2, 8):
        got = candidate_plans(d, TPU_V5E, top_k=top_k)
        want = jcore.candidate_plans(_j(d), J_TPU_V5E, top_k=top_k)
        assert [_knobs(p) for p in got] == [_knobs(p) for p in want]


def test_gemm_mesh_arbitration():
    tall = GemmDescriptor(m=8, n=1024, k=4096, mesh=MeshSpec("model", 8))
    fat = GemmDescriptor(m=4096, n=1024, k=8, mesh=MeshSpec("model", 8))
    pt, pf = plan_gemm(tall, TPU_V5E), plan_gemm(fat, TPU_V5E)
    assert pt.comm == "distributed" and pf.comm == "gathered"


@pytest.mark.parametrize("kw", GEMMS, ids=str)
def test_gemm_mesh_plans_equal_reference(kw):
    for s in (2, 8):
        d = GemmDescriptor(mesh=MeshSpec("model", s), **kw)
        plan, jplan = plan_gemm(d, TPU_V5E), jcore.plan_gemm(_j(d))
        assert _knobs(plan) == _knobs(jplan)
        assert plan.predicted_seconds(TPU_V5E) == \
            jplan.predicted_seconds(J_TPU_V5E)
        assert [list(t) for t in plan.tile_schedule().tiles] == \
            np.asarray(jplan.tile_schedule().tiles).tolist()


def test_h100_mesh_plans_run_on_kernels():
    """Under the port's machine both strategies plan the tilings its
    grouped kernel instantiates, fused, on the per-rank problem."""
    for case in GROUPED[-2:]:
        d = _grouped_desc(*case)
        for p in candidate_plans(d, H100_SXM):
            assert p.fused and (p.bm, p.bk, p.bn) in H100_SXM.grouped_blocks
            assert p.tile_schedule().t == p.local_desc.t


# ---------------------------------------------------------------------------
# Fused-ranking regressions
# ---------------------------------------------------------------------------

def test_multi_region_plans_rank_fused_vs_multi():
    hetero = plan_gemm(GemmDescriptor(m=640, n=640, k=512), TPU_V5E,
                       force_block=(256, 256))
    assert len(hetero.regions) > 1 and hetero.fused is False
    multi = dataclasses.replace(hetero, fused=True)
    assert hetero.predicted_seconds(TPU_V5E) < \
        multi.predicted_seconds(TPU_V5E)
    single = plan_gemm(GemmDescriptor(m=80, n=80, k=512), TPU_V5E)
    assert len(single.regions) == 1 and single.fused is True


# ---------------------------------------------------------------------------
# Plan records, the tuning cache, warm start, refit and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", GROUPED[:3] + GEMMS[:2], ids=str)
def test_plan_record_roundtrips_comm(case):
    d = _grouped_desc(*case) if isinstance(case, tuple) else \
        GemmDescriptor(mesh=MeshSpec("model", 8), **case)
    planner = plan_grouped if isinstance(case, tuple) else plan_gemm
    plan = planner(d, TPU_V5E)
    assert plan.comm in MESH_STRATEGIES
    rec = autotune.plan_to_record(plan)
    assert rec["comm"] == plan.comm
    assert rec == j_autotune.plan_to_record(
        (jcore.plan_grouped if isinstance(case, tuple)
         else jcore.plan_gemm)(_j(d)))
    back = autotune.plan_from_record(d, rec)
    assert back.comm == plan.comm and back.plan_source == "autotuned"
    assert _knobs(dataclasses.replace(back, plan_source="model")) == \
        _knobs(plan)
    jback = j_autotune.plan_from_record(_j(d), rec)
    assert _knobs(jback) == _knobs(back)


def test_tuning_cache_keeps_comm_under_net_keys(tmp_path):
    path = str(tmp_path / "tc.json")
    d = _grouped_desc(8, 8, 16, 256, 256, 8)
    pin = dataclasses.replace(
        plan_grouped(mesh_local_desc(d, "gathered"), TPU_V5E), desc=d,
        comm="gathered", plan_source="autotuned")
    cal = dataclasses.replace(TPU_V5E, ici_bandwidth_gbps=20.0)
    autotune.TuningCache(path).store(cal.tuning_key, d, pin, 7.0, mode="cpu")
    entries = json.load(open(path))["entries"]
    (key, rec), = entries.items()
    assert key.startswith("tpu_v5e+net|cpu|")
    assert rec["comm"] == "gathered"
    # the reference rebuilds the same plan from the record
    assert j_autotune.plan_from_record(_j(d), rec).comm == "gathered"
    with use(tuning_cache_preload=path, machine=cal, device="cpu"):
        got = engine.plan_for(d)
    assert got.comm == "gathered" and got.plan_source == "autotuned"
    with use(tuning_cache_preload=path, machine=TPU_V5E, device="cpu"):
        assert engine.plan_for(d).plan_source == "model"  # no +net entry


def test_tuning_cache_preload_serves_tier1(tmp_path):
    path = str(tmp_path / "fleet.json")
    d = GemmDescriptor(m=80, n=80, k=64)
    pinned = plan_gemm(d, TPU_V5E, force_block=(8, 128),
                       heterogeneous=False)
    autotune.TuningCache(path).store(TPU_V5E.tuning_key, d, pinned, 1.0,
                                     mode="cpu")
    a = torch.from_numpy(RNG.standard_normal((80, 64)).astype(np.float32))
    b = torch.from_numpy(RNG.standard_normal((64, 80)).astype(np.float32))
    with use(backend="engine", device="cpu", machine=TPU_V5E,
             tuning_cache_preload=path):
        out = matmul(a, b)
    np.testing.assert_allclose(out.numpy(), a.numpy() @ b.numpy(),
                               rtol=1e-4, atol=1e-4)
    s = engine.stats()["gemm"]
    assert s["plan_source_tuned_cache"] == 1
    assert s["autotune_timings"] == 0


def test_engine_stats_carry_comm_counters():
    engine.count_comm("grouped_gemm", 1234, launches=2)
    s = engine.stats()["grouped_gemm"]
    assert (s["comm_bytes"], s["collective_launches"]) == (1234, 2)
    assert s["comm_bytes_bwd"] == s["collective_launches_bwd"] == 0
    engine.reset_stats()
    assert engine.stats().get("grouped_gemm", {}).get("comm_bytes", 0) == 0


def test_warmup_resolves_a_mesh_plan_and_builds_nothing():
    from repro_torch.core import warmstart
    d = _grouped_desc(8, 8, 16, 64, 96, 8)
    assert warmstart.synth_operands(d, "cpu") is None
    with use(device="cpu", machine=TPU_V5E):
        assert engine.warmup([d]) == {"grouped_gemm": 1}
    s = engine.stats()["grouped_gemm"]
    assert s["warmups"] == 1 and s["warmup_failures"] == 0
    assert s["plan_misses"] == 1 and s["launches"] == 0
    with use(device="cpu", machine=TPU_V5E):
        assert engine.plan_for(d).comm == plan_grouped(d, TPU_V5E).comm
    assert engine.stats()["grouped_gemm"]["plan_hits"] == 1


def test_fit_network_recovers_collective_coefficients():
    """Mesh records timed under a known network give its coefficients back,
    equal to the reference's fit of the same records."""
    from repro.core import refit as j_refit
    from repro_torch.core import refit
    truth = dict(ici_bandwidth_gbps=40.0, collective_launch_s=5e-6,
                 collective_efficiency={"all_gather": 1.0,
                                        "all_to_all": 0.5})
    true_m = dataclasses.replace(TPU_V5E, **truth)
    records, jrecords = [], []
    for case in GROUPED:
        d = _grouped_desc(*case)
        for comm in MESH_STRATEGIES:
            p = dataclasses.replace(
                plan_grouped(mesh_local_desc(d, comm), TPU_V5E), desc=d,
                comm=comm)
            us = p.predicted_seconds(true_m) * 1e6
            records.append((p, us))
            jrecords.append((j_autotune.plan_from_record(
                _j(d), autotune.plan_to_record(p)), us))
    net = refit.fit_network(records, TPU_V5E)
    jnet = j_refit.fit_network(jrecords, J_TPU_V5E)
    assert net == jnet
    assert net["ici_bandwidth_gbps"] == pytest.approx(40.0, rel=1e-6)
    assert net["collective_launch_s"] == pytest.approx(5e-6, rel=1e-6)
    assert net["collective_efficiency"]["all_to_all"] == \
        pytest.approx(0.5, rel=1e-6)
    # a record set without mesh plans identifies no network
    assert refit.fit_network([(plan_gemm(GemmDescriptor(m=8, n=8, k=8),
                                         TPU_V5E), 1.0)], TPU_V5E) is None


def test_refit_stage_applies_the_network(tmp_path):
    from repro_torch.core import refit
    truth = dataclasses.replace(TPU_V5E, ici_bandwidth_gbps=25.0,
                                collective_launch_s=4e-6)
    path = str(tmp_path / "tc.json")
    cache = autotune.TuningCache(path)
    for i, case in enumerate(GROUPED):
        # one record a descriptor (the key): the strategies alternate
        d, comm = _grouped_desc(*case), MESH_STRATEGIES[i % 2]
        p = dataclasses.replace(
            plan_grouped(mesh_local_desc(d, comm), TPU_V5E), desc=d,
            comm=comm)
        cache.store(truth.tuning_key, d, p, p.predicted_seconds(truth) * 1e6,
                    mode="cpu")
    model = refit.fit_cache_entries(json.load(open(path))["entries"],
                                    TPU_V5E)
    assert "ici_bandwidth_gbps" in model["fitted"]
    fitted = refit.apply_fit(TPU_V5E, model)
    assert fitted.network_calibrated
    assert fitted.tuning_key == "tpu_v5e+net+refit"


def test_tune_cli_merge_newest_wins(tmp_path):
    key = "h100_sxm+net|cuda|('gemm',)"
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps({"version": 1, "entries": {
        key: {"us": 10.0, "ts": 100.0},
        "h100_sxm|cuda|('gemm', 2)": {"us": 5.0, "ts": 100.0}}}))
    b.write_text(json.dumps({"version": 1, "entries": {
        key: {"us": 8.0, "ts": 200.0}}}))
    out = tmp_path / "merged.json"
    tool = os.path.join(ROOT, "tools", "tune_torch.py")
    r = subprocess.run([sys.executable, tool, "merge", str(out), str(a),
                        str(b)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    merged = json.loads(out.read_text())["entries"]
    assert len(merged) == 2 and merged[key]["us"] == 8.0
    only = tmp_path / "net.json"
    r = subprocess.run([sys.executable, tool, "export", str(out), str(only),
                        "--machine", "h100_sxm+net"],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert list(json.loads(only.read_text())["entries"]) == [key]
