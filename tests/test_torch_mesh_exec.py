"""Mesh execution of the port on ranks of a CPU process group, held to the
reference's single-device results (tests/test_mesh_planning.py's
eight-device test runs the reference itself on a forced host mesh).

For 2 and 4 ranks, ``run_ranks`` spawns gloo CPU processes that meet
through a file store under the test's temporary directory, each with a
(data 1, model W) mesh, and for 4 ranks also a (data 2, model 2) mesh.
On every rank, over the same numpy inputs:

  * the expert-parallel grouped GEMM on the reference's ragged input
    (expert j fills j + 1 of its capacity slots), both pinned strategies:
    bit-equal to each other, on every rank, and to the one-process
    grouped call; exact against the reference's ``_ref_ep``; one launch
    per rank; the distributed strategy's counters the reference's
    ``mesh_comm_events`` (two collectives), the gathered one's zero;
  * its gradient through ``expert_parallel_grouped_gemm``: within 1e-4
    of ``jax.grad`` of ``_ref_ep``;
  * the reduced phi3.5-moe MoE layer (8 experts) under the engine:
    within 1e-4 of the reference's ``moe_apply`` under ``backend="xla"``,
    the aux loss within 1e-5, three launches per rank and the counters of
    the reference planner's picks, under ``TPU_V5E`` (which gathers at
    these shapes) and under a network calibration whose all_gather is slow
    (which distributes);
  * ``compressed_psum`` equal to the reference's arithmetic, and
    ``make_global_batch``'s rows equal to the reference's global batch.

The worker is this module's ``_rank_work``: spawned children import this
module, so it imports no JAX at module level.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

NT, E, CAP, K, F = 8, 8, 16, 64, 96
STRATEGIES = ("gathered", "distributed")
MOE_X = (8, 32)
# A network calibration under which the planner distributes the MoE
# layer's expert GEMMs (its all_gather 1000x slower than its all_to_all).
SLOW_GATHER = dict(ici_bandwidth_gbps=1.0, collective_launch_s=1e-6,
                   collective_efficiency={"all_gather": 1e-3,
                                          "all_to_all": 1.0})


def _machines(tpu_v5e):
    return {"v5e": tpu_v5e,
            "slow_gather": dataclasses.replace(tpu_v5e, **SLOW_GATHER)}


def _layouts(world):
    """(data, model) meshes each world size runs the grouped GEMM on."""
    return [(1, world)] + ([(2, 2)] if world == 4 else [])


def _rank_work(rank, world, in_path, out_dir):
    """One rank: every check's port result, saved for the parent."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core import (TPU_V5E, GroupedGemmDescriptor, MeshSpec,
                                  engine, mesh_local_desc, plan_grouped, use)
    from repro_torch.data.pipeline import (SyntheticLMDataset,
                                           make_global_batch)
    from repro_torch.kernels.grouped_gemm import expert_parallel_grouped_gemm
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.common import Init
    from repro_torch.models.moe import MoE, moe_apply
    from repro_torch.optim.compression import compressed_psum
    from repro_torch.runtime.shardlib import use_mesh

    inp = {k: torch.from_numpy(v) for k, v in np.load(in_path).items()}
    x4, w = inp["x4"], inp["w"]
    out = {}

    def counters():
        s = engine.stats().get("grouped_gemm", {})
        return [s.get("launches", 0), s.get("comm_bytes", 0),
                s.get("collective_launches", 0)]

    with use(device="cpu", backend="engine"):
        for data, model in _layouts(world):
            tag = f"{data}x{model}"
            mesh = make_test_mesh(data, model, device="cpu")
            desc = GroupedGemmDescriptor(t=NT * E * CAP, k=K, n=F,
                                         num_experts=E,
                                         mesh=MeshSpec("model", model))
            with use_mesh(mesh):
                for comm in STRATEGIES:
                    pin = dataclasses.replace(
                        plan_grouped(mesh_local_desc(desc, comm)), desc=desc,
                        comm=comm)
                    engine.reset_stats()
                    out[f"ep_{tag}_{comm}"] = engine.dispatch(
                        desc, x4, w, None, plan=pin)
                    out[f"count_{tag}_{comm}"] = counters()
        mesh = make_test_mesh(1, world, device="cpu")
        with use_mesh(mesh):
            xg = x4.clone().requires_grad_(True)
            wg = w.clone().requires_grad_(True)
            y = expert_parallel_grouped_gemm(xg, wg, axis="model")
            (y * inp["cot"]).sum().backward()
            out["grad_x"], out["grad_w"] = xg.grad, wg.grad

            cfg = reduced_config(get_config("phi3.5-moe-42b"), num_experts=8)
            ff = MoE(cfg, Init(0, "cpu"))
            ff.load_state_dict({name: inp[f"moe.{name}"]
                                for name, _ in ff.named_parameters()})
            for name, machine in _machines(TPU_V5E).items():
                engine.reset_stats()
                with use(machine=machine), torch.no_grad():
                    y, aux = moe_apply(ff, cfg, inp["moe_x"])
                out[f"moe_y_{name}"], out[f"moe_aux_{name}"] = y, aux
                out[f"moe_count_{name}"] = counters()

            out["psum"] = compressed_psum(inp["psum_x"][rank], "model")
        batch_mesh = make_test_mesh(world, 1, device="cpu")
        ds = SyntheticLMDataset(vocab_size=97, seq_len=12, global_batch=8,
                                seed=5)
        out["batch"] = {k: torch.from_numpy(v) for k, v in
                        make_global_batch(ds, 3, batch_mesh).items()}
        if world == 4:
            out["batch_2x2"] = {k: torch.from_numpy(v) for k, v in
                                make_global_batch(ds, 3, make_test_mesh(
                                    2, 2, device="cpu")).items()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


# ---------------------------------------------------------------------------
# The parent: inputs, the reference's results, the spawned ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    """Inputs (numpy) and the reference's single-device results."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.configs import reduced_config as j_reduced_config
    from repro.core import use as j_use
    from repro.kernels.grouped_gemm.ops import _ref_ep
    from repro.models.moe import moe_apply as j_moe_apply
    from repro.models.moe import moe_init

    rng = np.random.default_rng(0)
    x4 = rng.standard_normal((NT, E, CAP, K)).astype(np.float32)
    occ = (np.arange(CAP)[None, :] <= np.arange(E)[:, None])
    x4 = (x4 * occ[None, :, :, None]).astype(np.float32)
    w = rng.standard_normal((E, K, F)).astype(np.float32)
    cot = rng.standard_normal((NT, E, CAP, F)).astype(np.float32)
    inputs = {"x4": x4, "w": w, "cot": cot}
    ref = {"ep": np.asarray(_ref_ep(None, jnp.asarray(x4), jnp.asarray(w)))}
    gx, gw = jax.grad(lambda a, b: jnp.sum(_ref_ep(None, a, b) * cot),
                      argnums=(0, 1))(jnp.asarray(x4), jnp.asarray(w))
    ref["grad_x"], ref["grad_w"] = np.asarray(gx), np.asarray(gw)

    jcfg = j_reduced_config(j_get_config("phi3.5-moe-42b"), num_experts=8)
    params = moe_init(jax.random.PRNGKey(0), jcfg)
    for name, leaf in params.items():
        inputs[f"moe.{name}.w"] = np.asarray(leaf["w"])
    moe_x = rng.standard_normal(MOE_X + (jcfg.d_model,)).astype(np.float32)
    inputs["moe_x"] = moe_x
    with j_use(backend="xla"):
        y, aux = j_moe_apply(params, jcfg, jnp.asarray(moe_x))
    ref["moe_y"], ref["moe_aux"] = np.asarray(y), float(aux)
    inputs["psum_x"] = (rng.standard_normal((4, 3, 300))
                        * np.array([1.0, 3.0, 0.01, 40.0])[:, None, None]
                        ).astype(np.float32)
    return inputs, ref


def _moe_expected_counters(world, machine):
    """The counters of the reference planner's picks under ``machine`` for
    the layer's three expert GEMMs on a model axis of ``world``: (comm
    bytes, collectives) of the distributed picks, the reference counting
    no gathered collective."""
    import repro.core as jcore
    from repro.configs import get_config as j_get_config
    from repro.configs import reduced_config as j_reduced_config
    cfg = j_reduced_config(j_get_config("phi3.5-moe-42b"), num_experts=8)
    t = MOE_X[0] * MOE_X[1]
    g = min(cfg.moe_group, max(1, t // 32))
    while t % g:
        g -= 1
    cap = max(8, -(-int(cfg.capacity_factor * g * cfg.num_experts_per_tok
                       / cfg.num_experts) // 8) * 8)
    rows = (t // g) * cfg.num_experts * cap
    nbytes = launches = 0
    for k, n, epi in ((cfg.d_model, cfg.d_ff, None),
                      (cfg.d_model, cfg.d_ff, cfg.mlp_act),
                      (cfg.d_ff, cfg.d_model, None)):
        desc = jcore.GroupedGemmDescriptor(
            t=rows, k=k, n=n, num_experts=cfg.num_experts, epilogue=epi,
            mesh=jcore.MeshSpec("model", world))
        comm = jcore.plan_grouped(desc, machine).comm
        if comm == "distributed":
            events = jcore.mesh_comm_events(desc, comm)
            nbytes += sum(b for _, b in events)
            launches += len(events)
    return nbytes, launches


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"{w}ranks")
def ranks(request, reference, tmp_path_factory):
    from repro_torch.launch.mesh import run_ranks
    world = request.param
    inputs, _ = reference
    d = tmp_path_factory.mktemp(f"mesh{world}")
    in_path = str(d / "inputs.npz")
    np.savez(in_path, **inputs)
    run_ranks(_rank_work, world, (in_path, str(d)), store_dir=str(d),
              device="cpu", timeout_s=240)
    return world, [torch.load(d / f"rank{r}.pt") for r in range(world)]


def test_ep_strategies_bit_equal_and_exact(reference, ranks):
    from repro_torch.core import use
    from repro_torch.kernels.grouped_gemm import expert_parallel_grouped_gemm
    inputs, ref = reference
    world, results = ranks
    with use(device="cpu", backend="engine"):
        one = expert_parallel_grouped_gemm(torch.from_numpy(inputs["x4"]),
                                           torch.from_numpy(inputs["w"]))
    for data, model in _layouts(world):
        for r, res in enumerate(results):
            for comm in STRATEGIES:
                y = res[f"ep_{data}x{model}_{comm}"]
                assert torch.equal(y, one), (data, model, r, comm)
        np.testing.assert_array_equal(one.numpy(), ref["ep"])


def test_ep_counters_equal_reference(ranks):
    import repro.core as jcore
    world, results = ranks
    for data, model in _layouts(world):
        jdesc = jcore.GroupedGemmDescriptor(
            t=NT * E * CAP, k=K, n=F, num_experts=E,
            mesh=jcore.MeshSpec("model", model))
        events = jcore.mesh_comm_events(jdesc, "distributed")
        for res in results:
            assert res[f"count_{data}x{model}_gathered"] == [1, 0, 0]
            assert res[f"count_{data}x{model}_distributed"] == \
                [1, sum(b for _, b in events), 2]


def test_ep_gradient_matches_jax(reference, ranks):
    _, ref = reference
    _, results = ranks
    for res in results:
        for name in ("grad_x", "grad_w"):
            err = np.abs(res[name].numpy() - ref[name]).max()
            assert err < 1e-4, (name, err)


@pytest.mark.parametrize("machine", ["v5e", "slow_gather"])
def test_moe_layer_on_the_mesh_matches_reference(reference, ranks, machine):
    from repro.core.machine import TPU_V5E as J_TPU_V5E
    _, ref = reference
    world, results = ranks
    nbytes, launches = _moe_expected_counters(
        world, _machines(J_TPU_V5E)[machine])
    assert (launches > 0) == (machine == "slow_gather")
    for res in results:
        y = res[f"moe_y_{machine}"]
        err = np.abs(y.numpy() - ref["moe_y"]).max()
        assert err < 1e-4, err
        assert abs(float(res[f"moe_aux_{machine}"]) - ref["moe_aux"]) < 1e-5
        assert res[f"moe_count_{machine}"] == [3, nbytes, launches]
        assert torch.equal(y, results[0][f"moe_y_{machine}"])


def test_compressed_psum_equals_reference_arithmetic(reference, ranks):
    """The reference's ``compressed_psum`` on the same partials: its own
    block quantizer per partial, the max scale, re-quantized int32 sum."""
    import jax.numpy as jnp
    from repro.optim.compression import _dequantize_int8, _quantize_int8
    inputs, _ = reference
    world, results = ranks
    parts = [jnp.asarray(inputs["psum_x"][r]) for r in range(world)]
    qs = [_quantize_int8(p) for p in parts]
    scale_max = qs[0][1]
    for _, s in qs[1:]:
        scale_max = jnp.maximum(scale_max, s)
    total = sum(jnp.clip(jnp.round(q.astype(jnp.float32) * (s / scale_max)),
                         -127, 127).astype(jnp.int32) for q, s in qs)
    want = np.asarray(_dequantize_int8(total, scale_max, parts[0].shape))
    for res in results:
        np.testing.assert_array_equal(res["psum"].numpy(), want)
    exact = sum(np.asarray(p) for p in parts)
    assert np.abs(want - exact).max() <= \
        world * np.abs(exact).max() / 127.0 + 1e-6


def test_make_global_batch_rows_equal_reference(ranks):
    import jax
    from repro.data.pipeline import SyntheticLMDataset as JDataset
    from repro.data.pipeline import make_global_batch as j_make_global_batch
    from repro.launch.mesh import make_test_mesh as j_make_test_mesh
    world, results = ranks
    ds = JDataset(vocab_size=97, seq_len=12, global_batch=8, seed=5)
    full = {k: np.asarray(jax.device_get(v)) for k, v in
            j_make_global_batch(ds, 3, j_make_test_mesh(1, 1)).items()}
    rows = 8 // world
    for r, res in enumerate(results):
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(
                res["batch"][key].numpy(), full[key][r * rows:(r + 1) * rows])
            if world == 4:  # (data 2, model 2): the rank's data row
                i = r // 2
                np.testing.assert_array_equal(
                    res["batch_2x2"][key].numpy(), full[key][i * 4:(i + 1) * 4])


def _rank_fails(rank, world):
    """Rank 1 raises; rank 0 waits on a collective it never completes."""
    import torch.distributed as dist
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def test_a_failing_rank_stops_the_others(tmp_path):
    """One rank's failure ends the run at once with its exit code, not at
    the process group's timeout."""
    import time
    from repro_torch.launch.mesh import run_ranks
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited with codes"):
        run_ranks(_rank_fails, 2, store_dir=str(tmp_path), device="cpu",
                  timeout_s=120)
    assert time.monotonic() - t0 < 60
