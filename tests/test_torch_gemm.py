"""The port's GEMM family (plain tile walk on the CPU) against the
reference's ``ref_gemm`` oracle and its Pallas ``gemm`` in interpret mode.

Tolerances: atol = rtol = 1e-4 for float32 (the bound the reference's own
tests use against ``ref_gemm``; the reference's fused-vs-multi bit
identity does not hold on this tree) and 2e-2 for bfloat16 outputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.kernels.gemm import gemm as j_gemm
from repro.kernels.gemm import ref_gemm as j_ref_gemm

from repro_torch.core import engine, matmul, plan_gemm, use
from repro_torch.core.descriptor import EPILOGUES, GemmDescriptor
from repro_torch.kernels.gemm import gemm, ref_gemm
from repro_torch.kernels.gemm.kernel import (FusedGemm, LAUNCHES, gemm_fused,
                                             gemm_fused_plain, gemm_region,
                                             gemm_region_plain)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _cpu():
    with use(device="cpu", backend="engine"):
        engine.reset_stats()
        yield


def _operands(m, n, k, layout, *, batch=0, dtype="float32", epilogue=None,
              accumulate=False, seed=0):
    rng = np.random.default_rng(seed)
    lead = (batch,) if batch else ()
    a = rng.standard_normal(lead + (m, k)).astype(np.float32)
    b = (rng.standard_normal(lead + ((k, n) if layout == "nn" else (n, k)))
         / np.sqrt(k)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) \
        if epilogue in ("bias", "bias_gelu", "bias_silu") else None
    c = rng.standard_normal(lead + (m, n)).astype(np.float32) \
        if accumulate else None
    return a, b, bias, c


def _both(arrays, dtype):
    """The same numpy arrays as JAX and torch arrays of ``dtype``."""
    jx = [None if x is None else jnp.asarray(x, dtype) for x in arrays]
    tx = [None if x is None else torch.from_numpy(x).to(getattr(torch, dtype))
          for x in arrays]
    return jx, tx


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got.float() if torch.is_tensor(got)
                                          else got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("layout", ["nn", "nt"])
def test_epilogues_layouts_match_ref_gemm(epilogue, layout):
    ops = _operands(37, 150, 70, layout, epilogue=epilogue)
    (ja, jb, jbias, _), (ta, tb, tbias, _) = _both(ops, "float32")
    want = j_ref_gemm(ja, jb, layout=layout, epilogue=epilogue, bias=jbias)
    for fused in (True, False):
        got = gemm(ta, tb, layout=layout, epilogue=epilogue, bias=tbias,
                   fused=fused)
        _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["nn", "nt"])
@pytest.mark.parametrize("m,n,k", [(33, 129, 65), (130, 70, 257)])
def test_tails_accumulate_batch_match_ref_gemm(m, n, k, layout, dtype):
    ops = _operands(m, n, k, layout, batch=2, epilogue="bias_silu",
                    accumulate=True)
    (ja, jb, jbias, jc), (ta, tb, tbias, tc) = _both(ops, dtype)
    want = j_ref_gemm(ja, jb, jc, layout=layout, epilogue="bias_silu",
                      bias=jbias)
    for fused in (True, False):
        got = gemm(ta, tb, tc, layout=layout, epilogue="bias_silu",
                   bias=tbias, fused=fused)
        assert got.dtype == getattr(torch, dtype)
        _close(got, want, dtype)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("layout,epilogue,accumulate", [
    ("nn", "silu", False), ("nt", "bias_gelu", True)])
def test_matches_reference_pallas_gemm(layout, epilogue, accumulate, fused):
    """Against the reference's Pallas kernels (interpret mode), under the
    same TPU_V5E plans, so both walk the same tile tables."""
    ops = _operands(40, 300, 96, layout, epilogue=epilogue,
                    accumulate=accumulate, seed=1)
    (ja, jb, jbias, jc), (ta, tb, tbias, tc) = _both(ops, "float32")
    with jcore.use(backend="pallas"):
        want = j_gemm(ja, jb, jc, layout=layout, epilogue=epilogue,
                      bias=jbias, fused=fused)
    with use(machine="tpu_v5e"):
        got = gemm(ta, tb, tc, layout=layout, epilogue=epilogue, bias=tbias,
                   fused=fused)
    _close(got, want, "float32")


def test_launch_counts_fused_and_multi():
    ops = _operands(300, 500, 128, "nn")
    _, (ta, tb, _, _) = _both(ops, "float32")
    plan = plan_gemm(GemmDescriptor(m=300, n=500, k=128))
    assert len(plan.regions) > 1
    engine.reset_stats()
    gemm(ta, tb, fused=True)
    assert engine.stats()["gemm"]["launches"] == 1
    engine.reset_stats()
    gemm(ta, tb, fused=False)
    assert engine.stats()["gemm"]["launches"] == len(plan.regions)


@pytest.mark.parametrize("fused", [True, False])
def test_pad_edge_is_not_ported(fused):
    """The kernels mask edges; a padded-edge descriptor raises on either
    lowering instead of running as a masked one."""
    ops = _operands(20, 70, 40, "nn")
    _, (ta, tb, _, _) = _both(ops, "float32")
    desc = GemmDescriptor(m=20, n=70, k=40, edge="pad")
    with use(fused="on" if fused else "off"), \
            pytest.raises(NotImplementedError, match="edge='pad'"):
        engine.dispatch(desc, ta, tb)


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    """On CPU tensors the wrappers take the plain versions; the kernel
    launch counters move only on the card."""
    ops = _operands(20, 70, 40, "nt", epilogue="bias", accumulate=True)
    _, (ta, tb, tbias, tc) = _both(ops, "float32")
    a3, b3, c3 = ta[None], tb[None], tc[None]
    plan = plan_gemm(GemmDescriptor(m=20, n=70, k=40, layout="nt"))
    before = dict(LAUNCHES)
    exe = FusedGemm(plan.tile_schedule(), "cpu")
    kw = dict(layout="nt", epilogue="bias", bias=tbias, c=c3)
    got = gemm_fused(exe, a3, b3, out_dtype=torch.float32, **kw)
    want = gemm_fused_plain(exe.schedule, a3, b3, out_dtype=torch.float32,
                            **kw)
    assert torch.equal(got, want)
    out, ref = torch.empty_like(want), torch.empty_like(want)
    for r in plan.regions:
        gemm_region(a3, b3, out, r, **kw)
        gemm_region_plain(a3, b3, ref, r, **kw)
    assert torch.equal(out, ref)
    assert LAUNCHES == before
    _close(got[0], ref_gemm(ta, tb, tc, layout="nt", epilogue="bias",
                            bias=tbias), "float32")


def test_matmul_flattens_leading_dims_and_matches_torch_backend():
    ops = _operands(12, 48, 32, "nn", epilogue="gelu")
    _, (ta, tb, _, _) = _both(ops, "float32")
    x = ta.reshape(3, 4, 32)
    got = matmul(x, tb, epilogue="gelu")
    with use(backend="torch"):
        want = matmul(x, tb, epilogue="gelu")
    assert got.shape == (3, 4, 48)
    _close(got, want, "float32")


def test_matmul_gradients_match_plain_torch():
    """The engine forward carries plain-torch gradients (autograd.Function)."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(10, 24, generator=g)
    b = torch.randn(24, 33, generator=g).float()
    bias = torch.randn(33, generator=g)
    grads = []
    for backend in ("engine", "torch"):
        leaves = [t.clone().requires_grad_(True) for t in (a, b, bias)]
        with use(backend=backend):
            out = matmul(leaves[0], leaves[1], epilogue="bias_silu",
                         bias=leaves[2])
        (out.square().sum()).backward()
        grads.append([t.grad for t in leaves])
    for ge, gt in zip(*grads):
        torch.testing.assert_close(ge, gt, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_gemm_kernels_on_card(cuda_device):
    """On the card the wrappers launch the CUDA kernels (no plain path)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(1, 100, 64, generator=gen, device=cuda_device).bfloat16()
    b = torch.randn(1, 200, 64, generator=gen, device=cuda_device).bfloat16()
    plan = plan_gemm(GemmDescriptor(m=100, n=200, k=64, layout="nt",
                                    in_dtype="bfloat16", out_dtype="bfloat16"))
    exe = FusedGemm(plan.tile_schedule(), cuda_device)
    n0 = LAUNCHES["gemm_fused"]
    got = gemm_fused(exe, a, b, layout="nt", out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert LAUNCHES["gemm_fused"] == n0 + 1
    want = gemm_fused_plain(exe.schedule, a, b, layout="nt",
                            out_dtype=torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")

