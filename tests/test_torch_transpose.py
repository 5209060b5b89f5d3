"""The port's transpose family against the reference's: the descriptor
(cache key, flops and bytes), the planner (``TPU_V5E`` plans equal, the
``H100_SXM`` legality the CUDA kernel's tile edges), ``transpose`` against
``ref_transpose`` and the reference's interpret-mode
``build_transpose_kernel``, one launch per call, and the §IV-C two-pass
GEMM ``gemm(a, transpose(b))`` against ``gemm(a, b, layout="nt")``.

Tolerances: the transpose is a copy, so it is held bit for bit (fp32,
bf16, int8); the two-pass GEMM agrees with the one-pass ``nt`` GEMM and
with the reference's pair at atol = rtol = 1e-4 in float32 (the products
sum in another order).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.blocking import _transpose_legal as j_transpose_legal
from repro.core.blocking import plan_transpose as j_plan_transpose
from repro.core.descriptor import TransposeDescriptor as JDesc
from repro.kernels.gemm import gemm as j_gemm
from repro.kernels.transpose import ref_transpose as j_ref_transpose
from repro.kernels.transpose import transpose as j_transpose
from repro.kernels.transpose.kernel import build_transpose_kernel

from repro_torch.core import (H100_SXM, TPU_V5E, TransposeDescriptor, engine,
                              plan_transpose, use)
from repro_torch.core.blocking import _transpose_legal
from repro_torch.kernels.gemm import gemm
from repro_torch.kernels.transpose import ref_transpose, transpose
from repro_torch.kernels.transpose import kernel as tkernel

TRANSPOSE_CU = (Path(tkernel.__file__).parent / "csrc"
                / "transpose.cu").read_text()


@pytest.fixture(autouse=True)
def _cpu():
    with use(device="cpu", backend="engine"):
        engine.reset_stats()
        yield


def _bits(x):
    """A tensor or array's raw bits as a numpy integer array."""
    if torch.is_tensor(x):
        view = {4: torch.int32, 2: torch.int16, 1: torch.int8}
        return x.contiguous().view(view[x.element_size()]).numpy()
    a = np.asarray(x)
    return a.view({4: np.int32, 2: np.int16, 1: np.int8}[a.itemsize])


def _data(shape, dtype, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape) * 10
    if dtype == "int8":
        q = np.clip(np.round(a), -127, 127).astype(np.int8)
        return jnp.asarray(q), torch.from_numpy(q)
    j = jnp.asarray(a.astype(np.float32), dtype)
    return j, torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))


DESC_CASES = [(7, 9, "float32", 0), (256, 512, "float32", 0),
              (151936, 1024, "bfloat16", 0), (100, 70, "float32", 3),
              (33, 1, "bfloat16", 2), (1, 1, "int8", 0)]


@pytest.mark.parametrize("rows,cols,dtype,batch", DESC_CASES)
def test_descriptor_keys_and_costs_equal_reference(rows, cols, dtype, batch):
    kw = dict(rows=rows, cols=cols, dtype=dtype, batch=batch)
    d, j = TransposeDescriptor(**kw), JDesc(**kw)
    assert d.cache_key() == j.cache_key()
    assert (d.flops, d.in_bytes, d.out_bytes) == \
        (j.flops, j.in_bytes, j.out_bytes)
    shape = ((batch,) if batch else ()) + (rows, cols)
    x = torch.zeros(shape, dtype=getattr(torch, dtype))
    jx = jnp.zeros(shape, dtype)
    assert TransposeDescriptor.from_operands(x).cache_key() == \
        JDesc.from_operands(jx).cache_key()


def test_descriptor_refusals_match_reference():
    for desc in (TransposeDescriptor, JDesc):
        with pytest.raises(ValueError, match="positive"):
            desc(rows=0, cols=4)
        with pytest.raises(ValueError, match="rank"):
            desc.from_operands(np.zeros((2, 2, 2, 2)))


PLAN_SWEEP = [(rows, cols, dtype, batch)
              for rows, cols in [(7, 9), (64, 64), (100, 70), (256, 512),
                                 (1000, 33), (4096, 4096), (151936, 1024)]
              for dtype in ("float32", "bfloat16")
              for batch in (0, 3)]


@pytest.mark.parametrize("rows,cols,dtype,batch", PLAN_SWEEP)
def test_tpu_plans_equal_reference(rows, cols, dtype, batch):
    kw = dict(rows=rows, cols=cols, dtype=dtype, batch=batch)
    plan = plan_transpose(TransposeDescriptor(**kw), TPU_V5E)
    jplan = j_plan_transpose(JDesc(**kw))
    assert plan.bt == jplan.bt
    assert _transpose_legal(TransposeDescriptor(**kw), TPU_V5E) == \
        j_transpose_legal(JDesc(**kw), jcore.TPU_V5E)
    assert plan.predicted_seconds(TPU_V5E) == pytest.approx(
        jplan.predicted_seconds(jcore.TPU_V5E), rel=1e-12)


@pytest.mark.parametrize("rows,cols,dtype,batch", PLAN_SWEEP)
def test_h100_plans_take_the_kernel_tiles(rows, cols, dtype, batch):
    desc = TransposeDescriptor(rows=rows, cols=cols, dtype=dtype, batch=batch)
    assert _transpose_legal(desc, H100_SXM) == list(H100_SXM.transpose_tiles)
    assert plan_transpose(desc).bt in H100_SXM.transpose_tiles


def test_kernel_tile_edges_are_the_machine_field():
    """transpose.cu instantiates exactly H100_SXM.transpose_tiles, and its
    entry refuses any other edge."""
    edges = [int(v) for v in re.findall(r"constexpr int BT_\w+ = (\d+);",
                                        TRANSPOSE_CU)]
    assert tuple(edges) == H100_SXM.transpose_tiles == tkernel.TILE_EDGES
    assert "bt != BT_SMALL && bt != BT_LARGE" in TRANSPOSE_CU


CASES = [((256, 512), "float32", None), ((100, 70), "float32", 32),
         ((3, 100, 70), "float32", None), ((2, 65, 129), "bfloat16", 64),
         ((37, 5), "bfloat16", None), ((2, 33, 17), "int8", 32),
         ((1, 1), "float32", None)]


@pytest.mark.parametrize("shape,dtype,bt", CASES)
def test_transpose_bit_exact_against_reference(shape, dtype, bt):
    jx, tx = _data(shape, dtype)
    got = transpose(tx, bt=bt)
    assert got.shape == shape[:-2] + (shape[-1], shape[-2])
    assert got.is_contiguous()
    np.testing.assert_array_equal(_bits(got), _bits(j_ref_transpose(
        jnp.asarray(jx))))
    np.testing.assert_array_equal(_bits(got), _bits(ref_transpose(tx)))
    if dtype != "int8":  # the reference's Pallas kernel, interpret mode
        want = j_transpose(jx, bt=bt) if bt is not None else j_transpose(jx)
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_transpose_ragged_batch_against_the_interpret_kernel():
    """The reference's kernel itself, built with edge blocks on both axes
    and a batch grid dimension."""
    jx, tx = _data((3, 77, 45), "float32", seed=1)
    kernel = build_transpose_kernel(77, 45, 32, 32, jnp.float32, True,
                                    batch=3)
    np.testing.assert_array_equal(_bits(transpose(tx, bt=32)),
                                  _bits(kernel(jx)))


def test_nan_outside_a_padded_view_does_not_reach_the_output():
    base = torch.full((2, 90, 80), float("nan"))
    view = base[:, :70, :50]
    view.copy_(torch.randn(2, 70, 50, generator=torch.Generator()
                           .manual_seed(0)))
    assert view.stride(1) == 80
    for bt in (16, 32, 64):
        got = transpose(view, bt=bt)
        assert not torch.isnan(got).any()
        assert torch.equal(got, view.transpose(1, 2))


def test_one_launch_per_call_batched_included():
    tx = torch.randn(5, 40, 30)
    for x, n in ((tx, 1), (tx[0], 2), (tx, 3)):
        transpose(x)
        assert engine.stats()["transpose"]["launches"] == n
    # the reference counts the same
    jcore.engine.reset_stats()
    j_transpose(jnp.zeros((5, 40, 30)))
    assert jcore.engine.stats()["transpose"]["launches"] == 1


def test_plain_version_walks_row_strips():
    x = torch.randn(2, 70, 45)
    for bt in (1, 7, 32, 64, 200):
        assert torch.equal(tkernel.transpose_plain(x, bt=bt),
                           x.transpose(1, 2))
    # the CPU wrapper runs the plain version and counts no launch
    n0 = tkernel.LAUNCHES["transpose"]
    tkernel.transpose_tiles(x, bt=32)
    assert tkernel.LAUNCHES["transpose"] == n0


@pytest.mark.parametrize("m,n,k", [(256, 256, 512), (33, 70, 100)])
def test_two_pass_gemm_matches_nt_and_reference(m, n, k):
    """§IV-C: the strided-contraction B as a panel transpose then an nn
    GEMM, against the one-pass nt GEMM and the reference's two passes."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((n, k)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    engine.reset_stats()
    two = gemm(ta, transpose(tb))
    assert engine.stats()["transpose"]["launches"] == 1
    one = gemm(ta, tb, layout="nt")
    with jcore.use(backend="pallas"):
        jtwo = j_gemm(jnp.asarray(a), j_transpose(jnp.asarray(b), bt=128))
    for want in (one.numpy(), np.asarray(jtwo)):
        np.testing.assert_allclose(two.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_transpose_kernel_on_card(cuda_device):
    """On the card the wrapper launches the CUDA kernel: bit-exact, one
    launch, nothing read past a padded view's extent."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        base = torch.full((3, 130, 90), float("nan"), device=cuda_device,
                          dtype=dtype)
        view = base[:, :100, :70]
        view.copy_(torch.randn(3, 100, 70, generator=gen,
                               device=cuda_device).to(dtype))
        for bt in H100_SXM.transpose_tiles:
            n0 = tkernel.LAUNCHES["transpose"]
            got = tkernel.transpose_tiles(view, bt=bt)
            torch.cuda.synchronize()
            assert tkernel.LAUNCHES["transpose"] == n0 + 1
            assert torch.equal(got, view.transpose(1, 2))
            assert not torch.isnan(got).any()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")
