"""The port's grouped-GEMM family (forward) against the reference: the
runtime tile tables bit for bit, the descriptors' cache keys, the planners
under ``TPU_V5E`` (equal to the reference's) and ``H100_SXM`` (fused at
the full-width phi3.5-moe shapes), the pad/scatter helpers, the oracle,
and ``grouped_gemm`` under both lowerings against ``ref_grouped_gemm`` and
the reference's ``grouped_gemm`` (its Pallas kernels in interpret mode,
as the reference's tests run them), on the same numpy inputs.

Tolerance: float32 atol = rtol = 1e-4 (tests/test_kernels_other.py's
epilogue bound; float32 on both sides, products summed in another order).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan_grouped as j_plan_grouped
from repro.core.blocking import plan_grouped_bwd as j_plan_grouped_bwd
from repro.core.descriptor import GroupedGemmBwdDescriptor as JBwdDesc
from repro.core.descriptor import GroupedGemmDescriptor as JDesc
from repro.core.schedule import GroupedTileSchedule as JSchedule
from repro.kernels.grouped_gemm import grouped_gemm as j_grouped_gemm
from repro.kernels.grouped_gemm import ref_grouped_gemm as j_ref
from repro.kernels.grouped_gemm.ops import plan_groups as j_plan_groups
from repro.kernels.grouped_gemm.ops import scatter_rows as j_scatter_rows

from repro_torch.core import (H100_SXM, TPU_V5E, GroupedGemmBwdDescriptor,
                              GroupedGemmDescriptor, GroupedTileSchedule,
                              engine, grouped_bwd_fused_legal,
                              grouped_fused_legal, plan_grouped,
                              plan_grouped_bwd, use)
from repro_torch.core.blocking import grouped_smem_bytes
from repro_torch.core.schedule import TILE_SKIP, TILE_ZERO
from repro_torch.kernels.grouped_gemm import kernel as grouped_kernel
from repro_torch.kernels.grouped_gemm import grouped_gemm, ref_grouped_gemm
from repro_torch.kernels.grouped_gemm.kernel import (LAUNCHES, grouped_fused,
                                                     grouped_fused_plain,
                                                     grouped_padded,
                                                     grouped_padded_plain)
from repro_torch.kernels.grouped_gemm.ops import plan_groups, scatter_rows

F32 = dict(atol=1e-4, rtol=1e-4)
EPILOGUES = [None, "bias", "gelu", "silu", "relu", "bias_gelu", "bias_silu"]

# tests/test_schedule.py's grouped cases: (group sizes, rows past the sum).
TABLE_CASES = [([37, 0, 201, 70], 4), ([0, 0, 0], 5), ([300], 0),
               ([5, 3, 2, 1], 0), ([0, 0, 17], 10), ([1], 0)]
# tests/test_kernels_other.py's ragged cases.
RAGGED_CASES = [([37, 0, 201, 70], 4), ([0, 0, 0], 5), ([300], 0),
                ([5, 3, 2, 1], 0), ([0, 0, 17], 10), ([60, 60, 60], 33)]
# The full-width phi3.5-moe-42b expert GEMMs: 16 experts, d 4096, d_ff 6400;
# 4096 capacity rows at prefill (batch 4 x 256) and training (8 x 128), 512
# at decode (batch 4).
FULL_WIDTH = [(t, k, n) for t in (4096, 512)
              for k, n in ((4096, 6400), (6400, 4096))]


@pytest.fixture(autouse=True)
def _cpu():
    with use(device="cpu", backend="engine"):
        engine.reset_stats()
        yield


def _case(sizes, t_extra, kdim=100, n=70, seed=0):
    r = np.random.default_rng(seed)
    sizes = np.asarray(sizes, np.int32)
    t = max(1, int(sizes.sum()) + t_extra)
    x = r.standard_normal((t, kdim)).astype(np.float32)
    w = r.standard_normal((len(sizes), kdim, n)).astype(np.float32)
    bias = r.standard_normal((len(sizes), n)).astype(np.float32)
    return sizes, x, w, bias


# ---------------------------------------------------------------------------
# tables, descriptors, plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,t_extra", TABLE_CASES)
def test_tables_equal_reference(sizes, t_extra):
    sizes = np.asarray(sizes, np.int32)
    t = max(1, int(sizes.sum()) + t_extra)
    kw = dict(t=t, k=32, n=48, num_experts=len(sizes), bm=min(16, t), bk=32,
              bn=48)
    sched = GroupedTileSchedule(**kw)
    got = sched.tables(torch.from_numpy(sizes)).numpy()
    want = np.asarray(JSchedule(**kw).tables(jnp.asarray(sizes)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    sched.validate_tables(got, sizes)
    states = got[:, 4]
    assert (states == TILE_ZERO).any() == (int(sizes.sum()) < t)
    assert (states != TILE_SKIP).sum() <= sched.max_tiles


@pytest.mark.parametrize("sizes,t,bm", [([1, 1, 1, 97], 100, 16),
                                        ([13, 7, 0, 21], 50, 8)])
def test_adversarial_tables_equal_reference(sizes, t, bm):
    """tests/test_schedule.py's static-bound (worst partial blocks) and
    never-cross-experts cases."""
    sizes = np.asarray(sizes, np.int32)
    kw = dict(t=t, k=16, n=16, num_experts=len(sizes), bm=bm, bk=16, bn=16)
    sched = GroupedTileSchedule(**kw)
    got = sched.tables(torch.from_numpy(sizes)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JSchedule(**kw).tables(jnp.asarray(sizes))))
    assert sched.max_tiles == -(-t // bm) + len(sizes) + 1
    sched.validate_tables(got, sizes)


@pytest.mark.parametrize("kw", [
    dict(t=4096, k=4096, n=6400, num_experts=16, dtype="bfloat16",
         epilogue="silu"),
    dict(t=512, k=6400, n=4096, num_experts=16, dtype="bfloat16"),
    dict(t=297, k=100, n=70, num_experts=4, dtype="float32",
         epilogue="bias_gelu")])
def test_descriptor_cache_keys_equal_reference(kw):
    desc = GroupedGemmDescriptor(**kw)
    assert desc.cache_key() == JDesc(**kw).cache_key()
    bdesc = GroupedGemmBwdDescriptor.from_forward(desc)
    jb = JBwdDesc.from_forward(JDesc(**kw))
    assert bdesc.cache_key() == jb.cache_key()
    for d, j in ((desc, JDesc(**kw)), (bdesc, jb)):
        assert (d.flops, d.in_bytes, d.out_bytes) == \
            (j.flops, j.in_bytes, j.out_bytes)


def test_descriptor_from_operands_and_refusals():
    x, w = torch.zeros(10, 8), torch.zeros(3, 8, 5)
    d = GroupedGemmDescriptor.from_operands(x, w, epilogue="relu")
    assert d.cache_key() == JDesc.from_operands(
        jnp.zeros((10, 8)), jnp.zeros((3, 8, 5)), epilogue="relu").cache_key()
    with pytest.raises(ValueError, match="contraction"):
        GroupedGemmDescriptor.from_operands(x, torch.zeros(3, 9, 5))
    # The quant axis is ported: a quantized descriptor keys like the
    # reference's, and a quantized call runs (within int8 error of wide).
    from repro.core.descriptor import resolve_quant as j_resolve_quant
    from repro_torch.core import resolve_quant
    assert GroupedGemmDescriptor(
        t=4, k=4, n=4, num_experts=2, quant=resolve_quant("int8")
    ).cache_key() == JDesc(t=4, k=4, n=4, num_experts=2,
                           quant=j_resolve_quant("int8")).cache_key()
    gen = torch.Generator().manual_seed(0)
    xr, wr = torch.randn(10, 8, generator=gen), torch.randn(3, 8, 5,
                                                           generator=gen)
    sizes = torch.tensor([4, 4, 2])
    with use(device="cpu"):
        got = grouped_gemm(xr, wr, sizes, quant="int8")
        wide = grouped_gemm(xr, wr, sizes, quant=False)
    assert got.shape == (10, 5)
    assert (got - wide).abs().max() <= 5e-2 * wide.abs().max()


@pytest.mark.parametrize("t,k,n,e,dtype,epilogue", [
    (4096, 4096, 6400, 16, "bfloat16", "silu"),
    (4096, 6400, 4096, 16, "bfloat16", None),
    (512, 4096, 6400, 16, "bfloat16", None),
    (512, 6400, 4096, 16, "bfloat16", None),
    (297, 100, 70, 4, "float32", "bias"),
    (64, 32, 48, 3, "float32", None),
    (4096, 512, 1024, 8, "bfloat16", None)])
def test_tpu_plans_equal_reference(t, k, n, e, dtype, epilogue):
    """Under TPU_V5E the port's plans are the reference's, forward and
    backward, fused=False where its VMEM formula fails (the full-width
    prefill shapes)."""
    kw = dict(t=t, k=k, n=n, num_experts=e, dtype=dtype, epilogue=epilogue)
    desc = GroupedGemmDescriptor(**kw)
    bdesc = GroupedGemmBwdDescriptor.from_forward(desc)
    jdesc = JDesc(**kw)
    for got, want in ((plan_grouped(desc, TPU_V5E), j_plan_grouped(jdesc)),
                      (plan_grouped_bwd(bdesc, TPU_V5E),
                       j_plan_grouped_bwd(JBwdDesc.from_forward(jdesc)))):
        assert (got.bm, got.bk, got.bn, got.fused, got.t_padded) == \
            (want.bm, want.bk, want.bn, want.fused, want.t_padded)
        sched, jsched = got.tile_schedule(), want.tile_schedule()
        assert (sched.bm, sched.bk, sched.bn, sched.max_tiles) == \
            (jsched.bm, jsched.bk, jsched.bn, jsched.max_tiles)
    if t == 4096 and k * n == 4096 * 6400:
        assert not grouped_fused_legal(desc, TPU_V5E)
        assert not grouped_bwd_fused_legal(bdesc, TPU_V5E)


@pytest.mark.parametrize("t,k,n", FULL_WIDTH)
def test_h100_plans_full_width_fused(t, k, n):
    """On H100_SXM the kernels stream tiles from device memory: the
    full-width expert GEMMs plan fused both ways, with a tiling the CUDA
    kernels instantiate."""
    desc = GroupedGemmDescriptor(t=t, k=k, n=n, num_experts=16,
                                 dtype="bfloat16", epilogue="silu")
    bdesc = GroupedGemmBwdDescriptor.from_forward(desc)
    for plan in (plan_grouped(desc, H100_SXM),
                 plan_grouped_bwd(bdesc, H100_SXM)):
        assert plan.fused
        assert (plan.bm, plan.bk, plan.bn) in H100_SXM.grouped_blocks
    assert grouped_fused_legal(desc, H100_SXM)
    assert grouped_bwd_fused_legal(bdesc, H100_SXM)


# ---------------------------------------------------------------------------
# pad/scatter helpers, oracle, dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,t_extra", RAGGED_CASES)
def test_pad_scatter_helpers_equal_reference(sizes, t_extra):
    sizes, x, _, _ = _case(sizes, t_extra)
    bm, e = 16, len(sizes)
    t_padded = -(-x.shape[0] // bm) * bm + e * bm
    got = plan_groups(torch.from_numpy(sizes), e, bm, t_padded)
    want = j_plan_groups(jnp.asarray(sizes), e, bm, t_padded)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    xp, dest = scatter_rows(torch.from_numpy(x), torch.from_numpy(sizes),
                            got[0], bm, t_padded)
    jxp, jdest = j_scatter_rows(jnp.asarray(x), jnp.asarray(sizes),
                                want[0], bm, t_padded)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jxp))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))


@pytest.mark.parametrize("sizes,t_extra", RAGGED_CASES)
def test_oracle_matches_reference_oracle(sizes, t_extra):
    sizes, x, w, _ = _case(sizes, t_extra)
    got = ref_grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(sizes))
    want = j_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _j_epilogue_ref(x, w, sizes, bias, epilogue):
    """tests/test_kernels_other.py's per-expert epilogue oracle."""
    import jax
    ref = np.asarray(j_ref(jnp.asarray(x), jnp.asarray(w),
                           jnp.asarray(sizes)))
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    expert = np.clip(np.searchsorted(offsets, np.arange(x.shape[0]),
                                     side="right") - 1, 0, len(sizes) - 1)
    if epilogue and "bias" in epilogue:
        ref = ref + bias[expert]
    if epilogue in ("gelu", "bias_gelu"):
        ref = np.asarray(jax.nn.gelu(ref))
    elif epilogue in ("silu", "bias_silu"):
        ref = np.asarray(jax.nn.silu(ref))
    elif epilogue == "relu":
        ref = np.maximum(ref, 0)
    valid = (np.arange(x.shape[0]) < offsets[-1])[:, None]
    return np.where(valid, ref, 0.0)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("sizes,t_extra", RAGGED_CASES)
def test_lowerings_match_reference(sizes, t_extra, fused):
    """Both lowerings, pinned to the reference tests' tiling (bm 16, bk 64,
    bn 32: M, K and N tails in every case), against the port's oracle and
    the reference's grouped_gemm in interpret mode; one launch a call."""
    sizes, x, w, _ = _case(sizes, t_extra)
    kw = dict(bm=16, bk=64, bn=32, fused=fused)
    n0 = dict(LAUNCHES)
    got = grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(sizes), **kw)
    want = j_grouped_gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes),
                          **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(
        got.numpy(), ref_grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                                      torch.from_numpy(sizes)).numpy(), **F32)
    assert engine.stats()["grouped_gemm"]["launches"] == 1
    # CPU tensors run the plain versions: no kernel launch is counted.
    assert LAUNCHES == n0


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_epilogues_match_reference(epilogue, fused):
    """Every epilogue, with a per-expert bias where it takes one, on a
    ragged case with an empty expert and rows past the sum."""
    sizes, x, w, bias = _case([13, 0, 40, 7], 5)
    b = bias if epilogue and "bias" in epilogue else None
    kw = dict(bm=16, bk=64, bn=32, fused=fused, epilogue=epilogue)
    got = grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(sizes),
                       bias=None if b is None else torch.from_numpy(b), **kw)
    want = j_grouped_gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes),
                          bias=None if b is None else jnp.asarray(b), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(got.numpy(),
                               _j_epilogue_ref(x, w, sizes, bias, epilogue),
                               **F32)


@pytest.mark.parametrize("sizes,t_extra", [([37, 0, 201, 70], 4),
                                           ([60, 60, 60], 33)])
def test_planned_call_matches_reference(sizes, t_extra):
    """The unpinned call (plan from H100_SXM's planner, the fused lowering)
    against the reference's unpinned call; one launch."""
    sizes, x, w, _ = _case(sizes, t_extra, kdim=96, n=160)
    got = grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(sizes))
    want = j_grouped_gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    st = engine.stats()["grouped_gemm"]
    assert st["launches"] == 1 and st["plan_misses"] == 1


def test_bias_epilogue_requires_bias():
    sizes, x, w, _ = _case([8, 8], 0, kdim=16, n=16)
    with pytest.raises(ValueError, match="bias"):
        grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(sizes), epilogue="bias")


def test_wrappers_on_cpu_are_their_plain_versions():
    """On CPU tensors the wrappers return their plain versions' results
    (and launch nothing); the plain versions agree with the oracle."""
    sizes, x, w, bias = _case([37, 0, 201, 70], 4)
    xt, wt, st, bt = (torch.from_numpy(a) for a in (x, w, sizes, bias))
    sched = GroupedTileSchedule(t=x.shape[0], k=100, n=70, num_experts=4,
                                bm=16, bk=32, bn=64)
    table = sched.tables(st)
    n0 = dict(LAUNCHES)
    got = grouped_fused(table, xt, wt, bt, bm=16, bn=64, epilogue="bias")
    torch.testing.assert_close(
        got, grouped_fused_plain(table, xt, wt, bt, epilogue="bias"))
    want = torch.from_numpy(_j_epilogue_ref(x, w, sizes, bias, "bias"))
    torch.testing.assert_close(got, want.float(), **F32)
    t_pad = -(-x.shape[0] // 16) * 16 + 4 * 16
    offs, be, nr = plan_groups(st, 4, 16, t_pad)
    xp, dest = scatter_rows(xt, st, offs, 16, t_pad)
    padded = grouped_padded(xp, wt, be, nr, bt, bm=16, bn=64, epilogue="bias")
    torch.testing.assert_close(
        padded, grouped_padded_plain(xp, wt, be, nr, bt, bm=16,
                                     epilogue="bias"))
    valid = torch.arange(x.shape[0]) < int(sizes.sum())
    torch.testing.assert_close(
        torch.where(valid[:, None], padded[dest], 0.0), want.float(), **F32)
    # blocks past nrows hold the epilogue of a zero accumulator
    assert torch.equal(padded[int(nr[0]):], bt[3].expand(t_pad - int(nr[0]),
                                                         70))
    assert LAUNCHES == n0


def test_wrappers_refuse_bad_operands():
    sizes, x, w, bias = _case([4, 4], 0, kdim=8, n=8)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    table = GroupedTileSchedule(t=8, k=8, n=8, num_experts=2, bm=8, bk=8,
                                bn=8).tables(torch.from_numpy(sizes))
    with pytest.raises(ValueError, match="dtypes differ"):
        grouped_fused(table, xt, wt.double(), bm=16, bn=64)
    with pytest.raises(ValueError, match="bias"):
        grouped_fused(table, xt, wt, bm=16, bn=64, epilogue="bias")
    with pytest.raises(ValueError, match="int32"):
        grouped_fused(table.long(), xt, wt, bm=16, bn=64)
    with pytest.raises(ValueError, match="expected x"):
        grouped_fused(table, xt[None], wt, bm=16, bn=64)


# ---------------------------------------------------------------------------
# the CUDA source against the constants the planner and wrappers use
# ---------------------------------------------------------------------------

GROUPED_CU = (Path(grouped_kernel.__file__).resolve().parent / "csrc"
              / "grouped.cu").read_text()


def _constexpr(name, **names):
    """A ``constexpr int`` of grouped.cu, its expression evaluated over
    ``names``."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);", GROUPED_CU).group(1)
    return eval(expr, {}, names)


def test_kernel_shapes_are_the_machine_blocks():
    """The switch in grouped.cu instantiates kernel.SHAPES in order, with
    the K panel BK: together H100_SXM.grouped_blocks, each within the
    kernel's static shared memory."""
    cases = re.findall(r"case (\d+): fwd_tile<T, (\d+), (\d+)>", GROUPED_CU)
    assert [int(i) for i, _, _ in cases] == \
        list(range(len(grouped_kernel.SHAPES)))
    assert tuple((int(bm), int(bn)) for _, bm, bn in cases) == \
        grouped_kernel.SHAPES
    bk = _constexpr("BK")
    assert set(H100_SXM.grouped_blocks) == \
        {(bm, bk, bn) for bm, bn in grouped_kernel.SHAPES}
    smem = _constexpr("SMEM_BYTES", BK=bk)
    assert max(grouped_smem_bytes(*b) for b in H100_SXM.grouped_blocks) \
        == smem <= H100_SXM.grouped_smem_bytes


# ---------------------------------------------------------------------------
# the forward kernels' routes (kernel.py chooses; grouped.cu runs them)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,k,n", FULL_WIDTH)
def test_main_path_shapes_take_route_a(t, k, n):
    """phi3.5-moe's four full-width expert GEMMs (bf16, 16-byte aligned
    tensors from the allocator) take the TMA ring, whatever the tiling."""
    assert grouped_kernel.choose_route(torch.bfloat16, k, n,
                                       (1 << 20, 1 << 21)) == "A"
    x = torch.zeros((t, 8), dtype=torch.bfloat16)
    w = torch.zeros((2, 8, 16), dtype=torch.bfloat16)
    assert grouped_kernel._route(x, w) == "A"


@pytest.mark.parametrize("k,n,ptrs,route", [
    (1000, 300, (0, 0), "C"),    # a 600-byte weight row (chip_smoke's
                                 # ragged_bf16_bias_silu_planned)
    (100, 160, (0, 0), "C"),     # a 200-byte x row
    (4096, 6400, (2, 0), "C"),   # x 2 bytes past a 16-byte boundary
    (4096, 6400, (0, 8), "C"),   # w 8 bytes past one
    (24, 200, (0, 16), "A"),     # K below one panel: TMA zero-fills it
    (96, 160, (0, 0), "A")])
def test_route_c_takes_what_tma_cannot(k, n, ptrs, route):
    assert grouped_kernel.choose_route(torch.bfloat16, k, n, ptrs) == route
    assert grouped_kernel.choose_route(torch.float32, k, n, ptrs) == "fp32"


def test_cpu_wrappers_count_no_route():
    """The CPU path runs the plain versions: no launch, no route."""
    sizes, x, w, _ = _case([8, 8], 0, kdim=16, n=16)
    xt, wt = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    table = GroupedTileSchedule(t=16, k=16, n=16, num_experts=2, bm=16,
                                bk=16, bn=16).tables(torch.from_numpy(sizes))
    before = dict(grouped_kernel.ROUTES)
    grouped_fused(table, xt, wt, bm=16, bn=64)
    assert grouped_kernel.ROUTES == before
    grouped_kernel.reset_launches()
    assert set(grouped_kernel.ROUTES.values()) == {0}


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


# (dtype, epilogue, bm, bn, group sizes, rows past their sum, K, N, rows
#  past the sum hold NaN, route): the first three are the original cases
#  (K 100: bf16 takes route C); then the wgmma tile as chip_smoke.py drives it:
#  every epilogue, every pinned (bm, bn), row-aware tiles (groups of 1, 17,
#  32, 64 and 65 rows, an empty expert), K below a panel and K off the
#  ring's 6 x 32, route C, NaN past the groups' sum.
_TILE_SIZES = [100, 0, 37, 130]
_ROWS = [1, 17, 0, 32, 64, 65]
CARD_CASES = [
    pytest.param(torch.float32, "bias_silu", 16, 64, [37, 0, 201, 70], 4,
                 100, 70, False, "fp32", id="dtype0-bias_silu-16-64"),
    pytest.param(torch.float32, None, 64, 128, [37, 0, 201, 70], 4, 100, 70,
                 False, "fp32", id="dtype1-None-64-128"),
    pytest.param(torch.bfloat16, "gelu", 128, 128, [37, 0, 201, 70], 4, 100,
                 70, False, "C", id="dtype2-gelu-128-128"),
    *[pytest.param(torch.bfloat16, epi, 128, 128, _TILE_SIZES, 20, 256, 320,
                   False, "A", id=f"tile_epi_{epi}") for epi in EPILOGUES],
    *[pytest.param(torch.bfloat16, "bias_silu", bm, bn, [70, 17, 0, 140], 9,
                   160, 200, False, "A", id=f"tile_shape_{bm}x{bn}")
      for bm, bn in grouped_kernel.SHAPES],
    pytest.param(torch.bfloat16, None, 128, 128, _ROWS, 0, 512, 256, False,
                 "A", id="tile_rows_bm128"),
    pytest.param(torch.bfloat16, "silu", 64, 128, _ROWS, 0, 512, 256, False,
                 "A", id="tile_rows_bm64"),
    pytest.param(torch.bfloat16, "relu", 128, 64, [50, 90], 7, 24, 200, False,
                 "A", id="tile_k24"),
    pytest.param(torch.bfloat16, "gelu", 64, 128, [50, 0, 80], 3, 200, 136,
                 False, "A", id="tile_k200"),
    pytest.param(torch.bfloat16, "bias", 128, 64, [60, 85], 5, 100, 160,
                 False, "C", id="tile_route_c_k100"),
    pytest.param(torch.bfloat16, "bias_silu", 128, 128, [100, 0, 0, 250], 20,
                 1000, 300, False, "C", id="tile_route_c_n300"),
    pytest.param(torch.bfloat16, "silu", 128, 128, [40, 0, 90], 30, 256, 192,
                 True, "A", id="tile_nan_past_sum"),
    pytest.param(torch.bfloat16, "bias", 16, 128, [40, 0, 90], 30, 256, 192,
                 True, "A", id="tile_nan_past_sum_bm16"),
]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dtype,epilogue,bm,bn,sizes,t_extra,k,n,nan_tail,route", CARD_CASES)
def test_forward_kernels_on_card(cuda_device, dtype, epilogue, bm, bn, sizes,
                                 t_extra, k, n, nan_tail, route):
    """Both forwards against their plain versions, one launch each on the
    route choose_route names.  With NaN in the rows past sum(sizes), the
    fused kernel stores zeros there and finite values everywhere; the
    padded one, whose scatter carries those rows into the last group's
    padding, has NaN exactly where its plain version does."""
    sizes, x, w, bias = _case(sizes, t_extra, kdim=k, n=n)
    xt, wt, bt = (torch.from_numpy(a).to(cuda_device, dtype)
                  for a in (x, w, bias))
    total = int(sizes.sum())
    if nan_tail:
        xt[total:] = float("nan")
    st = torch.from_numpy(sizes).to(cuda_device)
    e = len(sizes)
    b = bt if epilogue and "bias" in epilogue else None
    sched = GroupedTileSchedule(t=x.shape[0], k=k, n=n, num_experts=e,
                                bm=min(bm, x.shape[0]), bk=min(32, k),
                                bn=min(bn, n))
    table = sched.tables(st)
    n0, r0 = dict(LAUNCHES), dict(grouped_kernel.ROUTES)
    got = grouped_fused(table, xt, wt, b, bm=bm, bn=bn, epilogue=epilogue)
    t_pad = -(-x.shape[0] // bm) * bm + e * bm
    offs, be, nr = plan_groups(st, e, bm, t_pad)
    xp, _ = scatter_rows(xt, st, offs, bm, t_pad)
    padded = grouped_padded(xp, wt, be, nr, b, bm=bm, bn=bn,
                            epilogue=epilogue)
    torch.cuda.synchronize()
    assert LAUNCHES["grouped_fused"] == n0["grouped_fused"] + 1
    assert LAUNCHES["grouped_padded"] == n0["grouped_padded"] + 1
    assert grouped_kernel.ROUTES[route] == r0[route] + 2
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 else F32
    want = grouped_fused_plain(table, xt, wt, b, epilogue=epilogue)
    assert torch.isfinite(got).all()
    if nan_tail:
        assert not bool(got[total:].any())
    torch.testing.assert_close(got.float(), want.float(), **tol)
    want_p = grouped_padded_plain(xp, wt, be, nr, b, bm=bm,
                                  epilogue=epilogue)
    assert torch.equal(torch.isfinite(padded), torch.isfinite(want_p))
    torch.testing.assert_close(padded.float(), want_p.float(),
                               equal_nan=True, **tol)
