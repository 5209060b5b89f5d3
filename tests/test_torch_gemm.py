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
from repro_torch.kernels.gemm import kernel as gk
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
    """A padded-edge descriptor runs: the fused walk masks its edges, the
    multi-launch lowering pads each region's operands to whole blocks and
    slices the result back, as the reference's does; both equal the
    reference's Pallas GEMM under the same TPU_V5E plan (atol = rtol =
    1e-4, fp32)."""
    ops = _operands(20, 70, 40, "nn")
    (ja, jb, _, _), (ta, tb, _, _) = _both(ops, "float32")
    with jcore.use(backend="pallas"):
        want = j_gemm(ja, jb, edge="pad", fused=fused)
    with use(machine="tpu_v5e"):
        engine.reset_stats()
        got = gemm(ta, tb, edge="pad", fused=fused)
        desc = GemmDescriptor(m=20, n=70, k=40, edge="pad")
        assert engine.stats()["gemm"]["launches"] == \
            (1 if fused else len(plan_gemm(desc).regions))
    _close(got, want, "float32")


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



# ---------------------------------------------------------------------------
# Kernel routes (kernel.py chooses; gemm.cu runs them)
# ---------------------------------------------------------------------------

# The bf16 GEMMs of the chip_smoke main path: Qwen3-0.6B (d 1024, q 2048,
# kv 1024, ff 3072, vocab 151,936, tied nt read-out), mamba2-130m (d 768,
# in_proj 3352, inner 1536, vocab 50,280) and phi3.5-moe (d 4096, kv 1024,
# vocab 32,064, nn read-out), at their serving, decode and training rows.
def _main_path_shapes():
    shapes = []
    for m in (1024, 4):
        shapes += [(m, 2048, 1024, "nn"), (m, 1024, 1024, "nn"),
                   (m, 1024, 2048, "nn"), (m, 3072, 1024, "nn"),
                   (m, 1024, 3072, "nn")]
    shapes += [(4, 151936, 1024, "nt"), (1024, 151936, 1024, "nt")]
    for m in (4000, 4, 8192):
        shapes += [(m, 3352, 768, "nn"), (m, 768, 1536, "nn")]
    shapes += [(4, 50280, 768, "nt"), (8192, 50280, 768, "nt")]
    for m in (1024, 4):
        shapes += [(m, 4096, 4096, "nn"), (m, 1024, 4096, "nn")]
    shapes += [(4, 32064, 4096, "nn"), (1024, 32064, 4096, "nn")]
    return shapes


@pytest.mark.parametrize("m,n,k", [(1024, 151936, 1024), (4000, 3352, 768),
                                   (997, 1003, 1001), (4, 1024, 1024)])
def test_raster_order_permutes_the_table_in_bands(m, n, k):
    """The table the fused kernel walks holds the schedule's rows, each
    once, a region's rows in bands of RASTER_ROWS tile rows taken column
    by column."""
    sched = plan_gemm(GemmDescriptor(m=m, n=n, k=k, in_dtype="bfloat16",
                                     out_dtype="bfloat16")).tile_schedule()
    order = gk.raster_order(sched)
    assert sorted(order) == sorted(sched.tiles)
    for prev, row in zip(order, order[1:]):
        if prev[6] != row[6]:
            continue
        band = gk.RASTER_ROWS * sched.blocks[row[6]][0]
        assert (prev[0] // band, prev[1], prev[0]) < \
            (row[0] // band, row[1], row[0])


@pytest.mark.parametrize("m,n,k,layout", _main_path_shapes())
def test_main_path_shapes_take_route_a_or_b(m, n, k, layout):
    """Every main-path bf16 GEMM is TMA-legal: decode tables (bm 16) take
    route B, the rest route A, fused and per region alike."""
    plan = plan_gemm(GemmDescriptor(m=m, n=n, k=k, layout=layout,
                                    in_dtype="bfloat16",
                                    out_dtype="bfloat16"))
    want = "B" if m <= 16 else "A"
    max_bm = gk.table_max_bm(plan.tile_schedule())
    assert gk.choose_route(torch.bfloat16, k, k if layout == "nt" else n,
                           max_bm, (256, 512)) == want
    for r in plan.regions:
        assert gk.choose_route(torch.bfloat16, k, k if layout == "nt" else n,
                               r.bm) == ("B" if r.bm <= 16 else "A")


@pytest.mark.parametrize("k,b_inner,ptrs,route", [
    (1001, 1001, (0, 0), "C"),     # chip_smoke's ragged_bias_gelu_acc_nt
    (1024, 1003, (0, 0), "C"),     # an nn B of 1003 columns
    (1024, 1024, (2, 0), "C"),     # A starts 2 bytes past an alignment
    (1024, 1024, (0, 16), "A"),
    (24, 64, (0, 0), "A")])
def test_route_c_takes_what_tma_cannot(k, b_inner, ptrs, route):
    assert gk.choose_route(torch.bfloat16, k, b_inner, 128, ptrs) == route
    assert gk.choose_route(torch.float32, k, b_inner, 128, ptrs) == "fp32"


@pytest.mark.parametrize("tiles,k,sms,route,split", [
    (8, 1024, 132, "B", 8),      # Qwen3 decode k / v / o / down
    (16, 2048, 132, "B", 8),     # decode q
    (24, 1024, 132, "B", 5),     # decode gate / up
    (32, 4096, 132, "B", 4),     # phi3.5 decode q / o
    (64, 1024, 132, "A", 2),     # Qwen3 prefill kv (128 x 128 tiles)
    (1187, 1024, 132, "B", 1),   # the tied read-out at decode
    (8, 24, 132, "B", 1),        # one K panel
    (8, 96, 132, "B", 1),        # three panels: below a share's minimum
    (8, 1096, 132, "B", 8),      # 35 panels over 8 blocks
    (8, 1024, 132, "C", 1),      # route C never splits
    (8, 1024, 132, "fp32", 1),
    (100, 1024, 132, "A", 1)])
def test_split_factor(tiles, k, sms, route, split):
    assert gk.split_factor(tiles, k, sms, route) == split
    assert 1 <= split <= gk.MAX_CLUSTER
    if split > 1:
        assert -(-k // gk.K_PANEL) // split >= gk.MIN_SPLIT_PANELS


# (label, m, n, k, layout, epilogue, accumulate, nb, dtype, out dtype,
#  route, split > 1)
ROUTE_CASES = [
    ("epi_silu", 256, 384, 320, "nn", "silu", False, 0, "bfloat16",
     "bfloat16", "A", False),
    ("epi_relu_nt", 256, 384, 320, "nt", "relu", False, 0, "bfloat16",
     "bfloat16", "A", False),
    ("epi_bias_silu_acc", 200, 320, 256, "nn", "bias_silu", True, 0,
     "bfloat16", "bfloat16", "A", False),
    ("epi_gelu_nt_acc", 130, 200, 256, "nt", "gelu", True, 0, "bfloat16",
     "bfloat16", "A", False),
    ("epi_bias_gelu_f32out", 70, 136, 128, "nn", "bias_gelu", True, 0,
     "bfloat16", "float32", "A", False),
    ("batched3_nt", 100, 200, 96, "nt", "bias_silu", True, 3, "bfloat16",
     "bfloat16", "A", False),
    ("batched3_nn", 100, 200, 96, "nn", None, False, 3, "bfloat16",
     "bfloat16", "A", False),
    ("k24", 96, 200, 24, "nn", None, False, 0, "bfloat16", "bfloat16", "A",
     False),
    ("k1000_nt", 140, 260, 1000, "nt", None, False, 0, "bfloat16",
     "bfloat16", "A", True),
    ("m1", 1, 320, 512, "nn", "silu", False, 0, "bfloat16", "bfloat16",
     "B", True),
    ("m8_nt_bias_acc", 8, 320, 512, "nt", "bias", True, 0, "bfloat16",
     "bfloat16", "B", True),
    ("m16", 16, 320, 512, "nn", None, False, 0, "bfloat16", "bfloat16", "B",
     True),
    ("m17", 17, 320, 512, "nt", None, False, 0, "bfloat16", "bfloat16",
     "A", True),
    ("m65", 65, 320, 512, "nn", None, False, 0, "bfloat16", "bfloat16",
     "A", True),
    ("m129", 129, 320, 512, "nt", None, False, 0, "bfloat16", "bfloat16",
     "A", True),
    ("rows192", 1024, 3072, 256, "nn", None, False, 0, "bfloat16",
     "bfloat16", "A", False),
    ("route_c_nt_k1001", 97, 103, 1001, "nt", "bias_gelu", True, 0,
     "bfloat16", "bfloat16", "C", False),
    ("route_c_nn_n1003", 65, 1003, 256, "nn", "silu", False, 0, "bfloat16",
     "bfloat16", "C", False),
    ("decode_split_k1096", 4, 1024, 1096, "nn", "silu", False, 0,
     "bfloat16", "bfloat16", "B", True),
    ("decode_split_nt", 4, 1024, 1024, "nt", None, False, 0, "bfloat16",
     "bfloat16", "B", True),
    ("f32_relu_acc", 300, 500, 129, "nn", "relu", True, 0, "float32",
     "float32", "fp32", False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_gemm_routes_on_card(case, cuda_device):
    """Each route against its plain version on the card: every epilogue,
    accumulate, batches, short and ragged K, decode rows with split K,
    mixed tables (bm 128 beside bm 16 strips), and operands TMA cannot
    read.  ``splits``: the fused launch splits K over a cluster."""
    (label, m, n, k, layout, epi, acc, nb, dname, oname, route,
     splits) = case
    dt, odt = getattr(torch, dname), getattr(torch, oname)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    nbx = max(nb, 1)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cuda_device)
                * scale).to(dt)

    a = rnd(nbx, m, k)
    b = rnd(nbx, *((k, n) if layout == "nn" else (n, k)), scale=k ** -0.5)
    bias = rnd(n) if epi and epi.startswith("bias") else None
    c = rnd(nbx, m, n) if acc else None
    plan = plan_gemm(GemmDescriptor(m=m, n=n, k=k, layout=layout,
                                    in_dtype=dname, out_dtype=oname,
                                    epilogue=epi, accumulate=acc, batch=nb))
    exe = FusedGemm(plan.tile_schedule(), cuda_device)
    kw = dict(layout=layout, epilogue=epi, bias=bias, c=c)
    before = dict(gk.ROUTES)
    got = gemm_fused(exe, a, b, out_dtype=odt, **kw)
    torch.cuda.synchronize()
    taken = [r for r in gk.ROUTES if gk.ROUTES[r] != before[r]]
    assert taken == [route]
    want = gemm_fused_plain(exe.schedule, a, b, out_dtype=odt, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[oname],
                               rtol=TOL[oname])
    if splits:
        assert gk.split_factor(exe.schedule.num_tiles * nbx, k,
                               gk.sm_count(cuda_device), route) > 1
    out = torch.full_like(want, float("nan"))
    ref = torch.full_like(want, float("nan"))
    for r in plan.regions:
        gemm_region(a, b, out, r, **kw)
        gemm_region_plain(a, b, ref, r, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()  # every element stored
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[oname],
                               rtol=TOL[oname])


@pytest.mark.gpu
def test_gemm_route_c_unaligned_base_on_card(cuda_device):
    """A bf16 A whose base is 2 bytes past a 16-byte boundary takes route
    C; the result equals the aligned copy's route-A result's plain
    version."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    m, n, k = 70, 192, 256
    store = torch.randn(m * k + 1, generator=gen,
                        device=cuda_device).bfloat16()
    a = store[1:].view(1, m, k)
    b = (torch.randn(1, k, n, generator=gen, device=cuda_device)
         * k ** -0.5).bfloat16()
    plan = plan_gemm(GemmDescriptor(m=m, n=n, k=k, in_dtype="bfloat16",
                                    out_dtype="bfloat16"))
    exe = FusedGemm(plan.tile_schedule(), cuda_device)
    before = gk.ROUTES["C"]
    got = gemm_fused(exe, a, b, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert gk.ROUTES["C"] == before + 1
    want = gemm_fused_plain(exe.schedule, a, b, out_dtype=torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
