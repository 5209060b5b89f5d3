"""The quantized kernels' routes: which one each call takes, and each route
against its plain version on the card.

``choose_quant_route`` (the dense GEMM's and the grouped GEMM's) is a pure
function of the operands' dtypes, layout, row lengths, base pointers and
the tile table's template bm, so its rule is checked here on the CPU,
with the split factor at Qwen3-0.6B's quant plans and the route of every
main-path shape.  The ``gpu`` tests hold each route to its plain version
on the card: int8 with fp32 outputs exactly (the int32 sums are exact and
the dequant product rounds the same), W8A16 and e4m3 within the bf16
outputs' tolerance, atol = rtol = 2e-2 (the kernels sum bf16 products in
fp32 in another order, then round to bf16).  This file imports no JAX, so
``python -m pytest -m gpu tests/test_torch_quant_routes.py`` runs on the
card's machine.
"""
import itertools

import pytest
import torch

from repro_torch.core import (H100_SXM, GemmDescriptor, GroupedGemmDescriptor,
                              GroupedGemmPlan, plan_gemm, plan_grouped,
                              resolve_quant)
from repro_torch.core.machine import FP8_DTYPE
from repro_torch.kernels.gemm import kernel as gk
from repro_torch.kernels.grouped_gemm import kernel as grk
from repro_torch.kernels.grouped_gemm.ops import _quantize_grouped_w
from repro_torch.optim.compression import quantize_operand

BF, F32, I8 = torch.bfloat16, torch.float32, torch.int8
# (A or x dtype, B or w dtype) of each quant mode: W8A16 with bf16 and
# fp32 activations, full int8, full e4m3.
PAIRS = [(BF, I8), (BF, FP8_DTYPE), (F32, I8), (F32, FP8_DTYPE), (I8, I8),
         (FP8_DTYPE, FP8_DTYPE)]
H100_SMS = 132
# Qwen3-0.6B's seven projections (name, n, k): q, k / v, o, gate, up, down.
QWEN3 = [("q", 2048, 1024), ("kv", 1024, 1024), ("o", 1024, 2048),
         ("gate", 3072, 1024), ("up", 3072, 1024), ("down", 1024, 3072)]
DECODE_ROWS, PREFILL_ROWS = 8, 256  # chip_smoke's continuous slots, prompt


def _expected(a_dtype, k, b_inner, max_bm, ptrs):
    """The rule, restated: fp32 activations take "fp32"; a base or row TMA
    cannot read takes "C"; a decode table "B"; the rest "A"."""
    if a_dtype == F32:
        return "fp32"
    row_bytes = k * (2 if a_dtype == BF else 1)
    if row_bytes % 16 or b_inner % 16 or any(p % 16 for p in ptrs):
        return "C"
    return "B" if max_bm == 16 else "A"


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
@pytest.mark.parametrize("layout", ["nn", "nt"])
@pytest.mark.parametrize("max_bm", [16, 64, 128])
def test_choose_quant_route_rule(pair, layout, max_bm):
    a_dt, b_dt = pair
    ks = [1024, 1000, 1001, 1032]   # 16-byte rows or not, by element size
    ns = [2048, 200, 130]
    bases = [(0, 0), (2, 0), (0, 8), (256, 4096)]
    for k, n, ptrs in itertools.product(ks, ns, bases):
        b_inner = n if layout == "nn" else k
        got = gk.choose_quant_route(a_dt, b_dt, k, n, layout, max_bm, ptrs)
        assert got == _expected(a_dt, k, b_inner, max_bm, ptrs), (k, n, ptrs)


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
@pytest.mark.parametrize("bm", [16, 64, 128])
def test_grouped_choose_quant_route_rule(pair, bm):
    """The bank (E, K, N) is read as the dense GEMM's "nn" B."""
    x_dt, w_dt = pair
    for k, n, ptrs in itertools.product([4096, 100, 129], [6400, 70, 200],
                                        [(0, 0), (4, 0), (0, 2)]):
        got = grk.choose_quant_route(x_dt, w_dt, k, n, bm, ptrs)
        assert got == _expected(x_dt, k, n, bm, ptrs), (k, n, ptrs)


def test_choose_quant_route_takes_8bit_weights_only():
    with pytest.raises(ValueError, match="int8 or float8"):
        gk.choose_quant_route(BF, BF, 1024, 1024, "nn", 16)


def _qwen3_plan(mode, m, n, k):
    a_dt = {"w8a16": "bfloat16", "int8": "int8", "fp8": "float8_e4m3"}[mode]
    desc = GemmDescriptor(m=m, n=n, k=k, layout="nn", in_dtype=a_dt,
                          out_dtype="bfloat16", quant=resolve_quant(mode))
    plan = plan_gemm(desc, H100_SXM)
    assert plan.fused
    return plan.tile_schedule()


# (tiles, split) of each projection: decode (8 rows) runs 8-24 tiles of
# (16, 128), prefill (256 rows) 16-48 of (128, 128); K is split over a
# cluster of up to 8 until the blocks approach the card's 132 SMs.
SPLITS = {
    DECODE_ROWS: {"q": (16, 8), "kv": (8, 8), "o": (8, 8), "gate": (24, 5),
                  "up": (24, 5), "down": (8, 8)},
    PREFILL_ROWS: {"q": (32, 4), "kv": (16, 8), "o": (16, 8),
                   "gate": (48, 2), "up": (48, 2), "down": (16, 8)},
}


@pytest.mark.parametrize("mode", ["w8a16", "int8", "fp8"])
@pytest.mark.parametrize("m", [DECODE_ROWS, PREFILL_ROWS])
def test_split_factor_at_qwen3_quant_plans(mode, m):
    for name, n, k in QWEN3:
        s = _qwen3_plan(mode, m, n, k)
        route = "B" if m == DECODE_ROWS else "A"
        split = gk.split_factor(s.num_tiles, k, H100_SMS, route)
        assert (s.num_tiles, split) == SPLITS[m][name], name
        assert 64 <= s.num_tiles * split <= H100_SMS
    # Route C and the fp32 route never split.
    assert gk.split_factor(8, 1024, H100_SMS, "C") == 1
    assert gk.split_factor(8, 1024, H100_SMS, "fp32") == 1


@pytest.mark.parametrize("mode", ["w8a16", "int8", "fp8"])
@pytest.mark.parametrize("m", [DECODE_ROWS, PREFILL_ROWS])
def test_qwen3_main_path_shapes_take_a_or_b(mode, m):
    """Every projection of the quantized Qwen3 paths: decode tables are bm
    16 alone (route B), prefill tables bm 128 (route A)."""
    a_dt = {"w8a16": BF, "int8": I8, "fp8": FP8_DTYPE}[mode]
    b_dt = FP8_DTYPE if mode == "fp8" else I8
    for name, n, k in QWEN3:
        max_bm = gk.table_max_bm(_qwen3_plan(mode, m, n, k))
        route = gk.choose_quant_route(a_dt, b_dt, k, n, "nn", max_bm)
        assert route == ("B" if m == DECODE_ROWS else "A"), name


@pytest.mark.parametrize("rows,k,n", [(512, 4096, 6400), (512, 6400, 4096),
                                      (4096, 4096, 6400), (4096, 6400, 4096)])
def test_phi35_moe_int8_grouped_shapes_take_a(rows, k, n):
    """phi3.5-moe's expert GEMMs under use(quant="int8") (16 experts, 32
    capacity rows each at decode, 256 at prefill): bm-128 tiles, route A."""
    desc = GroupedGemmDescriptor(t=rows, k=k, n=n, num_experts=16,
                                 dtype="bfloat16",
                                 quant=resolve_quant("int8"))
    plan = plan_grouped(desc, H100_SXM)
    assert plan.fused and plan.bm == 128
    assert grk.choose_quant_route(I8, I8, k, n, plan.bm) == "A"


def test_cpu_wrappers_count_no_route():
    """On CPU tensors the wrappers run their plain versions: no launch, no
    route counted."""
    gen = torch.Generator().manual_seed(0)
    spec = resolve_quant("int8")
    a = torch.randn(8, 64, generator=gen)
    b = torch.randn(64, 128, generator=gen)
    bq, sb = quantize_operand(b, spec, axis=1)
    aq, sa = quantize_operand(a, spec, axis=0)
    plan = plan_gemm(GemmDescriptor(m=8, n=128, k=64, in_dtype="int8",
                                    out_dtype="float32", quant=spec))
    exe = gk.FusedGemm(plan.tile_schedule(), "cpu")
    routes, launches = dict(gk.QUANT_ROUTES), dict(gk.LAUNCHES)
    gk.gemm_quant(exe, aq, bq, sa, sb)
    assert gk.QUANT_ROUTES == routes and gk.LAUNCHES == launches

    x = torch.randn(40, 64, generator=gen)
    w = torch.randn(3, 64, 128, generator=gen)
    wq, sw = _quantize_grouped_w(w, spec)
    xq, sx = quantize_operand(x, spec, axis=0)
    desc = GroupedGemmDescriptor(t=40, k=64, n=128, num_experts=3,
                                 dtype="float32", quant=spec)
    plan = GroupedGemmPlan(desc, 16, 32, 128, fused=True)
    table = plan.tile_schedule().tables(torch.tensor([10, 0, 30],
                                                     dtype=torch.int32))
    groutes, glaunches = dict(grk.QUANT_ROUTES), dict(grk.LAUNCHES)
    grk.grouped_quant(table, xq, wq, sx, sw, bm=16, bn=128)
    assert grk.QUANT_ROUTES == groutes and grk.LAUNCHES == glaunches


def test_reset_launches_clears_the_quant_routes():
    gk.QUANT_ROUTES["A"] += 1
    grk.QUANT_ROUTES["B"] += 1
    gk.reset_launches()
    grk.reset_launches()
    assert not any(gk.QUANT_ROUTES.values())
    assert not any(grk.QUANT_ROUTES.values())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


BF16_TOL = 2e-2

# (label, mode, m, n, k, layout, epilogue, A dtype, out dtype, route)
GEMM_CASES = [
    ("int8_k3072_nn", "int8", 256, 1024, 3072, "nn", None, "bfloat16",
     "float32", "A"),
    ("int8_k3072_nt", "int8", 256, 1024, 3072, "nt", None, "bfloat16",
     "float32", "A"),
    ("int8_k6400_nn", "int8", 64, 256, 6400, "nn", "relu", "bfloat16",
     "float32", "A"),
    ("int8_k6400_nt", "int8", 64, 256, 6400, "nt", None, "bfloat16",
     "float32", "A"),
    ("int8_decode_k3072_nn", "int8", 8, 1024, 3072, "nn", None, "bfloat16",
     "float32", "B"),
    ("int8_decode_k6400_nt", "int8", 8, 256, 6400, "nt", None, "bfloat16",
     "float32", "B"),
    ("w8a16_decode_q", "w8a16", 8, 2048, 1024, "nn", None, "bfloat16",
     "bfloat16", "B"),
    ("w8a16_prefill_gate_silu", "w8a16", 256, 3072, 1024, "nn", "silu",
     "bfloat16", "bfloat16", "A"),
    ("w8a16_nt_bias_gelu", "w8a16", 300, 208, 144, "nt", "bias_gelu",
     "bfloat16", "bfloat16", "A"),
    ("fp8_decode_down", "fp8", 8, 1024, 3072, "nn", None, "bfloat16",
     "bfloat16", "B"),
    ("fp8_prefill_q", "fp8", 256, 2048, 1024, "nn", None, "bfloat16",
     "bfloat16", "A"),
    ("fp8_nt_bias_silu", "fp8", 77, 128, 96, "nt", "bias_silu", "bfloat16",
     "bfloat16", "A"),
    ("int8_route_c_k129", "int8", 300, 200, 129, "nt", "bias_gelu",
     "bfloat16", "float32", "C"),
    ("w8a16_f32", "w8a16", 77, 130, 100, "nn", "relu", "float32", "float32",
     "fp32"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GEMM_CASES, ids=[c[0] for c in GEMM_CASES])
def test_gemm_quant_routes_on_card(case, cuda_device):
    (label, mode, m, n, k, layout, epi, adt, odt, route) = case
    spec = resolve_quant(mode)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn((m, k), generator=gen, device=cuda_device).to(
        getattr(torch, adt))
    b = torch.randn((k, n) if layout == "nn" else (n, k), generator=gen,
                    device=cuda_device) * k ** -0.5
    bias = torch.randn((n,), generator=gen, device=cuda_device) \
        if epi and epi.startswith("bias") else None
    bq, sb = quantize_operand(b, spec, axis=1 if layout == "nn" else 0)
    aq, sa = (a, None) if spec.weight_only else \
        quantize_operand(a, spec, axis=0)
    in_dt = str(aq.dtype).replace("torch.", "").replace("float8_e4m3fn",
                                                        "float8_e4m3")
    plan = plan_gemm(GemmDescriptor(m=m, n=n, k=k, layout=layout,
                                    in_dtype=in_dt, out_dtype=odt,
                                    epilogue=epi, quant=spec))
    exe = gk.FusedGemm(plan.tile_schedule(), cuda_device)
    kw = dict(layout=layout, epilogue=epi, bias=bias,
              out_dtype=getattr(torch, odt))
    before = dict(gk.QUANT_ROUTES)
    got = gk.gemm_quant(exe, aq, bq, sa, sb, **kw)
    torch.cuda.synchronize()
    assert [r for r in gk.QUANT_ROUTES
            if gk.QUANT_ROUTES[r] != before[r]] == [route]
    want = gk.gemm_quant_plain(aq, bq, sa, sb, **kw)
    if mode == "int8" and epi in (None, "relu"):
        assert torch.equal(got, want)
    else:
        tol = BF16_TOL if odt == "bfloat16" else 1e-5
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


# (label, mode, group sizes, rows past their sum, K, N, epilogue, x dtype,
#  out dtype, (bm, bn) or None for the planner's, NaN past the sum, route)
GROUPED_CASES = [
    ("int8_decode_32_rows_bm128", "int8", [32, 0, 32, 32], 0, 512, 640,
     None, "bfloat16", "float32", (128, 128), False, "A"),
    ("int8_empty_expert_nan_tail", "int8", [32, 0, 40, 100], 7, 512, 640,
     "silu", "bfloat16", "float32", (128, 128), True, "A"),
    ("int8_bm64_rows", "int8", [1, 17, 0, 64, 65], 0, 256, 192, "relu",
     "bfloat16", "float32", (64, 128), False, "A"),
    ("int8_bm16", "int8", [32, 0, 40, 100], 7, 512, 640, None, "bfloat16",
     "float32", (16, 128), True, "B"),
    ("w8a16_bm128_nan_tail", "w8a16", [13, 0, 40, 7], 5, 256, 320, "gelu",
     "bfloat16", "bfloat16", (128, 128), True, "A"),
    ("w8a16_bm16", "w8a16", [13, 0, 40, 7], 5, 256, 320, "bias_silu",
     "bfloat16", "bfloat16", (16, 64), False, "B"),
    ("fp8_bm128_bias", "fp8", [37, 0, 201, 70], 4, 128, 192, "bias_silu",
     "bfloat16", "bfloat16", (128, 128), True, "A"),
    ("int8_route_c_k100", "int8", [37, 0, 201, 70], 4, 100, 70, "bias_silu",
     "bfloat16", "float32", None, False, "C"),
    ("w8a16_f32", "w8a16", [13, 0, 40, 7], 5, 129, 200, "gelu", "float32",
     "float32", None, False, "fp32"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GROUPED_CASES,
                         ids=[c[0] for c in GROUPED_CASES])
def test_grouped_quant_routes_on_card(case, cuda_device):
    """An empty expert, 32-row groups on bm-128 tiles (one warpgroup's
    products), and NaN in the rows past the groups' sum (no tile owns
    them; int8 x carries it in its row scales) never reaching a stored
    element."""
    (label, mode, sizes, extra, k, n, epi, xdt, odt, tiles, nan_tail,
     route) = case
    spec = resolve_quant(mode)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    e, total = len(sizes), sum(sizes)
    t = total + extra
    x = torch.randn((t, k), generator=gen, device=cuda_device).to(
        getattr(torch, xdt))
    w = torch.randn((e, k, n), generator=gen, device=cuda_device) * k ** -0.5
    bias = torch.randn((e, n), generator=gen, device=cuda_device) \
        if epi and epi.startswith("bias") else None
    wq, sw = _quantize_grouped_w(w, spec)
    xq, sx = (x, None) if spec.weight_only else \
        quantize_operand(x, spec, axis=0)
    if nan_tail:
        if xq.dtype != torch.int8:
            xq[total:] = float("nan")
        if sx is not None:
            sx[total:] = float("nan")
    desc = GroupedGemmDescriptor(t=t, k=k, n=n, num_experts=e, dtype=xdt,
                                 epilogue=epi, quant=spec)
    plan = plan_grouped(desc) if tiles is None else \
        GroupedGemmPlan(desc, tiles[0], 32, tiles[1], fused=True)
    table = plan.tile_schedule().tables(
        torch.tensor(sizes, dtype=torch.int32, device=cuda_device))
    kw = dict(epilogue=epi, out_dtype=getattr(torch, odt))
    before = dict(grk.QUANT_ROUTES)
    got = grk.grouped_quant(table, xq, wq, sx, sw, bias, bm=plan.bm,
                            bn=plan.bn, **kw)
    torch.cuda.synchronize()
    assert [r for r in grk.QUANT_ROUTES
            if grk.QUANT_ROUTES[r] != before[r]] == [route]
    want = grk.grouped_quant_plain(table, xq, wq, sx, sw, bias, **kw)
    assert torch.isfinite(got).all()
    assert not got[total:].any()  # rows past the sum: zeros
    if mode == "int8" and epi in (None, "relu"):
        assert torch.equal(got, want)
    else:
        tol = BF16_TOL if odt == "bfloat16" else 1e-5
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
