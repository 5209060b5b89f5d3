"""The CUDA sources against the constants the Python side plans with.

The GEMM and flash kernels fix their block shapes at compile time, while
the planners read them from the ``H100_SXM`` machine model and the
wrappers from ``kernel.py``.  The card is the only place the kernels
run, so these checks read the constants out of the ``.cu`` files here.
Also: where the nvcc build writes its libraries.
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.core import H100_SXM
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.gemm import kernel as gemm_kernel
from repro_torch.kernels.ssd_chunk import kernel as ssd_kernel
from repro_torch.kernels.transpose import kernel as transpose_kernel

KERNELS = Path(gemm_kernel.__file__).resolve().parents[1]
# gemm.cu with the header that holds its bf16 tile (the ring's constants
# and formulas), which the grouped GEMM's forward includes too.
WGMMA_TILE = (KERNELS / "gemm" / "csrc" / "wgmma_tile.cuh").read_text()
GEMM_CU = (KERNELS / "gemm" / "csrc" / "gemm.cu").read_text() + WGMMA_TILE
GROUPED_CU = (KERNELS / "grouped_gemm" / "csrc" / "grouped.cu").read_text()
FLASH_CU = (KERNELS / "flash_attention" / "csrc" / "flash_fwd.cu").read_text()
FLASH_BWD_CU = (KERNELS / "flash_attention" / "csrc"
                / "flash_bwd.cu").read_text()
FLASH_DECODE_CU = (KERNELS / "flash_attention" / "csrc"
                   / "flash_decode.cu").read_text()
SSD_CSRC = KERNELS / "ssd_chunk" / "csrc"
SSD_COMMON = (SSD_CSRC / "ssd_common.cuh").read_text()
SSD_SCAN_CU = (SSD_CSRC / "ssd_scan.cu").read_text()
SSD_BWD_CU = (SSD_CSRC / "ssd_scan_bwd.cu").read_text()
TRANSPOSE_CU = (KERNELS / "transpose" / "csrc" / "transpose.cu").read_text()


def _constexpr(src, name):
    return float(re.search(rf"constexpr \w+ {name} = ([-\d.e]+)f?;",
                           src).group(1))


def _c_function(src, name):
    """A one-line ``return <ternary>;`` device function as a Python one."""
    body = re.search(rf"int {name}\(int shape\) {{\s*return ([^;]+);",
                     src).group(1)

    def python(expr):  # c ? a : rest  ->  (a if c else rest)
        if "?" not in expr:
            return expr
        cond, rest = expr.split("?", 1)
        then, other = rest.split(":", 1)
        return f"({then} if {cond} else {python(other)})"

    code = python(body)
    return lambda shape: eval(code, {}, {"shape": shape})


def test_gemm_switch_order_is_template_shapes():
    cases = re.findall(r"case (\d+): tile<T, (\d+), (\d+)>", GEMM_CU)
    assert [int(i) for i, _, _ in cases] == \
        list(range(len(gemm_kernel.TEMPLATE_SHAPES)))
    assert tuple((int(bm), int(bn)) for _, bm, bn in cases) == \
        gemm_kernel.TEMPLATE_SHAPES
    loop = re.search(r"for \(int shape = 0; shape < (\d+);", GEMM_CU)
    assert int(loop.group(1)) == len(gemm_kernel.TEMPLATE_SHAPES)


@pytest.mark.parametrize("shape", range(6))
def test_gemm_shape_functions_match_switch(shape):
    bm, bn = gemm_kernel.TEMPLATE_SHAPES[shape]
    assert _c_function(GEMM_CU, "shape_bm")(shape) == bm
    assert _c_function(GEMM_CU, "shape_bn")(shape) == bn


def test_gemm_k_panel_is_machine_k_panel():
    assert _constexpr(GEMM_CU, "BK") == gemm_kernel.K_PANEL == H100_SXM.k_panel


def test_gemm_cluster_and_raster_constants_match_kernel_py():
    """The split-K cluster limit and the band height of the tile order are
    gemm.cu's and kernel.py's alike (H100_SXM carries the cluster limit);
    the bf16 block is at most two consumer warpgroups and the producer
    warp, two blocks an SM."""
    assert _constexpr(GEMM_CU, "MAX_CLUSTER") == gemm_kernel.MAX_CLUSTER \
        == H100_SXM.gemm_max_cluster
    assert _constexpr(GEMM_CU, "RASTER_ROWS") == gemm_kernel.RASTER_ROWS
    assert (_constexpr(GEMM_CU, "WG_THREADS"),
            _constexpr(GEMM_CU, "PRODUCER_THREADS"),
            _constexpr(GEMM_CU, "LD_WARPGROUPS")) == (128, 32, 2)
    assert re.search(r"__launch_bounds__\(2 \* WG_THREADS \+ "
                     r"PRODUCER_THREADS, 2\)", GEMM_CU)


@pytest.mark.parametrize("nwg", [1, 2])
def test_gemm_dynamic_shared_memory_fits_h100(nwg):
    """Each bf16 block's dynamic shared memory at STAGES stages (gemm.cu's
    formulas) fits a block's 227 KB with two blocks an SM, holds the
    epilogue's staged fp32 tile, and route C's block fits too."""
    assert "return 1024 + STAGES * stage_bytes(nwg) + 2 * STAGES * 8;" \
        in GEMM_CU
    assert "return a_slot(nwg) + B_SLOT;" in GEMM_CU
    assert "constexpr int a_slot(int nwg) { return nwg * 64 * ROWB; }" \
        in GEMM_CU
    assert "constexpr int B_SLOT = 128 * ROWB;" in GEMM_CU
    assert "constexpr int ROWB = 2 * BK;" in GEMM_CU
    assert "constexpr int STAGED_TILE_BYTES = 128 * (128 + 4) * 4;" in GEMM_CU
    assert "constexpr int LD_SMEM = 1024 + STAGED_TILE_BYTES;" in GEMM_CU
    stages, bk = _constexpr(GEMM_CU, "STAGES"), _constexpr(GEMM_CU, "BK")
    assert 3 <= stages <= 6
    stage = (nwg * 64 + 128) * 2 * bk
    ring = 1024 + stages * stage + 2 * stages * 8
    assert 2 * ring <= H100_SXM.vmem_bytes
    assert stages * stage >= 64 * nwg * (128 + 4) * 4  # the staged tile
    assert 1024 + 128 * (128 + 4) * 4 <= H100_SXM.vmem_bytes  # route C


@pytest.mark.parametrize("fn", ["gemm_fused", "gemm_region",
                                "gemm_act_bwd"])
def test_gemm_c_signatures_match_the_ctypes_declarations(fn):
    """Each extern "C" entry of gemm.cu takes the pointers and ints, in
    that order, that kernel.py declares for ctypes (a mismatch shows only
    as a wrong launch on the card)."""
    sig = re.search(rf'extern "C" int {fn}\(([^)]*)\)', GEMM_CU).group(1)
    kinds = ["P" if "*" in arg else "I" for arg in sig.split(",")]
    decl = re.search(rf"lib\.{fn}\.argtypes = \[P\] \* (\d+) \+ "
                     rf"\[I\] \* (\d+) \+ \[P\]",
                     Path(gemm_kernel.__file__).read_text())
    npre, nint = int(decl.group(1)), int(decl.group(2))
    assert kinds == ["P"] * npre + ["I"] * nint + ["P"]


def test_the_wgmma_tile_header_is_shared():
    """gemm.cu and grouped.cu include one bf16 tile header, so the grouped
    forward's ring, routes and epilogue are the dense GEMM's."""
    assert '#include "wgmma_tile.cuh"' in GEMM_CU
    assert '#include "../../gemm/csrc/wgmma_tile.cuh"' in GROUPED_CU
    assert '#include "gemm_sm90.cuh"' in WGMMA_TILE


def test_grouped_wgmma_constants_match_kernel_py_and_machine():
    """grouped.cu's bf16 forward: the header's K panel is grouped.cu's BK
    and every H100_SXM.grouped_blocks bk; each bm of kernel.SHAPES is one
    16-row A box or whole A boxes of ABOX rows, one consumer warpgroup per
    box (route A) beside the producer warp, within the launch bounds of
    two blocks an SM; route C runs LD_WARPGROUPS warpgroups."""
    from repro_torch.kernels.grouped_gemm import kernel as grouped_kernel
    bk = _constexpr(WGMMA_TILE, "BK")
    assert bk == _constexpr(GROUPED_CU, "BK") == H100_SXM.k_panel
    assert {b[1] for b in H100_SXM.grouped_blocks} == {bk}
    abox = _constexpr(WGMMA_TILE, "ABOX")
    wg, prod = (_constexpr(WGMMA_TILE, "WG_THREADS"),
                _constexpr(WGMMA_TILE, "PRODUCER_THREADS"))
    assert (abox, wg, prod) == (64, 128, 32)
    assert "src.nwg = bm > 64 ? 2 : 1;" in GROUPED_CU
    assert "src.nwg = wgt::LD_WARPGROUPS;" in GROUPED_CU
    assert re.search(r"__launch_bounds__\(2 \* wgt::WG_THREADS \+ "
                     r"wgt::PRODUCER_THREADS,\s+2\)", GROUPED_CU)
    for bm, _ in grouped_kernel.SHAPES:
        nwg = 2 if bm > 64 else 1
        assert bm == 16 or bm == nwg * abox
        assert nwg * wg + prod <= 2 * wg + prod
    assert _constexpr(WGMMA_TILE, "LD_WARPGROUPS") * wg <= 2 * wg + prod


def test_grouped_wgmma_switch_order_is_shapes():
    """The bf16 tile routines are instantiated once per (route, shape), in
    kernel.SHAPES order: six shapes on each of the two routes."""
    from repro_torch.kernels.grouped_gemm import kernel as grouped_kernel
    cases = re.findall(r"case (\d+): R::template run<(\d+), (\d+)>",
                       GROUPED_CU)
    assert [int(i) for i, _, _ in cases] == \
        list(range(len(grouped_kernel.SHAPES)))
    assert tuple((int(bm), int(bn)) for _, bm, bn in cases) == \
        grouped_kernel.SHAPES
    assert len(re.findall(r"launch_wgmma<wgt::(\w+)>", GROUPED_CU)) == 2


@pytest.mark.parametrize("bm,bn", [(16, 64), (16, 128), (64, 64), (64, 128),
                                   (128, 64), (128, 128)])
def test_grouped_wgmma_shared_memory_fits_h100(bm, bn):
    """Each bf16 shape's dynamic shared memory at STAGES stages (the
    header's formulas, grouped.cu's warpgroups) fits a block's 232,448
    bytes twice, so two blocks share an SM, and its ring holds the staged
    fp32 tile; route C's block fits too."""
    from repro_torch.kernels.grouped_gemm import kernel as grouped_kernel
    assert (bm, bn) in grouped_kernel.SHAPES
    assert "tma ? wgt::ring_bytes(src.nwg) : wgt::LD_SMEM" in GROUPED_CU
    assert "tma ? wgt::ring_bytes(2) : wgt::LD_SMEM" in GROUPED_CU
    stages, bk = _constexpr(WGMMA_TILE, "STAGES"), _constexpr(WGMMA_TILE,
                                                               "BK")
    nwg = 2 if bm > 64 else 1
    ring = 1024 + stages * (nwg * 64 + 128) * 2 * bk + 2 * stages * 8
    assert 2 * ring <= H100_SXM.vmem_bytes
    assert stages * (nwg * 64 + 128) * 2 * bk >= bm * (bn + 4) * 4
    assert 1024 + 128 * (128 + 4) * 4 <= H100_SXM.vmem_bytes  # route C


def test_flash_limits_match_kernel_py():
    assert _constexpr(FLASH_CU, "BQ_MAX") == flash_kernel.MAX_BLOCK
    assert _constexpr(FLASH_CU, "BK_MAX") == flash_kernel.MAX_BLOCK
    assert _constexpr(FLASH_CU, "D_MAX") == flash_kernel.MAX_HEAD_DIM
    assert _constexpr(FLASH_CU, "NEG_INF") == flash_kernel.NEG_INF


def test_flash_fwd_includes_the_gemm_building_blocks():
    """Route A's TMA, mbarrier and wgmma PTX are the dense GEMM's, and its
    tensor-map encoder is the shared tile header's."""
    assert '#include "../../gemm/csrc/gemm_sm90.cuh"' in FLASH_CU
    assert '#include "../../gemm/csrc/wgmma_tile.cuh"' in FLASH_CU
    assert "wgt::make_map(" in FLASH_CU


def test_flash_fwd_routes_match_kernel_py():
    """flash_fwd.cu's route codes are kernel.py's; fp32 runs CUDA cores
    whatever the code."""
    assert "enum { ROUTE_A = 0, ROUTE_C = 1 };" in FLASH_CU
    assert flash_kernel._ROUTE_CODE["A"] == 0
    assert flash_kernel._ROUTE_CODE["C"] == 1
    assert set(flash_kernel.ROUTES) == {"A", "C", "fp32"}


def test_flash_fwd_ring_matches_kernel_py_and_fits_two_blocks():
    """Route A's ring stages and dynamic shared memory (flash_fwd.cu's
    STAGES and TC_SMEM) are kernel.py's RING_STAGES and RING_SMEM_BYTES:
    1024 bytes of slack, Q's D_MAX / 32 boxes of 4096 bytes, STAGES stages
    of K and V, two 64 x 64 bf16 P buffers and the mbarriers.  At least
    two stages keep the next window's loads in flight, and two blocks fit
    the 232,448 bytes a block may take."""
    stages = _constexpr(FLASH_CU, "STAGES")
    assert stages == flash_kernel.RING_STAGES >= 2
    box = _constexpr(FLASH_CU, "BOX")
    assert box == 64 * 64
    assert "constexpr int Q_BYTES = D_MAX / 32 * BOX;" in FLASH_CU
    assert "constexpr int KV_BYTES = 2 * D_MAX / 32 * BOX;" in FLASH_CU
    assert "constexpr int P_BYTES = BQ_MAX * BK_MAX * 2;" in FLASH_CU
    assert re.search(r"constexpr int TC_SMEM =\s+1024 \+ Q_BYTES \+ STAGES "
                     r"\* KV_BYTES \+ 2 \* P_BYTES \+ 8 \* \(1 \+ 2 \* "
                     r"STAGES\);", FLASH_CU)
    d, b = flash_kernel.MAX_HEAD_DIM, flash_kernel.MAX_BLOCK
    smem = (1024 + d // 32 * box + stages * 2 * d // 32 * box + 2 * b * b * 2
            + 8 * (1 + 2 * stages))
    assert smem == flash_kernel.RING_SMEM_BYTES == 99368
    assert 2 * smem <= H100_SXM.vmem_bytes == 232448
    assert re.search(r"__launch_bounds__\(TC_THREADS, 2\)", FLASH_CU)


def test_flash_bwd_limits_match_kernel_py():
    """Both routes share the entry's limits; route A's windows are 64-row
    TMA boxes and wgmma's M, so its blocks are at most 64 on each side."""
    assert _constexpr(FLASH_BWD_CU, "BQ_MAX") == flash_kernel.MAX_BLOCK
    assert _constexpr(FLASH_BWD_CU, "BK_MAX") == flash_kernel.MAX_BLOCK
    assert _constexpr(FLASH_BWD_CU, "D_MAX") == flash_kernel.MAX_HEAD_DIM
    assert flash_kernel.MAX_BLOCK == 64
    assert "bq > BQ_MAX || bk < 1 || bk > BK_MAX || d < 1 || d > D_MAX" \
        in FLASH_BWD_CU


def test_flash_bwd_routes_match_kernel_py():
    """flash_bwd.cu's route codes are the forward's and kernel.py's; route
    A runs one template a rounded head dim (64 or 128) on the GEMM's PTX
    and the shared tensor-map encoder; fp32 runs CUDA cores whatever the
    code."""
    assert "enum { ROUTE_A = 0, ROUTE_C = 1 };" in FLASH_BWD_CU
    assert set(flash_kernel.BWD_ROUTES) == {"A", "C", "fp32"}
    assert '#include "../../gemm/csrc/gemm_sm90.cuh"' in FLASH_BWD_CU
    assert '#include "../../gemm/csrc/wgmma_tile.cuh"' in FLASH_BWD_CU
    assert "d <= 64 ? launch_wgmma<64>(f, grid, s) : launch_wgmma<128>" \
        in FLASH_BWD_CU
    assert "if (dtype == 0) return launch<float>(f, grid, s);" \
        in FLASH_BWD_CU


def test_flash_bwd_shared_memory_fits_h100_at_the_limits():
    """Route C stages k, v, q and dO windows (rows padded), fp32 dK/dV,
    the P tile and two per-row vectors, all fp32; route A (flash_bwd.cu's
    ``tc_smem``, kernel.py's BWD_RING_SMEM_BYTES at d 128) 1024 bytes of
    slack, the K and V windows, STAGES stages of Q, dO and O (32-column
    boxes of 4096 bytes), four 64 x 64 bf16 tiles (P and dS, hi and lo),
    the LSE and D rows and the mbarriers.  At the largest blocks and head
    dim each fits a block's shared memory; route A at d <= 64 fits two
    blocks an SM, and needs at least two stages to keep the next tile's
    loads in flight."""
    pad = _constexpr(FLASH_BWD_CU, "PAD")
    b, d = flash_kernel.MAX_BLOCK, flash_kernel.MAX_HEAD_DIM
    floats = 4 * b * (d + pad) + 2 * b * d + b * (b + pad) + 2 * b
    assert 4 * floats <= H100_SXM.vmem_bytes
    assert re.search(r"2 \* \(size_t\)bk \* ld \+ 2 \* \(size_t\)bq \* ld \+"
                     r"\s+2 \* \(size_t\)bk \* d \+ \(size_t\)bq \* \(bk \+ PAD\) \+"
                     r"\s+2 \* \(size_t\)bq\);", FLASH_BWD_CU)
    stages = _constexpr(FLASH_BWD_CU, "STAGES")
    box = _constexpr(FLASH_BWD_CU, "BOX")
    assert stages == flash_kernel.BWD_RING_STAGES >= 2 and box == 64 * 64
    assert "constexpr int T_BYTES = BQ_MAX * BK_MAX * 2;" in FLASH_BWD_CU
    assert re.search(r"return 1024 \+ 2 \* \(DN / 32 \* BOX\) \+ STAGES \* 3 "
                     r"\* \(DN / 32 \* BOX\) \+\s+4 \* T_BYTES \+ 2 \* BQ_MAX "
                     r"\* 4 \+ 8 \* \(1 \+ 2 \* STAGES\);", FLASH_BWD_CU)

    def ring(dn):
        win = dn // 32 * box
        return (1024 + 2 * win + stages * 3 * win + 4 * b * b * 2 + 2 * b * 4
                + 8 * (1 + 2 * stages))

    assert ring(d) == flash_kernel.BWD_RING_SMEM_BYTES == 165416
    assert ring(d) <= H100_SXM.vmem_bytes == 232448
    assert 2 * ring(64) <= H100_SXM.vmem_bytes
    assert re.search(r"__launch_bounds__\(TC_THREADS, DN == 64 \? 2 : 1\)",
                     FLASH_BWD_CU)


def test_flash_decode_limits_match_kernel_py_and_machine():
    """The decode kernel's limits (route B's, which take every legal pool
    geometry) live in the .cu and in H100_SXM, which ``plan_flash_decode``
    checks; kernel.py restates none of them."""
    assert _constexpr(FLASH_DECODE_CU, "PAGE_MAX") == H100_SXM.decode_max_page
    assert _constexpr(FLASH_DECODE_CU, "D_MAX") == H100_SXM.decode_max_head_dim
    assert _constexpr(FLASH_DECODE_CU, "GROUP_MAX") == H100_SXM.decode_max_group
    assert _constexpr(FLASH_DECODE_CU, "NEG_INF") == flash_kernel.NEG_INF


def test_flash_decode_shared_memory_fits_h100_at_the_limits():
    """Route B stages the group's q rows and accumulator, one
    page of k (rows padded by one) and v, the scores (rows padded by one),
    three per-head vectors and the page's K and V scales (KV-int8 pools),
    all fp32 (``smem_bytes`` in the .cu)."""
    rep, page = H100_SXM.decode_max_group, H100_SXM.decode_max_page
    d = H100_SXM.decode_max_head_dim
    floats = 2 * rep * d + page * (d + 1) + page * d + rep * (page + 1) \
        + 3 * rep + 2 * page
    assert "3 * (size_t)rep + 2 * (size_t)page" in FLASH_DECODE_CU
    assert re.search(r"2 \* \(size_t\)rep \* d \+ \(size_t\)page \* \(d \+ 1\)",
                     FLASH_DECODE_CU)
    assert 4 * floats <= H100_SXM.vmem_bytes


def _decode_a_int(name):
    """An int constexpr of flash_decode.cu (a product ``a * b`` too)."""
    m = re.search(rf"constexpr int {name} = (\d+)(?: \* (\d+))?;",
                  FLASH_DECODE_CU)
    return int(m.group(1)) * int(m.group(2) or 1)


def test_flash_decode_route_a_limits_match_kernel_py_and_machine():
    """Route A's limits live in the .cu and in H100_SXM, which
    ``choose_decode_route`` reads; its cluster cap, route codes and chunk
    rule are kernel.py's."""
    assert _decode_a_int("A_GROUP_MAX") == H100_SXM.decode_a_max_group
    assert _decode_a_int("A_PAGE_MAX") == H100_SXM.decode_a_max_page
    dims = re.search(r"constexpr bool head_dim_a\(int hd\) \{\s*return ([^;]+);",
                     FLASH_DECODE_CU).group(1)
    assert tuple(int(d) for d in re.findall(r"hd == (\d+)", dims)) == \
        H100_SXM.decode_a_head_dims
    assert _decode_a_int("MAX_CLUSTER") == flash_kernel.DECODE_MAX_CLUSTER
    assert _decode_a_int("A_SMEM_LIMIT") == H100_SXM.vmem_bytes
    assert {"A": _decode_a_int("ROUTE_A"), "B": _decode_a_int("ROUTE_B")} \
        == flash_kernel._DECODE_ROUTE_CODE
    # decode_chunk's rule, and the 16-byte scale copies behind P % 4 == 0.
    assert "const int lo = start + rank * n / C;" in FLASH_DECODE_CU
    assert "const int cnt = start + (rank + 1) * n / C - lo;" in \
        FLASH_DECODE_CU
    assert "page_size % 4 != 0" in FLASH_DECODE_CU
    assert flash_kernel.decode_chunk(5, 12, 3, 1) == (5 + 7 // 3,
                                                     5 + 2 * 7 // 3)


def _layout_a(ring, rep, page, hd, isz, warps):
    """flash_decode.cu's LayoutA total, in bytes (plus the 128-byte
    alignment slack of the launch)."""
    def up(x, a):
        return (x + a - 1) // a * a
    slot = up(page * hd * isz, 128)
    floats = (2 * ring * page + ring * rep * page + ring * rep
              + warps * rep * (hd + 1) + 3 * rep + rep * (hd + 1))
    return up(2 * ring * slot + 4 * floats + 4 * ring, 8) + 16 * ring + 128


def _ring_pages(page, hd, isz, max_blocks, cluster):
    slot = -(-page * hd * isz // 128) * 128
    return max(1, min(_decode_a_int("A_RING_MAX"),
                      _decode_a_int("A_RING_BYTES") // (2 * slot),
                      -(-max_blocks // cluster)))


def test_flash_decode_route_a_shared_memory_fits_h100_at_the_limits():
    """Route A stages a ring of K and V pages (at most A_RING_BYTES of
    them, at most A_RING_MAX pages), their scales, the round's scores and
    page maxima, the warps' partial acc and l, the maxima, the block's acc
    and l, the ring's k_len and two mbarriers a slot: within the H100's
    227 KB at every route-A group, page size and head dim, for either pool
    type, with the most pages a ring takes."""
    for text in ("page = align_up(P * hd * isz, 128);",
                 "pm = sc + ring * rep * P * 4;",
                 "stat = wred + warps * rep * (hd + 1) * 4;",
                 "bar = align_up(klen + ring * 4, 8);",
                 "total = bar + 2 * ring * 8;",
                 "const size_t smem = (size_t)lay.total + 128;",
                 "return group <= 2 ? 16 : 8;"):
        assert text in FLASH_DECODE_CU, text
    worst = 0
    for hd in H100_SXM.decode_a_head_dims:
        for isz in (1, 2):
            for page in range(4, H100_SXM.decode_a_max_page + 1, 4):
                ring = _ring_pages(page, hd, isz, 10 ** 6, 1)
                for rep in range(1, H100_SXM.decode_a_max_group + 1):
                    warps = 16 if rep <= 2 else 8
                    worst = max(worst, _layout_a(ring, rep, page, hd, isz,
                                                 warps))
    assert worst <= H100_SXM.vmem_bytes, worst
    # The serving shape: a 12-page ring (24 blocks over a cluster of 2),
    # 119,408 bytes: one block an SM, 128 blocks on the card's 132 SMs.
    assert _ring_pages(16, 128, 2, 24, 2) == 12
    assert _layout_a(12, 2, 16, 128, 2, 16) == 119408


def test_ssd_limits_match_kernel_py_and_machine():
    """The SSD kernels' limits live in their shared header and in H100_SXM,
    which ``plan_ssd`` checks; kernel.py restates none of them."""
    assert _constexpr(SSD_COMMON, "Q_MAX") == H100_SXM.ssd_max_q
    assert _constexpr(SSD_COMMON, "N_MAX") == H100_SXM.ssd_max_state
    assert _constexpr(SSD_COMMON, "P_MAX") == H100_SXM.ssd_max_head_dim
    for src in (SSD_SCAN_CU, SSD_BWD_CU):
        assert '#include "ssd_common.cuh"' in src
        assert "geometry_ok(" in src


@pytest.mark.parametrize("q,n,p", [(256, 128, 64), (256, 127, 63),
                                   (1, 1, 1)])
def test_ssd_shared_memory_fits_h100_at_the_limits(q, n, p):
    """Each SSD kernel's dynamic shared memory (``smem_floats`` in its
    source) fits one block's 227 KB at the limits.  The forward stages the
    carried (p, n) state, C and B tiles and an xdt tile (rows padded to odd
    strides), the W tile, the y accumulator and the two decay vectors; the
    backward the dS carry and the entering state, C, B, xdt and dY tiles,
    two score tiles, the dB/dC and dxdt accumulators, the decays and a
    reduction row."""
    nt = _constexpr(SSD_COMMON, "NT")
    ldn, ldp = n | 1, p | 1
    rb = _constexpr(SSD_SCAN_CU, "RB")
    assert re.search(r"\(scan \? p \* ldn \+ 2 \* \(size_t\)q : 0\) \+ "
                     r"2 \* RB \* ldn \+ RB \* ldp \+\s+RB \* ldw \+ "
                     r"\(size_t\)RB \* p;", SSD_SCAN_CU)
    fwd = p * ldn + 2 * q + 2 * rb * ldn + rb * ldp + rb * (rb + 1) + rb * p
    rb = _constexpr(SSD_BWD_CU, "RB")
    assert re.search(r"2 \* p \* ldn \+ 2 \* RB \* ldn \+ 2 \* RB \* ldp "
                     r"\+ 2 \* RB \* ldt \+\s+\(size_t\)RB \* n \+ "
                     r"\(size_t\)RB \* p \+ 2 \* \(size_t\)q \+ NT;",
                     SSD_BWD_CU)
    bwd = (2 * p * ldn + 2 * rb * ldn + 2 * rb * ldp + 2 * rb * (rb + 1)
           + rb * n + rb * p + 2 * q + nt)
    assert 4 * fwd <= H100_SXM.vmem_bytes
    assert 4 * bwd <= H100_SXM.vmem_bytes
    if (q, n, p) == (256, 128, 64):
        assert (4 * fwd, 4 * bwd) == (150784, 151808)


def test_ssd_bwd_route_a_limits_match_kernel_py_and_machine():
    """Route A's limits live in ssd_scan_bwd.cu and in H100_SXM, which
    ``choose_bwd_route`` reads; its route codes, cluster limit and chunk
    split are kernel.py's, and its tile routines are the new header's."""
    m = H100_SXM
    assert _constexpr(SSD_BWD_CU, "A_BLOCK") == m.ssd_a_block
    assert _constexpr(SSD_BWD_CU, "A_STATE") == m.ssd_a_state
    assert _constexpr(SSD_BWD_CU, "A_HEAD_DIM") == m.ssd_a_head_dim
    assert _constexpr(SSD_BWD_CU, "MAX_CLUSTER") == \
        ssd_kernel.SSD_MAX_CLUSTER
    assert m.ssd_a_state <= m.ssd_max_state
    assert m.ssd_a_head_dim <= m.ssd_max_head_dim
    assert m.ssd_max_q % m.ssd_a_block == 0
    assert "enum { ROUTE_A = 0, ROUTE_B = 1 };" in SSD_BWD_CU
    assert ssd_kernel._ROUTE_CODE == {"A": 0, "B": 1}
    assert ("const int lo = rank * f.chunks / C, hi = (rank + 1) * f.chunks "
            "/ C;") in SSD_BWD_CU
    assert ssd_kernel.bwd_chunks(9, 8, 7) == (7 * 9 // 8, 9)
    assert '#include "ssd_sm90.cuh"' in SSD_BWD_CU
    assert '#include "ssd_sm90.cuh"' in SSD_SCAN_CU


def test_ssd_bwd_route_a_shared_memory_fits_h100_at_the_limits():
    """Route A's dynamic shared memory (``A_SMEM`` in its source): 512
    bytes of alignment slack, the state region (a (p, n) state in three
    split windows, room for the fp32 tile it first holds), the B_j and C_i
    windows, the xdt_j and dY_i split windows and 64 bytes of sums.  Two
    blocks share an SM's 228 KB, each with the 1 KB the card reserves a
    block; a rank that walks several chunks adds its fp32 dS and still
    fits a block's 227 KB."""
    m = H100_SXM
    for name, formula in (
            ("A_STATE_WINDOW", r"A_HEAD_DIM \* A_STATE \* 2"),
            ("A_STATE_BYTES", r"3 \* A_STATE_WINDOW"),
            ("A_NB_BYTES", r"A_BLOCK \* A_STATE \* 2"),
            ("A_NP_BYTES", r"2 \* A_BLOCK \* A_HEAD_DIM \* 2"),
            ("A_SMEM", r"512 \+ A_STATE_BYTES \+ 2 \* A_NB_BYTES \+ "
                       r"2 \* A_NP_BYTES \+ 64"),
            ("A_CARRY_BYTES", r"A_HEAD_DIM \* A_STATE \* 4")):
        assert re.search(rf"constexpr int {name} =\s*{formula};", SSD_BWD_CU), \
            name
    n, p, rows = m.ssd_a_state, m.ssd_a_head_dim, m.ssd_a_block
    smem = 512 + 3 * p * n * 2 + 2 * rows * n * 2 + 2 * rows * p * 2 * 2 + 64
    carry = p * n * 4
    assert 3 * p * n * 2 >= carry  # the published fp32 tile
    assert smem == 115264
    assert 2 * (smem + 1024) <= 228 * 1024
    assert smem + carry <= m.vmem_bytes


def test_ssd_fwd_route_a_limits_match_kernel_py_and_machine():
    """The forward's route A (ssd_scan.cu) takes the backward's limits from
    H100_SXM, which ``choose_fwd_route`` reads; its route codes and cluster
    limit are kernel.py's, a cluster holds a block a chunk (a call of more
    chunks than the cluster limit is refused, and choose_fwd_route sends
    it to route B), and its tile routines are ssd_sm90.cuh's."""
    m = H100_SXM
    assert _constexpr(SSD_SCAN_CU, "A_BLOCK") == m.ssd_a_block
    assert _constexpr(SSD_SCAN_CU, "A_STATE") == m.ssd_a_state
    assert _constexpr(SSD_SCAN_CU, "A_HEAD_DIM") == m.ssd_a_head_dim
    assert _constexpr(SSD_SCAN_CU, "MAX_CLUSTER") == \
        ssd_kernel.SSD_MAX_CLUSTER
    assert "enum { ROUTE_A = 0, ROUTE_B = 1 };" in SSD_SCAN_CU
    assert '#include "ssd_sm90.cuh"' in SSD_SCAN_CU
    flat = " ".join(SSD_SCAN_CU.split())
    assert "const int64_t g = blockIdx.x / C, cell = blockIdx.x;" in flat
    assert "chunks > MAX_CLUSTER ||" in flat
    assert "attrs[0].val.clusterDim.x = f.chunks;" in flat
    bf, f32 = torch.bfloat16, torch.float32
    limit = ssd_kernel.SSD_MAX_CLUSTER
    assert ssd_kernel.choose_fwd_route(bf, f32, f32, 256, 128, 64,
                                       limit) == "A"
    assert ssd_kernel.choose_fwd_route(bf, f32, f32, 256, 128, 64,
                                       limit + 1) == "B"


def test_ssd_fwd_route_a_shared_memory_fits_h100_at_the_limits():
    """Route A's dynamic shared memory (``a_smem`` in ssd_scan.cu): 512
    bytes of alignment slack, the chunk's B_j windows, its xdt_j split
    windows (for the scan at least the state region, which shares their
    memory and first holds the published fp32 tile), a C_i window for each
    of the two warpgroups and 64 bytes of the published decay.  One block
    an SM: at every Q up to 256 it fits a block's 227 KB."""
    m = H100_SXM
    for name, formula in (
            ("A_STATE_WINDOW", r"A_HEAD_DIM \* A_STATE \* 2"),
            ("A_STATE_BYTES", r"3 \* A_STATE_WINDOW"),
            ("A_NB_BYTES", r"A_BLOCK \* A_STATE \* 2"),
            ("A_X_WINDOW", r"A_BLOCK \* A_HEAD_DIM \* 2"),
            ("A_NX_BYTES", r"3 \* A_X_WINDOW"),
            ("A_PUB_BYTES", r"A_HEAD_DIM \* A_STATE \* 4"),
            ("A_WINDOWS", r"Q_MAX / A_BLOCK")):
        assert re.search(rf"constexpr int {name} =\s*{formula};",
                         SSD_SCAN_CU), name
    flat = " ".join(SSD_SCAN_CU.split())
    assert ("return scan && windows * A_NX_BYTES < A_STATE_BYTES ? "
            "A_STATE_BYTES : windows * A_NX_BYTES;") in flat
    assert ("return 512 + windows * A_NB_BYTES + a_x_region(scan, windows) "
            "+ 2 * A_NB_BYTES + 64;") in flat
    n, p, rows = m.ssd_a_state, m.ssd_a_head_dim, m.ssd_a_block
    state, nb, nx, pub = 3 * p * n * 2, rows * n * 2, 3 * rows * p * 2, \
        p * n * 4

    def smem(scan, windows):
        x = state if scan and windows * nx < state else windows * nx
        return 512 + windows * nb + x + 2 * nb + 64

    assert state >= pub  # the published fp32 tile
    windows = m.ssd_max_q // rows
    assert (smem(True, windows), smem(True, 1)) == (197184, 98880)
    for w in range(1, windows + 1):
        for scan in (True, False):
            assert smem(scan, w) <= m.vmem_bytes


def test_ssd_scan_header_describes_both_routes():
    """ssd_scan.cu's header comment states both routes, what bounds each
    and what route A's design does about it."""
    header = " ".join(SSD_SCAN_CU.split("#include")[0].replace("//", " ")
                      .split())
    for text in ("(A) bf16 C and B, fp32 L and xdt", "(B) everything else",
                 "What bounds it on the H100: bytes", "thread-block cluster",
                 "distributed shared memory", "wgmma", "three bf16 pieces",
                 "two warpgroups", "What still bounds it",
                 "Bound by its fp32 CUDA-core products"):
        assert text in header, text


def test_every_kernel_source_is_built():
    assert sorted(_build.sources()) == ["flash_bwd", "flash_decode",
                                        "flash_fwd", "gemm", "gemm_quant",
                                        "grouped", "grouped_quant",
                                        "ssd_scan", "ssd_scan_bwd",
                                        "transpose"]


def test_h100_flash_blocks_within_kernel_limits():
    for bq, bk in H100_SXM.flash_blocks:
        assert 1 <= bq <= flash_kernel.MAX_BLOCK
        assert 1 <= bk <= flash_kernel.MAX_BLOCK


def test_build_dir_is_in_the_checkout_or_set(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    checkout = KERNELS.parents[2]
    assert _build.build_dir() == checkout / "build" / "repro_torch"
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert _build.build_dir() == tmp_path


def test_build_dir_outside_a_checkout_raises(monkeypatch, tmp_path):
    """An installed package has no checkout to build into: it must be
    told where, never write beside site-packages."""
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    installed = tmp_path / "site-packages" / "repro_torch" / "kernels"
    installed.mkdir(parents=True)
    monkeypatch.setattr(_build, "_KERNELS_DIR", installed)
    with pytest.raises(RuntimeError, match="REPRO_TORCH_BUILD_DIR"):
        _build.build_dir()


GEMM_QUANT_CU = (KERNELS / "gemm" / "csrc" / "gemm_quant.cu").read_text()
QUANT_TILE = (KERNELS / "gemm" / "csrc" / "quant_tile.cuh").read_text()
GROUPED_QUANT_CU = (KERNELS / "grouped_gemm" / "csrc"
                    / "grouped_quant.cu").read_text()
QUANT_SM90 = (KERNELS / "gemm" / "csrc" / "quant_sm90.cuh").read_text()


@pytest.mark.parametrize("src,pattern,shapes", [
    (GEMM_QUANT_CU, r"case (\d+): qtile<S, TA, TB, NT_B, (\d+), (\d+)>",
     gemm_kernel.TEMPLATE_SHAPES),
    (GROUPED_QUANT_CU, r"case (\d+): qtile<S, TX, TW, (\d+), (\d+)>",
     None)])
def test_quant_kernels_take_the_wide_palettes(src, pattern, shapes):
    """The quantized GEMM and grouped GEMM instantiate the wide kernels'
    (bm, bn) shapes in the same order, with the same K panel, so the same
    plans and tile tables drive them: route C's wmma tile (quant_tile.cuh)
    and the wgmma ring of routes A and B (quant_sm90.cuh) alike."""
    from repro_torch.kernels.grouped_gemm import kernel as grouped_kernel
    shapes = shapes or grouped_kernel.SHAPES
    for text, pat in ((src, pattern),
                      (QUANT_SM90, r"case (\d+): R::template run<(\d+), "
                                   r"(\d+)>")):
        cases = re.findall(pat, text)
        assert [int(i) for i, _, _ in cases] == list(range(len(shapes)))
        assert tuple((int(bm), int(bn)) for _, bm, bn in cases) == \
            tuple(shapes)
    assert "qwg::run_by_shape<qwg::Ring<" in src
    for shape, (bm, bn) in enumerate(shapes):
        assert _c_function(QUANT_TILE, "shape_bm")(shape) == bm
        assert _c_function(QUANT_TILE, "shape_bn")(shape) == bn
    assert _constexpr(QUANT_TILE, "BK") == H100_SXM.k_panel
    assert '#include "../../gemm/csrc/quant_tile.cuh"' in GROUPED_QUANT_CU
    assert '#include "quant_tile.cuh"' in GEMM_QUANT_CU
    assert '#include "../../gemm/csrc/quant_sm90.cuh"' in GROUPED_QUANT_CU
    assert '#include "quant_sm90.cuh"' in GEMM_QUANT_CU


def test_quant_route_codes_and_cluster_match_kernel_py():
    """gemm_quant.cu's and grouped_quant.cu's route codes are kernel.py's
    QUANT_ROUTE_CODE, and the dense quant GEMM splits K over at most the
    wide GEMM's cluster."""
    from repro_torch.kernels.grouped_gemm import kernel as grouped_kernel
    enum = ("enum { ROUTE_A = 0, ROUTE_B = 1, ROUTE_C = 2, ROUTE_F32 = 3 };")
    assert enum in GEMM_QUANT_CU and enum in GROUPED_QUANT_CU
    want = {"A": 0, "B": 1, "C": 2, "fp32": 3}
    assert gemm_kernel.QUANT_ROUTE_CODE == want
    assert grouped_kernel.QUANT_ROUTE_CODE == want
    assert _constexpr(GEMM_QUANT_CU, "MAX_CLUSTER") == gemm_kernel.MAX_CLUSTER
    for src in (GEMM_QUANT_CU, GROUPED_QUANT_CU):
        assert re.search(r"__launch_bounds__\(2 \* qwg::WG_THREADS \+ "
                         r"qwg::PRODUCER_THREADS,\s+2\)", src)


@pytest.mark.parametrize("pair", ["bf16_s8", "bf16_e4m3", "s8_s8",
                                  "e4m3_e4m3"])
@pytest.mark.parametrize("nwg", [1, 2])
def test_quant_ring_fits_two_blocks_an_sm(pair, nwg):
    """Each staged pair's ring (quant_sm90.cuh's formulas: A's compute and
    raw slots, B's compute and raw slots, QSTAGES stages) fits a block's
    shared memory twice, and holds the staged fp32 tile and the split-K
    partials of its warpgroups."""
    assert "return a_slot(nwg) + a_raw(nwg) + B_SLOT + B_RAW;" in QUANT_SM90
    assert "return 1024 + QSTAGES * stage_bytes(nwg) + 2 * QSTAGES * 8;" \
        in QUANT_SM90
    assert "static constexpr int BK = S8 ? 64 : 32;" in QUANT_SM90
    stages = _constexpr(QUANT_SM90, "QSTAGES")
    s8, widen_a = pair == "s8_s8", pair == "e4m3_e4m3"
    bk = 64 if s8 else 32
    stage = (nwg * 64 * 64 + (nwg * 64 * 32 if widen_a else 0) + 128 * 64
             + 2 * bk * 64)
    ring = 1024 + stages * stage + 2 * stages * 8
    assert 2 * ring <= H100_SXM.vmem_bytes
    assert stages * stage >= 64 * nwg * (128 + 4) * 4  # the staged tile
    assert stages * stage >= 4 * 64 * nwg * 128 // 2  # split partials


def test_quant_dtype_codes_match_the_header():
    from repro_torch.kernels.gemm.kernel import QUANT_CODE
    import torch
    codes = re.search(r"enum \{ DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2, "
                      r"DT_E4M3 = 3 \};", QUANT_TILE)
    assert codes
    assert [QUANT_CODE[t] for t in (torch.float32, torch.bfloat16, torch.int8,
                                    torch.float8_e4m3fn)] == [0, 1, 2, 3]


def test_a_shared_header_rebuilds_every_library(monkeypatch, tmp_path):
    """A header included across families (quant_tile.cuh) is hashed into
    every library's name, so editing it rebuilds the grouped kernels too."""
    import shutil
    copy = tmp_path / "kernels"
    shutil.copytree(KERNELS, copy, ignore=shutil.ignore_patterns(
        "*.py", "__pycache__"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_KERNELS_DIR", copy)
    src = copy / "grouped_gemm" / "csrc" / "grouped_quant.cu"
    before = _build._target(src)
    header = copy / "gemm" / "csrc" / "quant_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._target(src) != before


@pytest.mark.parametrize("bm", [16, 64, 128])
def test_grouped_bwd_route_a_constants_and_shared_memory(bm):
    """Route A of the grouped backward: grouped.cu's BWD_TILE, BWD_PANEL
    and BWD_STAGES are kernel.py's; a ring stage holds what a dX tile of
    bm rows loads (an fp32 dY box of 64 rows a warpgroup, w's box of
    BWD_PANEL x BWD_TILE) and what a dW tile loads (four fp32 dY boxes of
    32 x 32, x's two boxes of 64 x 32); the ring fits a block's 232,448
    bytes twice (two blocks an SM); the route codes agree."""
    from repro_torch.kernels.grouped_gemm import kernel as grouped_kernel
    assert bm in {s[0] for s in grouped_kernel.SHAPES}
    tile, panel, stages = (int(_constexpr(GROUPED_CU, name)) for name in
                           ("BWD_TILE", "BWD_PANEL", "BWD_STAGES"))
    assert (tile, panel, stages) == (grouped_kernel.BWD_TILE,
                                     grouped_kernel.BWD_PANEL,
                                     grouped_kernel.BWD_STAGES)
    assert "constexpr int BWD_A_SLOT = BWD_TILE * BWD_PANEL * 4;" in GROUPED_CU
    assert "constexpr int BWD_B_SLOT = BWD_TILE * BWD_PANEL * 2;" in GROUPED_CU
    assert ("constexpr int BWD_SMEM = 1024 + BWD_STAGES * BWD_STAGE + "
            "2 * BWD_STAGES * 8;") in GROUPED_CU
    a_slot, b_slot = tile * panel * 4, tile * panel * 2
    warpgroups = min(2, -(-bm // 64))
    assert warpgroups * 64 * panel * 4 <= a_slot      # dX: dY's rows
    assert tile * panel * 2 <= b_slot                 # dX: w's box
    assert 4 * 32 * panel * 4 == a_slot               # dW: dY's columns
    assert 2 * 64 * panel * 2 == b_slot               # dW: x's columns
    smem = 1024 + stages * (a_slot + b_slot) + 2 * stages * 8
    assert 2 * smem <= H100_SXM.vmem_bytes
    assert "__launch_bounds__(BWD_THREADS, 2)" in GROUPED_CU
    assert "enum { ROUTE_A = 0, ROUTE_C = 2, ROUTE_F32 = 3 };" in GROUPED_CU
    assert grouped_kernel._BWD_ROUTE_CODE == {"A": 0, "C": 2, "fp32": 3}
    assert set(grouped_kernel.BWD_ROUTES) == {"A", "C", "fp32"}
    assert '#include "../../ssd_chunk/csrc/ssd_sm90.cuh"' in GROUPED_CU


def test_transpose_route_a_constants_match_kernel_py_and_machine():
    """transpose.cu's tile edges are H100_SXM.transpose_tiles, its ring
    (stages, output tiles, the widest box row) and route codes are
    kernel.py's, and it takes its mbarriers, TMA loads and stores from
    gemm_sm90.cuh and the tensor-map encoder from wgmma_tile.cuh."""
    tk = transpose_kernel
    assert (_constexpr(TRANSPOSE_CU, "BT_SMALL"),
            _constexpr(TRANSPOSE_CU, "BT_LARGE")) == \
        H100_SXM.transpose_tiles == tk.TILE_EDGES
    assert _constexpr(TRANSPOSE_CU, "A_STAGES") == tk.RING_STAGES
    assert _constexpr(TRANSPOSE_CU, "OUT_TILES") == tk.OUT_TILES
    assert _constexpr(TRANSPOSE_CU, "BOX_BYTES") == tk.BOX_BYTES == 128
    assert tk.RING_STAGES in (3, 4) and tk.OUT_TILES == 2
    assert "enum { ROUTE_A = 0, ROUTE_B = 1 };" in TRANSPOSE_CU
    assert tk._ROUTE_CODE == {"A": 0, "B": 1}
    assert '#include "../../gemm/csrc/gemm_sm90.cuh"' in TRANSPOSE_CU
    assert "wgt::encode_tiled()" in TRANSPOSE_CU
    for fn in ("mbar_expect_tx", "tma_load_3d", "tma_store_3d",
               "bulk_wait_read<0>", "fence_proxy_async"):
        assert f"sm90::{fn}" in TRANSPOSE_CU, fn
    flat = " ".join(TRANSPOSE_CU.split())
    assert "return elem * bt < BOX_BYTES ? elem * bt : BOX_BYTES;" in flat
    for elem in (1, 2, 4, 8):
        for bt in H100_SXM.transpose_tiles:
            assert tk.box_row(elem, bt) == min(elem * bt, 128)


def test_transpose_route_a_shared_memory_fits_h100():
    """Route A's dynamic shared memory (``a_smem``: 1024 bytes of
    alignment slack, A_STAGES staged tiles and OUT_TILES output tiles, an
    mbarrier a stage) is kernel.py's ring_smem_bytes and fits a block's
    227 KB at every element size and tile edge."""
    flat = " ".join(TRANSPOSE_CU.split())
    assert ("return 1024 + (A_STAGES + OUT_TILES) * tile_bytes(elem, bt) + "
            "A_STAGES * 8;") in flat
    assert "return elem * bt * bt;" in flat
    assert 'static_assert(a_smem(8, BT_LARGE) <= 232448' in flat
    for elem in (1, 2, 4, 8):
        for bt in H100_SXM.transpose_tiles:
            want = 1024 + 6 * elem * bt * bt + 32
            assert transpose_kernel.ring_smem_bytes(elem, bt) == want
            assert want <= 232448


def test_transpose_walk_and_route_check_mirror_kernel_py():
    """The kernel's tile walk (``a_tile``) and route-A check
    (``route_a_ok``) are the arithmetic of kernel.py's walk_tile and
    choose_route."""
    flat = " ".join(TRANSPOSE_CU.split())
    for line in ("b = (int)(t / per_batch);",
                 "i = (int)(u / f.tj);", "j = (int)(u % f.tj);",
                 "a_tile(blockIdx.x + it * grid, f, b, i, j);",
                 "(elem == 1 || elem == 2 || elem == 4 || elem == 8)",
                 "reinterpret_cast<uintptr_t>(x) % 16 == 0",
                 "row_stride * elem % 16 == 0 && batch_stride * elem % 16 "
                 "== 0", "(long long)rows * elem % 16 == 0",
                 "const long long lim = 1LL << 40;"):
        assert line in flat, line
    assert transpose_kernel.TMA_STRIDE_LIMIT == 1 << 40
