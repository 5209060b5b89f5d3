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

from repro_torch.core import H100_SXM
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.gemm import kernel as gemm_kernel

KERNELS = Path(gemm_kernel.__file__).resolve().parents[1]
GEMM_CU = (KERNELS / "gemm" / "csrc" / "gemm.cu").read_text()
FLASH_CU = (KERNELS / "flash_attention" / "csrc" / "flash_fwd.cu").read_text()
FLASH_BWD_CU = (KERNELS / "flash_attention" / "csrc"
                / "flash_bwd.cu").read_text()


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


def test_flash_limits_match_kernel_py():
    assert _constexpr(FLASH_CU, "BQ_MAX") == flash_kernel.MAX_BLOCK
    assert _constexpr(FLASH_CU, "BK_MAX") == flash_kernel.MAX_BLOCK
    assert _constexpr(FLASH_CU, "D_MAX") == flash_kernel.MAX_HEAD_DIM
    assert _constexpr(FLASH_CU, "NEG_INF") == flash_kernel.NEG_INF


def test_flash_bwd_limits_match_kernel_py():
    assert _constexpr(FLASH_BWD_CU, "BQ_MAX") == flash_kernel.MAX_BLOCK
    assert _constexpr(FLASH_BWD_CU, "BK_MAX") == flash_kernel.MAX_BLOCK
    assert _constexpr(FLASH_BWD_CU, "D_MAX") == flash_kernel.MAX_HEAD_DIM


def test_flash_bwd_shared_memory_fits_h100_at_the_limits():
    """The backward stages k, v, q and dO windows (rows padded), fp32
    dK/dV, the P tile and two per-row vectors, all fp32: at the largest
    blocks and head dim it must fit a block's shared memory."""
    pad = _constexpr(FLASH_BWD_CU, "PAD")
    b, d = flash_kernel.MAX_BLOCK, flash_kernel.MAX_HEAD_DIM
    floats = 4 * b * (d + pad) + 2 * b * d + b * (b + pad) + 2 * b
    assert 4 * floats <= H100_SXM.vmem_bytes


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
