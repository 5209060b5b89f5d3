"""The port's planners against the reference's, and the H100 palette
against the shapes the CUDA GEMM kernel instantiates.

Under the ``TPU_V5E`` data the port must reproduce the reference's plans
exactly: the same regions, ``bk``, block sizes and ``fused`` bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.blocking import plan_flash as j_plan_flash

from repro_torch.core import (H100_SXM, TPU_V5E, FlashDescriptor,
                              GemmDescriptor, flash_fused_legal, fused_legal,
                              palette, plan_flash, plan_gemm)
from repro_torch.kernels.gemm.kernel import TEMPLATE_SHAPES, template_for

# (m, n, k, descriptor kwargs, planner kwargs): the descriptors of
# tests/test_blocking.py plus dtype / layout / accumulate / batch variants.
GEMM_PLANS = [
    (1024, 1024, 1024, {}, {}),
    (300, 500, 128, {}, {}),
    (640, 640, 512, {}, {}),
    (640, 640, 512, {}, {"heterogeneous": False, "force_block": (256, 256)}),
    (640, 640, 512, {}, {"force_block": (256, 256)}),
    (512, 512, 512, {}, {"force_block": (128, 512)}),
    (1, 1, 1, {}, {}),
    (4096, 4096, 8192, {}, {}),
    (7, 33, 100, {}, {}),
    (128, 128, 100, {}, {}),
    (256, 256, 256, {}, {"force_block": (256, 256)}),
    (512, 1024, 256, {}, {"force_block": (512, 1024)}),
    (128, 128, 128, {}, {}),
    (8192, 8192, 8192, {}, {}),
    (513, 129, 257, {}, {}),
    (80, 80, 512, {}, {}),
    (1, 2048, 64, {}, {}),
    (1000, 1000, 384, {}, {}),
    (1024, 3072, 1024, {"in_dtype": "bfloat16", "out_dtype": "bfloat16",
                        "epilogue": "silu"}, {}),
    (4, 151936, 1024, {"in_dtype": "bfloat16", "out_dtype": "bfloat16",
                       "layout": "nt"}, {}),
    (300, 500, 128, {"accumulate": True, "epilogue": "bias_gelu"}, {}),
    (77, 200, 50, {"batch": 3, "layout": "nt"}, {}),
]


def _regions(plan):
    return [(r.row0, r.col0, r.rows, r.cols, r.bm, r.bn) for r in plan.regions]


@pytest.mark.parametrize("m,n,k,dkw,pkw", GEMM_PLANS)
def test_tpu_plans_equal_reference(m, n, k, dkw, pkw):
    jplan = jcore.plan_gemm(jcore.GemmDescriptor(m=m, n=n, k=k, **dkw), **pkw)
    plan = plan_gemm(GemmDescriptor(m=m, n=n, k=k, **dkw), TPU_V5E, **pkw)
    assert _regions(plan) == _regions(jplan)
    assert plan.bk == jplan.bk
    assert plan.fused == jplan.fused
    assert plan.heterogeneous == jplan.heterogeneous
    assert plan.predicted_seconds(TPU_V5E) == pytest.approx(
        jplan.predicted_seconds(jcore.TPU_V5E), rel=1e-12)


@pytest.mark.parametrize("m,n,k,dkw,pkw", GEMM_PLANS)
def test_fused_legal_matches_reference(m, n, k, dkw, pkw):
    d = dict(m=m, n=n, k=k, **dkw)
    assert fused_legal(GemmDescriptor(**d), TPU_V5E) == \
        jcore.fused_legal(jcore.GemmDescriptor(**d))
    assert fused_legal(GemmDescriptor(**d), H100_SXM)


def test_tpu_palette_equals_reference():
    for dtype in ("float32", "bfloat16"):
        assert palette(machine=TPU_V5E, dtype=dtype) == \
            jcore.palette(dtype=dtype)


# (batch_heads, sq, sk, d, causal, dtype)
FLASH_PLANS = [
    (8, 256, 256, 64, True, "float32"), (4, 384, 384, 64, True, "float32"),
    (4, 512, 512, 64, True, "float32"), (8, 256, 256, 64, True, "bfloat16"),
    (2, 96, 96, 64, True, "float32"), (6, 100, 100, 48, True, "bfloat16"),
    (1, 130, 70, 32, False, "float32"), (6, 33, 257, 16, False, "bfloat16"),
    (64, 256, 256, 128, True, "bfloat16"), (64, 4096, 4096, 128, True,
                                            "bfloat16"),
]


@pytest.mark.parametrize("bh,sq,sk,d,causal,dtype", FLASH_PLANS)
def test_tpu_flash_plans_equal_reference(bh, sq, sk, d, causal, dtype):
    kw = dict(batch_heads=bh, sq=sq, sk=sk, d=d, causal=causal, dtype=dtype)
    jplan = j_plan_flash(jcore.FlashDescriptor(**kw))
    plan = plan_flash(FlashDescriptor(**kw), TPU_V5E)
    assert (plan.block_q, plan.block_k, plan.fused) == \
        (jplan.block_q, jplan.block_k, jplan.fused)
    assert flash_fused_legal(FlashDescriptor(**kw), TPU_V5E) == \
        jcore.flash_fused_legal(jcore.FlashDescriptor(**kw))


@pytest.mark.parametrize("bh,sq,sk,d,causal,dtype", FLASH_PLANS)
def test_h100_flash_plans_use_kernel_blocks(bh, sq, sk, d, causal, dtype):
    plan = plan_flash(FlashDescriptor(batch_heads=bh, sq=sq, sk=sk, d=d,
                                      causal=causal, dtype=dtype))
    assert (plan.block_q, plan.block_k) in H100_SXM.flash_blocks
    assert plan.fused  # the streaming kernel takes every problem


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["nn", "nt"])
@pytest.mark.parametrize("accumulate", [False, True])
def test_cache_keys_match_reference(dtype, layout, accumulate):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 37, 20)).astype(np.float32)
    b = rng.standard_normal((3, 20, 45) if layout == "nn" else (3, 45, 20)
                            ).astype(np.float32)
    jd = jcore.GemmDescriptor.from_operands(
        jnp.asarray(a, dtype), jnp.asarray(b, dtype), layout=layout,
        accumulate=accumulate, epilogue="gelu", out_dtype=dtype)
    td = getattr(torch, dtype)
    d = GemmDescriptor.from_operands(
        torch.from_numpy(a).to(td), torch.from_numpy(b).to(td),
        layout=layout, accumulate=accumulate, epilogue="gelu",
        out_dtype=dtype)
    assert d.cache_key() == jd.cache_key()
    assert (d.flops, d.in_bytes, d.out_bytes) == \
        (jd.flops, jd.in_bytes, jd.out_bytes)
    q = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    k = rng.standard_normal((2, 11, 3, 16)).astype(np.float32)
    jf = jcore.FlashDescriptor.from_operands(jnp.asarray(q, dtype),
                                             jnp.asarray(k, dtype),
                                             causal=accumulate)
    f = FlashDescriptor.from_operands(torch.from_numpy(q).to(td),
                                      torch.from_numpy(k).to(td),
                                      causal=accumulate)
    assert f.cache_key() == jf.cache_key()
    assert (f.flops, f.in_bytes, f.out_bytes) == \
        (jf.flops, jf.in_bytes, jf.out_bytes)


def test_unported_axes_raise():
    """Both axes are ported: a mesh descriptor and a quantized descriptor
    key like the reference's, and each package refuses a mesh or a quant
    argument that is not its spec (a tuple, a shorthand string)."""
    from repro.core.descriptor import resolve_quant as j_resolve_quant
    from repro_torch.core import MeshSpec, resolve_quant
    for mesh in (MeshSpec("model", 2), MeshSpec("data", 4)):
        assert GemmDescriptor(m=4, n=8, k=4, mesh=mesh).cache_key() == \
            jcore.GemmDescriptor(m=4, n=8, k=4, mesh=jcore.MeshSpec(
                mesh.axis, mesh.size)).cache_key()
    for desc in (GemmDescriptor, jcore.GemmDescriptor):
        with pytest.raises(ValueError, match="MeshSpec"):
            desc(m=4, n=4, k=4, mesh=("model", 2))
    for mode in ("int8", "w8a16", "fp8"):
        assert GemmDescriptor(m=4, n=4, k=4, quant=resolve_quant(mode)) \
            .cache_key() == jcore.GemmDescriptor(
                m=4, n=4, k=4, quant=j_resolve_quant(mode)).cache_key()
    for desc in (GemmDescriptor, jcore.GemmDescriptor):
        with pytest.raises(ValueError, match="QuantSpec"):
            desc(m=4, n=4, k=4, quant="int8")


def test_h100_palette_is_the_kernel_templates():
    for dtype in ("float32", "bfloat16"):
        assert set(palette(machine=H100_SXM, dtype=dtype)) == \
            set(TEMPLATE_SHAPES)


@pytest.mark.parametrize("m,n,k,dkw,pkw", [c for c in GEMM_PLANS
                                           if "force_block" not in c[4]])
def test_h100_plans_use_only_kernel_shapes(m, n, k, dkw, pkw):
    plan = plan_gemm(GemmDescriptor(m=m, n=n, k=k, **dkw), **pkw)
    assert plan.validate()
    for r in plan.regions:
        assert (r.bm, r.bn) in TEMPLATE_SHAPES
    assert plan.bk == H100_SXM.k_panel
    for bm_e, bn_e in plan.tile_schedule().blocks:
        bm, bn = TEMPLATE_SHAPES[template_for(bm_e, bn_e)]
        assert bm >= bm_e and bn >= bn_e


def test_h100_decode_gemm_uses_small_rows():
    """Decode GEMMs have M = batch: the plan takes the 16-row shape."""
    plan = plan_gemm(GemmDescriptor(m=4, n=151936, k=1024, layout="nt",
                                    in_dtype="bfloat16", out_dtype="bfloat16"))
    assert all(r.bm == 16 for r in plan.regions)
    assert plan.fused and plan.tile_schedule().num_tiles == 151936 // 128
