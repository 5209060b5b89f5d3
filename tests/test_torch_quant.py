"""The port's quant axis against the reference's: the codec
(``optim/compression.py``), ``resolve_quant`` and the quantized
descriptors (constraints, cache keys under every spec, ``TPU_V5E`` plans),
the quantized GEMM (``gemm(quant=)``, a pre-quantized ``QuantizedTensor``
weight through ``matmul`` on both backends), the quantized grouped GEMM,
``quantize_model`` and ``error_feedback_compress``.

Tolerances (float32 on both sides):
  * the codec: int8 values and f32 scales exactly equal, e4m3 values
    bit for bit (both round to nearest even);
  * the quantized GEMM against the reference's ``_xla_quant_gemm`` on the
    same quantized operands: int8 with a multiply-only epilogue exactly
    equal (the int32 sums are exact and the dequant product rounds the
    same), otherwise atol = rtol = 1e-5 (the epilogue's transcendentals,
    fp32 sums of e4m3 / W8A16 products in another order);
  * against the reference's interpret-mode fused kernel and its
    dequantize-then-matmul oracles, ``tests/test_quant.py``'s bounds
    (relative 1e-5 for int8 and W8A16 GEMMs, 1e-3 for fp8, 1e-4 for the
    grouped GEMM);
  * ``error_feedback_compress``: the gradients and residuals exactly
    equal (the same fp32 ops in the same order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.blocking import plan_grouped as j_plan_grouped
from repro.core.descriptor import GroupedGemmDescriptor as JGroupedDesc
from repro.core.descriptor import QuantSpec as JQuantSpec
from repro.core.descriptor import resolve_quant as j_resolve_quant
from repro.core.matmul import matmul as j_matmul
from repro.kernels.gemm import gemm as j_gemm
from repro.kernels.gemm.ops import _xla_quant_gemm as j_xla_quant_gemm
from repro.kernels.grouped_gemm import grouped_gemm as j_grouped_gemm
from repro.optim import compression as jcomp

from repro_torch.core import (H100_SXM, TPU_V5E, GemmDescriptor,
                              GroupedGemmDescriptor, QuantSpec, engine,
                              matmul, plan_gemm, plan_grouped, resolve_quant,
                              use)
from repro_torch.core.blocking import fused_legal, grouped_fused_legal
from repro_torch.core.config import EngineConfig, _env_default, get_config
from repro_torch.core.schedule import QUANT_TILE
from repro_torch.kernels.gemm import gemm
from repro_torch.kernels.gemm.kernel import (LAUNCHES, FusedGemm, gemm_quant,
                                             gemm_quant_plain)
from repro_torch.kernels.gemm.ref import ref_quant_gemm
from repro_torch.kernels.grouped_gemm import grouped_gemm
from repro_torch.kernels.grouped_gemm import kernel as grouped_kernel
from repro_torch.optim import compression as comp

SCHEMES = ["per_tensor", "per_channel", "per_tile"]
DTYPES = ["int8", "float8_e4m3"]
MODES = ["int8", "w8a16", "fp8"]


@pytest.fixture(autouse=True)
def _cpu():
    with use(device="cpu", backend="engine"):
        engine.reset_stats()
        yield


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(x):
    """A torch tensor or JAX array as numpy, e4m3 as its raw bytes."""
    if torch.is_tensor(x):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.int8).numpy()
        return x.detach().numpy()
    a = np.asarray(x)
    return a.view(np.int8) if a.dtype.itemsize == 1 and a.dtype.kind == "V" \
        or str(a.dtype).startswith("float8") else a


def _spec_pair(dtype, scheme, weight_only=False):
    return (QuantSpec(dtype, scheme, weight_only),
            JQuantSpec(dtype, scheme, weight_only))


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() or 1.0)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

CODEC_SHAPES = [((200, 96), -1), ((5, QUANT_TILE + 37), -1), ((64, 300), 0),
                ((7,), -1), ((3, 4, 130), 1)]


@pytest.mark.parametrize("shape,axis", CODEC_SHAPES)
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_codec_equals_reference(dtype, scheme, shape, axis):
    x = _rand(shape, seed=len(shape) + axis, scale=3.0)
    spec, jspec = _spec_pair(dtype, scheme)
    qt = comp.quantize(torch.from_numpy(x), spec, axis=axis)
    jqt = jcomp.quantize(jnp.asarray(x), jspec, axis=axis)
    np.testing.assert_array_equal(_np(qt.q), _np(jqt.q))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(jqt.scale))
    assert qt.q.dtype == comp.wire_dtype(spec)
    assert qt.shape == jqt.shape and qt.dtype == torch.float32
    np.testing.assert_array_equal(comp.dequantize(qt).numpy(),
                                  np.asarray(jcomp.dequantize(jqt)))
    n = shape[axis]
    np.testing.assert_array_equal(
        comp.expand_scale(qt.scale, spec, n).numpy(),
        np.asarray(jcomp.expand_scale(jqt.scale, jspec, n)))
    q, s = comp.quantize_operand(torch.from_numpy(x), spec, axis=axis)
    jq, js = jcomp.quantize_operand(jnp.asarray(x), jspec, axis=axis)
    np.testing.assert_array_equal(_np(q), _np(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_codec_zero_size_and_zeros(scheme):
    """Zero-size tensors quantize as the reference's do: no channels
    gives no scales; no rows under per_tile has no max in either package
    (a zero-size reduction), and raises."""
    spec, jspec = _spec_pair("int8", scheme)
    shapes = [(8, 0)] + ([] if scheme == "per_tile" else [(0, 64)])
    for shape in shapes:
        qt = comp.quantize(torch.zeros(shape), spec, axis=-1)
        jqt = jcomp.quantize(jnp.zeros(shape), jspec, axis=-1)
        assert tuple(qt.q.shape) == jqt.q.shape == shape
        assert tuple(qt.scale.shape) == jqt.scale.shape
        np.testing.assert_array_equal(qt.scale.numpy(),
                                      np.asarray(jqt.scale))
        assert comp.dequantize(qt).shape == shape
    if scheme == "per_tile":
        with pytest.raises(ValueError):
            jcomp.quantize(jnp.zeros((0, 64)), jspec, axis=-1)
        with pytest.raises(ValueError):
            comp.quantize(torch.zeros(0, 64), spec, axis=-1)
    back = comp.dequantize(comp.quantize(torch.zeros(8, 64), spec, axis=-1))
    assert not back.any()


def test_expand_scale_shapes_equal_reference():
    for scheme, scale in (("per_tensor", np.float32(0.5)),
                          ("per_channel", _rand((7,))),
                          ("per_tile", _rand((3,)))):
        spec, jspec = _spec_pair("int8", scheme)
        n = 7 if scheme == "per_channel" else 300
        got = comp.expand_scale(torch.tensor(scale), spec, n)
        want = jcomp.expand_scale(jnp.asarray(scale), jspec, n)
        assert tuple(got.shape) == (n,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_roundtrip_error_bound():
    """tests/test_quant.py's bound: half a quantization step per element."""
    x = torch.from_numpy(_rand((200, 96)))
    for scheme in SCHEMES:
        qt = comp.quantize(x, QuantSpec("int8", scheme), axis=-1)
        step = comp.expand_scale(qt.scale, qt.spec, 96)
        assert ((comp.dequantize(qt) - x).abs() <= step * 0.5 + 1e-7).all()


# ---------------------------------------------------------------------------
# specs, descriptors, config, plans
# ---------------------------------------------------------------------------

def test_resolve_quant_aliases_equal_reference():
    for alias in ("int8", "w8a16", "fp8", "float8_e4m3"):
        got, want = resolve_quant(alias), j_resolve_quant(alias)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert resolve_quant(None) is None and resolve_quant(False) is None
    spec = QuantSpec("int8", "per_tile")
    assert resolve_quant(spec) is spec
    assert spec.wire_itemsize == 1
    for bad in ("int4", 3):
        with pytest.raises(ValueError):
            resolve_quant(bad)
    with pytest.raises(ValueError):
        QuantSpec("int4")
    with pytest.raises(ValueError):
        QuantSpec("int8", "per_row")


@pytest.mark.parametrize("kw", [dict(accumulate=True), dict(batch=2),
                                dict(edge="pad")])
def test_quant_descriptor_constraints_match_reference(kw):
    for desc, resolve in ((GemmDescriptor, resolve_quant),
                          (jcore.GemmDescriptor, j_resolve_quant)):
        with pytest.raises(ValueError):
            desc(m=8, n=8, k=8, quant=resolve("int8"), **kw)


ALL_SPECS = [(d, s, w) for d in DTYPES for s in SCHEMES for w in (False,
                                                                   True)]


@pytest.mark.parametrize("dtype,scheme,weight_only", ALL_SPECS)
def test_cache_keys_and_costs_under_every_spec(dtype, scheme, weight_only):
    spec, jspec = _spec_pair(dtype, scheme, weight_only)
    for layout in ("nn", "nt"):
        kw = dict(m=33, n=70, k=100, layout=layout, in_dtype="bfloat16",
                  out_dtype="bfloat16", epilogue="bias_silu")
        d, j = GemmDescriptor(quant=spec, **kw), \
            jcore.GemmDescriptor(quant=jspec, **kw)
        assert d.cache_key() == j.cache_key()
        assert d.cache_key() != GemmDescriptor(**kw).cache_key()
        for attr in ("flops", "in_bytes", "out_bytes", "a_wire_itemsize",
                     "b_wire_itemsize", "compute_dtype"):
            assert getattr(d, attr) == getattr(j, attr), attr
    gkw = dict(t=96, k=64, n=128, num_experts=4, dtype="bfloat16",
               epilogue="silu")
    g, jg = GroupedGemmDescriptor(quant=spec, **gkw), \
        JGroupedDesc(quant=jspec, **gkw)
    assert g.cache_key() == jg.cache_key()
    for attr in ("flops", "in_bytes", "out_bytes", "x_wire_itemsize",
                 "w_wire_itemsize", "compute_dtype"):
        assert getattr(g, attr) == getattr(jg, attr), attr


def test_from_operands_w8a16_takes_an_int8_b():
    a = torch.zeros(4, 8, dtype=torch.bfloat16)
    b = torch.zeros(8, 6, dtype=torch.int8)
    d = GemmDescriptor.from_operands(a, b, quant="w8a16", out_dtype="bfloat16")
    j = jcore.GemmDescriptor.from_operands(
        jnp.zeros((4, 8), jnp.bfloat16), jnp.zeros((8, 6), jnp.int8),
        quant="w8a16", out_dtype=jnp.bfloat16)
    assert d.cache_key() == j.cache_key()
    with pytest.raises(ValueError, match="dtype mismatch"):
        GemmDescriptor.from_operands(a, b)


def test_ambient_quant_config_and_env(monkeypatch):
    assert get_config().quant is None
    with use(quant="w8a16"):
        assert get_config().quant == resolve_quant("w8a16")
        with use(quant=False):
            assert get_config().quant is None
        with use(backend="torch"):  # None leaves the spec as it is
            assert get_config().quant == resolve_quant("w8a16")
    with pytest.raises(ValueError):
        EngineConfig(quant="int8")
    for raw, want in (("fp8", resolve_quant("fp8")), ("off", None),
                      ("", None)):
        monkeypatch.setenv("REPRO_QUANT", raw)
        assert _env_default().quant == want
    monkeypatch.setenv("REPRO_QUANT", "int4")
    with pytest.warns(UserWarning, match="REPRO_QUANT"):
        assert _env_default().quant is None


QPLANS = [(80, 160, 96), (33, 70, 100), (1024, 3072, 1024), (8, 2048, 1024),
          (137, 1024, 2048), (4096, 4096, 8192), (1, 151936, 1024)]


@pytest.mark.parametrize("m,n,k", QPLANS)
@pytest.mark.parametrize("mode", MODES)
def test_tpu_quant_plans_equal_reference(m, n, k, mode):
    in_dtype = {"int8": "int8", "fp8": "float8_e4m3",
                "w8a16": "bfloat16"}[mode]
    kw = dict(m=m, n=n, k=k, in_dtype=in_dtype, out_dtype="bfloat16")
    d = GemmDescriptor(quant=resolve_quant(mode), **kw)
    j = jcore.GemmDescriptor(quant=j_resolve_quant(mode), **kw)
    plan, jplan = plan_gemm(d, TPU_V5E), jcore.plan_gemm(j)
    assert [(r.row0, r.col0, r.rows, r.cols, r.bm, r.bn)
            for r in plan.regions] == [(r.row0, r.col0, r.rows, r.cols, r.bm,
                                        r.bn) for r in jplan.regions]
    assert (plan.bk, plan.fused) == (jplan.bk, jplan.fused)
    assert fused_legal(d, TPU_V5E) == jcore.fused_legal(j)
    assert plan.predicted_seconds(TPU_V5E) == pytest.approx(
        jplan.predicted_seconds(jcore.TPU_V5E), rel=1e-12)


@pytest.mark.parametrize("t,k,n,e", [(96, 64, 128, 4), (4096, 4096, 6400, 16),
                                     (512, 6400, 4096, 16)])
@pytest.mark.parametrize("mode", MODES)
def test_tpu_quant_grouped_plans_equal_reference(t, k, n, e, mode):
    kw = dict(t=t, k=k, n=n, num_experts=e, dtype="bfloat16")
    d = GroupedGemmDescriptor(quant=resolve_quant(mode), **kw)
    j = JGroupedDesc(quant=j_resolve_quant(mode), **kw)
    plan, jplan = plan_grouped(d, TPU_V5E), j_plan_grouped(j)
    assert (plan.bm, plan.bk, plan.bn, plan.fused) == \
        (jplan.bm, jplan.bk, jplan.bn, jplan.fused)
    assert grouped_fused_legal(d, TPU_V5E) == \
        jcore.blocking.grouped_fused_legal(j)


# Qwen3-0.6B's W8A16 projections (continuous prefills are ragged) and
# phi3.5-moe's int8 expert GEMMs: on the H100 every one plans fused, so the
# quantized main path runs the quant kernels, never the kernel-free
# composition.
H100_SHAPES = [(m, n, k) for m in (8, 96, 137, 256, 1024)
               for n, k in ((2048, 1024), (1024, 1024), (1024, 2048),
                            (3072, 1024), (1024, 3072))]


@pytest.mark.parametrize("m,n,k", H100_SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_h100_quant_plans_are_fused(m, n, k, mode):
    in_dtype = {"int8": "int8", "fp8": "float8_e4m3",
                "w8a16": "bfloat16"}[mode]
    plan = plan_gemm(GemmDescriptor(m=m, n=n, k=k, in_dtype=in_dtype,
                                    out_dtype="bfloat16",
                                    quant=resolve_quant(mode)))
    assert plan.fused and plan.bk == H100_SXM.k_panel
    # the wide plan may split into regions and run them unfused
    assert plan.validate()


@pytest.mark.parametrize("t,k,n", [(4096, 4096, 6400), (4096, 6400, 4096),
                                   (512, 4096, 6400), (512, 6400, 4096)])
def test_h100_quant_grouped_plans_are_fused(t, k, n):
    plan = plan_grouped(GroupedGemmDescriptor(
        t=t, k=k, n=n, num_experts=16, dtype="bfloat16",
        quant=resolve_quant("int8")))
    assert plan.fused
    assert (plan.bm, plan.bk, plan.bn) in H100_SXM.grouped_blocks


# ---------------------------------------------------------------------------
# the quantized GEMM
# ---------------------------------------------------------------------------

EPIS = [(None, True), ("relu", True), ("bias", False), ("bias_gelu", False),
        ("silu", False), ("bias_silu", False), ("gelu", False)]


@pytest.mark.parametrize("layout", ["nn", "nt"])
@pytest.mark.parametrize("epilogue,exact", EPIS)
@pytest.mark.parametrize("mode", MODES)
def test_quant_gemm_equals_reference_lowerings(mode, epilogue, exact, layout):
    """The port's fused lowering (plain on the CPU) and its non-fused one
    against the reference's ``_xla_quant_gemm`` on the same quantized
    operands, and the reference's interpret-mode fused kernel from the
    same wide operands."""
    m, k, n = 80, 96, 160
    a, bias = _rand((m, k), 1), _rand((n,), 3)
    b = _rand((k, n) if layout == "nn" else (n, k), 2)
    spec, jspec = resolve_quant(mode), j_resolve_quant(mode)
    axis = 1 if layout == "nn" else 0
    bq, sb = comp.quantize_operand(torch.from_numpy(b), spec, axis=axis)
    jbq, jsb = jcomp.quantize_operand(jnp.asarray(b), jspec, axis=axis)
    aq, sa, jaq, jsa = torch.from_numpy(a), None, jnp.asarray(a), None
    if not spec.weight_only:
        aq, sa = comp.quantize_operand(aq, spec, axis=0)
        jaq, jsa = jcomp.quantize_operand(jaq, jspec, axis=0)
    biased = epilogue is not None and epilogue.startswith("bias")
    tb = torch.from_numpy(bias) if biased else None
    jb = jnp.asarray(bias) if biased else None
    jdesc = jcore.GemmDescriptor.from_operands(
        jaq, jbq, layout=layout, epilogue=epilogue, quant=jspec,
        out_dtype=jnp.float32)
    want = np.asarray(j_xla_quant_gemm(jdesc, jaq, jbq, jb, jsa, jsb))
    engine.reset_stats()
    fused = gemm(torch.from_numpy(a), torch.from_numpy(b), layout=layout,
                 epilogue=epilogue, bias=tb, quant=mode, fused=True)
    assert engine.stats()["gemm"]["launches"] == 1
    unfused = gemm(torch.from_numpy(a), torch.from_numpy(b), layout=layout,
                   epilogue=epilogue, bias=tb, quant=mode, fused=False)
    assert engine.stats()["gemm"]["launches"] == 1  # the composition: 0
    for got in (fused, unfused):
        assert got.dtype == torch.float32
        if exact and mode == "int8":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                       rtol=1e-5)
    with jcore.use(backend="pallas"):
        jfused = np.asarray(j_gemm(jnp.asarray(a), jnp.asarray(b),
                                   layout=layout, epilogue=epilogue, bias=jb,
                                   quant=mode, fused=True))
    bound = 1e-3 if mode == "fp8" else 1e-5
    assert rel_err(fused.numpy(), jfused) < bound


@pytest.mark.parametrize("m,k,n", [(80, 96, 160), (128, 128, 128),
                                   (33, 70, 100)])
@pytest.mark.parametrize("mode", MODES)
def test_quant_gemm_parity_with_dequant_oracle(m, k, n, mode):
    """tests/test_quant.py's parity: the only error is the quantization."""
    a, b = _rand((m, k), 4), _rand((k, n), 5)
    spec = resolve_quant(mode)
    bq, sb = comp.quantize_operand(torch.from_numpy(b), spec, axis=1)
    bd = bq.float() * sb[None, :]
    if spec.weight_only:
        ref = torch.from_numpy(a) @ bd
    else:
        aq, sa = comp.quantize_operand(torch.from_numpy(a), spec, axis=0)
        ref = (aq.float() * sa[:, None]) @ bd
    out = gemm(torch.from_numpy(a), torch.from_numpy(b), quant=mode)
    assert rel_err(out.numpy(), ref.numpy()) < (1e-3 if mode == "fp8"
                                                 else 1e-5)
    assert rel_err(out.numpy(), a @ b) < (1e-1 if mode == "fp8" else 5e-2)


def test_quant_gemm_per_schemes():
    a, b = _rand((64, QUANT_TILE + 32), 6), _rand((QUANT_TILE + 32, 96), 7)
    for scheme in SCHEMES:
        out = gemm(torch.from_numpy(a), torch.from_numpy(b),
                   quant=QuantSpec("int8", scheme))
        with jcore.use(backend="pallas"):
            want = j_gemm(jnp.asarray(a), jnp.asarray(b),
                          quant=JQuantSpec("int8", scheme))
        assert rel_err(out.numpy(), np.asarray(want)) < 1e-5, scheme
        assert rel_err(out.numpy(), a @ b) < 5e-2, scheme


def test_quant_gemm_one_launch_ambient_and_opt_out():
    a, b = torch.from_numpy(_rand((48, 64), 8)), \
        torch.from_numpy(_rand((64, 80), 9))
    wide = gemm(a, b)
    with use(quant="int8"):
        engine.reset_stats()
        q = gemm(a, b)
        assert engine.stats()["gemm"]["launches"] == 1
        opt_out = gemm(a, b, quant=False)
    assert rel_err(q.numpy(), wide.numpy()) > 1e-6  # really quantized
    torch.testing.assert_close(opt_out, wide, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="unbatched"):
        gemm(a[None], b[None], quant="int8")


@pytest.mark.parametrize("backend,j_backend", [("torch", "xla"),
                                               ("engine", "pallas")])
@pytest.mark.parametrize("epilogue", [None, "bias_silu"])
def test_quantized_tensor_through_matmul(backend, j_backend, epilogue):
    """A W8A16 weight quantized once at load, through ``matmul`` on both
    backends, against the reference's ``matmul`` with its own."""
    w, x, bias = _rand((64, 48), 10), _rand((2, 16, 64), 11), _rand((48,), 12)
    qt = comp.quantize(torch.from_numpy(w), "w8a16", axis=-1)
    jqt = jcomp.quantize(jnp.asarray(w), "w8a16", axis=-1)
    tb = torch.from_numpy(bias) if epilogue else None
    jb = jnp.asarray(bias) if epilogue else None
    with use(backend=backend):
        engine.reset_stats()
        got = matmul(torch.from_numpy(x), qt, epilogue=epilogue, bias=tb)
        launches = engine.stats().get("gemm", {}).get("launches", 0)
    assert launches == (1 if backend == "engine" else 0)
    with jcore.use(backend=j_backend):
        want = j_matmul(jnp.asarray(x), jqt, epilogue=epilogue, bias=jb)
    assert got.shape == (2, 16, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="nn"):
        matmul(torch.from_numpy(x), qt, layout="nt")


def test_gemm_quant_wrapper_checks_and_plain_version():
    m, n, k = 40, 50, 60
    a, b = torch.from_numpy(_rand((m, k), 13)), \
        torch.from_numpy(_rand((k, n), 14))
    spec = resolve_quant("int8")
    aq, sa = comp.quantize_operand(a, spec, axis=0)
    bq, sb = comp.quantize_operand(b, spec, axis=1)
    exe = FusedGemm(plan_gemm(GemmDescriptor(m=m, n=n, k=k, in_dtype="int8",
                                             quant=spec)).tile_schedule(),
                    "cpu")
    n0 = LAUNCHES["gemm_quant"]
    got = gemm_quant(exe, aq, bq, sa, sb)
    assert LAUNCHES["gemm_quant"] == n0  # the CPU runs the plain version
    torch.testing.assert_close(got, gemm_quant_plain(aq, bq, sa, sb),
                               atol=0, rtol=0)
    torch.testing.assert_close(got, ref_quant_gemm(aq, bq, sa, sb), atol=0,
                               rtol=0)
    with pytest.raises(ValueError, match="int8 or float8"):
        gemm_quant(exe, aq, b, sa, sb)
    with pytest.raises(ValueError, match="differ"):
        gemm_quant(exe, a, bq, sa, sb)
    with pytest.raises(ValueError, match="sb"):
        gemm_quant(exe, aq, bq, sa, sb[:-1])


def test_int8_accumulation_is_exact_past_two_to_the_24():
    """K = 3072 of +-127 x +-127: sums near 5e7, where an fp32 sum of the
    products would round; the int32 accumulator (here float64) is exact."""
    from repro_torch.kernels.gemm.ref import quant_product
    k = 3072
    a = torch.full((2, k), 127, dtype=torch.int8)
    b = torch.full((k, 3), 127, dtype=torch.int8)
    b[0, 0] = 1
    acc = quant_product(a, b)
    assert acc.dtype == torch.int32
    assert acc[0, 0].item() == 127 * 127 * (k - 1) + 127  # odd: not an fp32
    assert acc[0, 1].item() == 127 * 127 * k
    assert float(torch.tensor(acc[0, 0].item(), dtype=torch.float32)) \
        != acc[0, 0].item()


# ---------------------------------------------------------------------------
# the quantized grouped GEMM
# ---------------------------------------------------------------------------

def _grouped_operands(e=4, t=96, k=64, n=128, sizes=(40, 0, 30, 26),
                      seed=20):
    x, w = _rand((t, k), seed), _rand((e, k, n), seed + 1)
    return x, w, np.asarray(sizes, np.int32)


@pytest.mark.parametrize("mode", MODES)
def test_quant_grouped_equals_reference(mode):
    """tests/test_quant.py's grouped parity, against the reference's
    interpret-mode fused kernel and its XLA lowering."""
    x, w, gs = _grouped_operands(t=100)
    tgs = torch.from_numpy(gs)
    engine.reset_stats()
    fused = grouped_gemm(torch.from_numpy(x), torch.from_numpy(w), tgs,
                         quant=mode)
    assert engine.stats()["grouped_gemm"]["launches"] == 1
    unfused = grouped_gemm(torch.from_numpy(x), torch.from_numpy(w), tgs,
                           quant=mode, fused=False)
    assert engine.stats()["grouped_gemm"]["launches"] == 1
    with jcore.use(backend="pallas"):
        jfused = np.asarray(j_grouped_gemm(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(gs), quant=mode))
        junfused = np.asarray(j_grouped_gemm(jnp.asarray(x), jnp.asarray(w),
                                             jnp.asarray(gs), quant=mode,
                                             fused=False))
    bound = 1e-3 if mode == "fp8" else 1e-4
    for got in (fused, unfused):
        assert rel_err(got.numpy(), junfused) < bound
        assert rel_err(got.numpy(), jfused) < bound
        assert not got[96:].any()  # rows past the groups
    if mode == "int8":  # exact int32 sums, the same dequant products
        np.testing.assert_array_equal(fused.numpy(), unfused.numpy())
        np.testing.assert_array_equal(unfused.numpy(), junfused)
    grp = np.repeat(np.arange(4), gs)
    wide = np.einsum("tk,tkn->tn", x[:96], w[grp])
    assert rel_err(fused.numpy()[:96], wide) < (1e-1 if mode == "fp8"
                                                 else 5e-2)


@pytest.mark.parametrize("epilogue", ["bias_silu", "relu", "gelu", "bias"])
def test_quant_grouped_epilogues(epilogue):
    x, w, gs = _grouped_operands(e=3, t=64, k=48, n=96, sizes=(20, 24, 20),
                                 seed=30)
    bias = _rand((3, 96), 33)
    biased = epilogue.startswith("bias")
    tb = torch.from_numpy(bias) if biased else None
    got = grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(gs), quant="int8", epilogue=epilogue,
                       bias=tb)
    with jcore.use(backend="pallas"):
        want = j_grouped_gemm(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(gs), quant="int8",
                              epilogue=epilogue,
                              bias=jnp.asarray(bias) if biased else None,
                              fused=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_quant_grouped_ambient_config_and_wrapper():
    x, w, gs = _grouped_operands(e=3, t=48, k=32, n=64, sizes=(16, 16, 16),
                                 seed=40)
    tx, tw, tgs = (torch.from_numpy(v) for v in (x, w, gs))
    with use(quant="int8"):
        q = grouped_gemm(tx, tw, tgs)
        wide = grouped_gemm(tx, tw, tgs, quant=False)
    assert rel_err(q.numpy(), wide.numpy()) > 1e-6
    n0 = grouped_kernel.LAUNCHES["grouped_quant"]
    plan = plan_grouped(GroupedGemmDescriptor(t=48, k=32, n=64, num_experts=3,
                                              quant=resolve_quant("int8")))
    table = plan.tile_schedule().tables(tgs)
    parts = [comp.quantize_operand(tw[e], resolve_quant("int8"), axis=1)
             for e in range(3)]
    wq = torch.stack([p[0] for p in parts])
    sw = torch.stack([p[1] for p in parts])
    xq, sx = comp.quantize_operand(tx, resolve_quant("int8"), axis=0)
    got = grouped_kernel.grouped_quant(table, xq, wq, sx, sw, bm=plan.bm,
                                       bn=plan.bn)
    assert grouped_kernel.LAUNCHES["grouped_quant"] == n0
    np.testing.assert_array_equal(got.numpy(), q.numpy())
    with pytest.raises(ValueError, match="sw"):
        grouped_kernel.grouped_quant(table, xq, wq, sx, sw[:, :-1], bm=16,
                                     bn=64)


# ---------------------------------------------------------------------------
# quantize_model and error feedback
# ---------------------------------------------------------------------------

def test_quantize_model_trees_equal_reference():
    """The same parameter tree through both packages' quantize_model: the
    2-D ``w`` leaves become quantized tensors with equal int8 values and
    f32 scales; tables, norms, biases and 3-D expert banks stay wide."""
    tree = {"embed": {"table": _rand((50, 16), 50)},
            "attn": {"wq": {"w": _rand((16, 32), 51), "b": _rand((32,), 52)},
                     "q_norm": {"scale": _rand((8,), 53)}},
            "ff": {"w_up": {"w": _rand((4, 16, 24), 54)},
                   "router": {"w": _rand((16, 4), 55)}},
            "lm_head": {"w": _rand((16, 50), 56)}}
    jq = jcomp.quantize_model(jax.tree.map(jnp.asarray, tree), "w8a16")
    flat = {}

    def walk(node, prefix):
        for key, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{key}.")
            else:
                flat[f"{prefix}{key}"] = torch.from_numpy(v)

    walk(tree, "")
    got = comp.quantize_model(flat, "w8a16")
    for name, v in got.items():
        node = jq
        for part in name.split("."):
            node = node[part]
        if isinstance(node, jcomp.QuantizedTensor):
            assert isinstance(v, comp.QuantizedTensor), name
            np.testing.assert_array_equal(v.q.numpy(), np.asarray(node.q))
            np.testing.assert_array_equal(v.scale.numpy(),
                                          np.asarray(node.scale))
            assert v.spec.weight_only and v.axis == node.axis == -1
        else:
            assert not isinstance(v, comp.QuantizedTensor), name
            np.testing.assert_array_equal(v.numpy(), np.asarray(node))
    small = comp.quantize_model(flat, "w8a16", min_size=600)
    assert not isinstance(small["attn.wq.w"], comp.QuantizedTensor)
    assert isinstance(small["lm_head.w"], comp.QuantizedTensor)
    assert comp.quantize_model(flat, None) is flat


def test_quantize_model_replaces_module_weights_in_place():
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import LanguageModel
    from repro_torch.models.common import cast_param, tree_cast
    cfg = reduced_config(get_config("qwen3-0.6b"))
    model = LanguageModel(cfg, device="cpu", seed=0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert comp.quantize_model(model, "w8a16") is model
    after = dict(model.named_parameters())
    gone = set(before) - set(after)
    # every projection's wide weight is gone (7 a layer; the read-out is
    # the tied table, which stays wide)
    assert len(gone) == 7 * cfg.num_layers
    assert all(n.endswith(".w") for n in gone)
    for name in gone:
        mod = model.get_submodule(name[:-2])
        qt = mod.w
        assert isinstance(qt, comp.QuantizedTensor)
        assert qt.q.dtype == torch.int8 and qt.scale.dtype == torch.float32
        want = comp.quantize(before[name], "w8a16", axis=-1)
        assert torch.equal(qt.q, want.q) and torch.equal(qt.scale, want.scale)
        assert cast_param(qt, torch.bfloat16) is qt
    assert "embed.table" in after
    cast = tree_cast({"a": model.blocks[0].mixer.wq.w,
                      "b": torch.zeros(3)}, torch.bfloat16)
    assert isinstance(cast["a"], comp.QuantizedTensor)
    assert cast["b"].dtype == torch.bfloat16


def test_error_feedback_compress_equals_reference():
    grads = {"a.w": _rand((300, 7), 60), "b": _rand((5,), 61),
             "c": _rand((2, 3, 129), 62) * 1e-3}
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    res = jres = None
    for step in range(3):
        tg_step = {k: v * (step + 1) for k, v in tg.items()}
        jg_step = {k: v * (step + 1) for k, v in jg.items()}
        got, res = comp.error_feedback_compress(tg_step, res)
        want, jres = jcomp.error_feedback_compress(jg_step, jres)
        for k in grads:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
            np.testing.assert_array_equal(res[k].numpy(),
                                          np.asarray(jres[k]))
            assert got[k].dtype == res[k].dtype == torch.float32
