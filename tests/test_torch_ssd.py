"""The port's SSD chunked-scan family (forward) against the reference: the
descriptors, the planners under ``TPU_V5E`` and ``H100_SXM``, the plain
oracles and the engine-dispatched scan (fused and ``fused="off"``)
against JAX's ``ref.py`` oracles and JAX's ``ssd_chunk_scan`` under
``backend="pallas"`` (interpret mode, as the reference's tests run it),
on the same numpy inputs.

Tolerances: float32 atol = rtol = 1e-4 (float32 on both sides, products
summed in another order).  All-bfloat16 operands: rtol 1e-2 and atol two
bfloat16 ulps of the largest output (2^-7 of it): the reference rounds
the intra-chunk part to bfloat16 before adding the inter-chunk part and
the fused kernel does not, so where the two parts cancel the difference
is an ulp of the parts, not of their sum.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.blocking import plan_ssd as j_plan_ssd
from repro.core.blocking import plan_ssd_bwd as j_plan_ssd_bwd
from repro.core.descriptor import SsdChunkBwdDescriptor as JBwdDesc
from repro.core.descriptor import SsdChunkDescriptor as JDesc
from repro.kernels.ssd_chunk import ref_ssd_chunk_diag as j_ref_diag
from repro.kernels.ssd_chunk import ref_ssd_chunk_scan as j_ref_scan
from repro.kernels.ssd_chunk import ssd_chunk_diag as j_diag
from repro.kernels.ssd_chunk import ssd_chunk_scan as j_scan

from repro_torch.core import (H100_SXM, TPU_V5E, SsdChunkBwdDescriptor,
                              SsdChunkDescriptor, engine, plan_ssd,
                              plan_ssd_bwd, ssd_bwd_fused_legal,
                              ssd_fused_legal, use)
from repro_torch.kernels.ssd_chunk import (ref_ssd_chunk_diag,
                                           ref_ssd_chunk_scan,
                                           ssd_chunk_diag, ssd_chunk_scan)
from repro_torch.kernels.ssd_chunk.kernel import (LAUNCHES, ssd_chunk_diag
                                                  as diag_kernel,
                                                  ssd_chunk_diag_plain,
                                                  ssd_scan_fused,
                                                  ssd_scan_fused_plain)

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = "bf16"  # see the module docstring

# (g, nc, q, n, p): tests/test_kernels_other.py's scan cases.
SCAN_CASES = [(2, 3, 16, 8, 12), (1, 1, 8, 4, 4), (4, 7, 32, 16, 8)]


@pytest.fixture(autouse=True)
def _cpu():
    with use(device="cpu", backend="engine"):
        engine.reset_stats()
        yield


def _scan_case(g, nc, q, n, p, seed=11):
    """tests/test_kernels_other.py's ``_ssd_scan_case`` in numpy: physical
    decays (decay_in in (0, 1], its last element the whole-chunk decay)."""
    r = np.random.default_rng(seed)
    arr = lambda s: r.standard_normal(s).astype(np.float32)
    c, b = arr((g, nc, q, n)), arr((g, nc, q, n))
    l = np.tril(np.exp(arr((g, nc, q, q)) * 0.1)).astype(np.float32)
    x = arr((g, nc, q, p))
    da_cs = -np.cumsum(np.abs(arr((g, nc, q))) * 0.1, axis=-1)
    di = np.exp(da_cs).astype(np.float32)
    do = np.exp(da_cs[..., -1:] - da_cs).astype(np.float32)
    s0 = arr((g, p, n))
    return c, b, l, x, di, do, s0


def _torch(ops, dtypes=None):
    dtypes = dtypes or (None,) * len(ops)
    return [torch.from_numpy(o) if dt is None else
            torch.from_numpy(o).to(dt) for o, dt in zip(ops, dtypes)]


def _jax(ops, dtypes=None):
    dtypes = dtypes or (None,) * len(ops)
    return [jnp.asarray(o) if dt is None else jnp.asarray(o, dt)
            for o, dt in zip(ops, dtypes)]


def _tol(tol, want):
    if tol == BF16:
        return dict(atol=2.0 ** -7 * float(np.abs(want).max()), rtol=1e-2)
    return tol


def _close(got, want, tol=F32):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(tol, want))


# ---------------------------------------------------------------------------
# descriptors and plans
# ---------------------------------------------------------------------------

DESCS = [dict(groups=2, q=16, n=8, p=12, chunks=3),
         dict(groups=6, q=16, n=8, p=12),
         dict(groups=96, q=256, n=128, p=64, chunks=4),
         dict(groups=192, q=256, n=128, p=64, chunks=4, dtype="bfloat16"),
         dict(groups=384, q=256, n=128, p=64),
         dict(groups=4, q=512, n=256, p=128, chunks=2),
         dict(groups=1, q=1024, n=64, p=64, chunks=8, dtype="bfloat16")]


@pytest.mark.parametrize("kw", DESCS)
def test_descriptors_equal_reference(kw):
    desc, jdesc = SsdChunkDescriptor(**kw), JDesc(**kw)
    assert desc.cache_key() == jdesc.cache_key()
    assert (desc.cells, desc.flops, desc.in_bytes, desc.out_bytes) == \
        (jdesc.cells, jdesc.flops, jdesc.in_bytes, jdesc.out_bytes)
    if kw.get("chunks"):
        bdesc = SsdChunkBwdDescriptor.from_forward(desc)
        jb = JBwdDesc.from_forward(jdesc)
        assert bdesc.cache_key() == jb.cache_key()
        assert (bdesc.flops, bdesc.in_bytes, bdesc.out_bytes) == \
            (jb.flops, jb.in_bytes, jb.out_bytes)


def test_descriptors_from_operands_equal_reference():
    ops = _scan_case(2, 3, 16, 8, 12)
    t, j = _torch(ops), _jax(ops)
    assert SsdChunkDescriptor.from_scan_operands(t[0], t[3]).cache_key() == \
        JDesc.from_scan_operands(j[0], j[3]).cache_key()
    flat = [a.reshape(-1, *a.shape[2:]) for a in t[:4]]
    jflat = [a.reshape(-1, *a.shape[2:]) for a in j[:4]]
    assert SsdChunkDescriptor.from_operands(flat[0], flat[3]).cache_key() == \
        JDesc.from_operands(jflat[0], jflat[3]).cache_key()


@pytest.mark.parametrize("kw", DESCS)
def test_tpu_plans_equal_reference(kw):
    plan, jplan = plan_ssd(SsdChunkDescriptor(**kw), TPU_V5E), \
        j_plan_ssd(JDesc(**kw))
    assert (plan.fits_vmem, plan.fused) == (jplan.fits_vmem, jplan.fused)
    assert plan.predicted_seconds(TPU_V5E) == pytest.approx(
        jplan.predicted_seconds(), rel=1e-12)
    if kw.get("chunks"):
        bplan = plan_ssd_bwd(SsdChunkBwdDescriptor(**kw), TPU_V5E)
        jb = j_plan_ssd_bwd(JBwdDesc(**kw))
        assert (bplan.fits_vmem, bplan.fused) == (jb.fits_vmem, jb.fused)


@pytest.mark.parametrize("groups,dtype", [(96, "float32"), (192, "float32"),
                                          (96, "bfloat16")])
def test_h100_plans_full_width_mamba2_fused(groups, dtype):
    """Full-width mamba2-130m (Q 256, n 128, p 64) runs the one-launch scan
    and the one-launch reverse walk on the H100: the VMEM formula copied
    as it is would need ~1 MB against half of 227 KB and fall back."""
    desc = SsdChunkDescriptor(groups=groups, q=256, n=128, p=64,
                              dtype=dtype, chunks=4)
    assert plan_ssd(desc, H100_SXM).fused
    assert ssd_fused_legal(desc, H100_SXM)
    bdesc = SsdChunkBwdDescriptor.from_forward(desc)
    assert plan_ssd_bwd(bdesc, H100_SXM).fused
    assert ssd_bwd_fused_legal(bdesc, H100_SXM)
    # the diag form has no fused lowering but is in the kernel's limits
    diag = SsdChunkDescriptor(groups=groups * 4, q=256, n=128, p=64)
    assert not plan_ssd(diag, H100_SXM).fused
    assert plan_ssd(diag, H100_SXM).fits_vmem


@pytest.mark.parametrize("q,n,p", [(512, 128, 64), (256, 256, 64),
                                   (256, 128, 128)])
def test_h100_refuses_geometry_outside_kernel_limits(q, n, p):
    desc = SsdChunkDescriptor(groups=2, q=q, n=n, p=p, chunks=2)
    assert not ssd_fused_legal(desc, H100_SXM)
    assert not ssd_bwd_fused_legal(SsdChunkBwdDescriptor.from_forward(desc),
                                   H100_SXM)
    with pytest.raises(NotImplementedError, match="SSD kernel limits"):
        plan_ssd(desc, H100_SXM)
    with pytest.raises(NotImplementedError, match="SSD kernel limits"):
        plan_ssd(SsdChunkDescriptor(groups=4, q=q, n=n, p=p), H100_SXM)


# ---------------------------------------------------------------------------
# oracles and the dispatched scan against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SCAN_CASES)
def test_port_oracles_match_reference_oracles(shape):
    ops = _scan_case(*shape)
    jy, js = j_ref_scan(*_jax(ops))
    y, s = ref_ssd_chunk_scan(*_torch(ops))
    _close(y, jy)
    _close(s, js)
    g, nc, q, n = shape[:4]
    flat = [o.reshape(g * nc, *o.shape[2:]) for o in ops[:4]]
    _close(ref_ssd_chunk_diag(*_torch(flat)), j_ref_diag(*_jax(flat)))


@pytest.mark.parametrize("shape", SCAN_CASES)
@pytest.mark.parametrize("fused", ["auto", "off"])
def test_scan_matches_reference_pallas_and_oracle(shape, fused):
    ops = _scan_case(*shape)
    with jcore.use(backend="pallas"):
        py, ps = j_scan(*_jax(ops))
    jy, js = j_ref_scan(*_jax(ops))
    with use(fused=fused):
        y, s = ssd_chunk_scan(*_torch(ops))
    for want_y, want_s in ((py, ps), (jy, js)):
        _close(y, want_y)
        _close(s, want_s)
    assert engine.stats()["ssd_chunk"]["launches"] == 1


def test_diag_matches_reference_pallas():
    ops = _scan_case(3, 2, 16, 8, 12)
    flat = [o.reshape(6, *o.shape[2:]) for o in ops[:4]]
    with jcore.use(backend="pallas"):
        want = j_diag(*_jax(flat))
    got = ssd_chunk_diag(*_torch(flat))
    _close(got, want)
    assert engine.stats()["ssd_chunk"]["launches"] == 1


@pytest.mark.parametrize("dtypes,tol", [
    # the model's mix: bf16 C/B, fp32 L and xdt (no rounding point)
    ((torch.bfloat16, torch.bfloat16, None, None), F32),
    ((torch.bfloat16,) * 4, BF16)])
def test_bfloat16_scan_matches_reference(dtypes, tol):
    ops = _scan_case(2, 3, 16, 8, 12)
    jdt = [None if d is None else jnp.bfloat16 for d in dtypes]
    jy, js = j_ref_scan(*_jax(ops, jdt + [None] * 3))
    for fused in ("auto", "off"):
        with use(fused=fused):
            y, s = ssd_chunk_scan(*_torch(ops, list(dtypes) + [None] * 3))
        assert y.dtype == (dtypes[3] or torch.float32)
        _close(y, jy, tol)
        _close(s, js, tol)


def test_fused_matches_fused_off():
    ops = _torch(_scan_case(4, 7, 32, 16, 8))
    y_f, s_f = ssd_chunk_scan(*ops)
    with use(fused="off"):
        y_m, s_m = ssd_chunk_scan(*ops)
    torch.testing.assert_close(y_f, y_m, **F32)
    torch.testing.assert_close(s_f, s_m, **F32)


def test_carried_state_seam():
    """A scan split in two with the state handed across the seam equals
    the unsplit scan (tests/test_kernels_other.py's carried-state tail)."""
    c, b, l, x, di, do, s0 = _torch(_scan_case(2, 4, 16, 8, 12))
    y_full, s_full = ssd_chunk_scan(c, b, l, x, di, do, s0)
    cut = 2
    y1, s_mid = ssd_chunk_scan(c[:, :cut], b[:, :cut], l[:, :cut], x[:, :cut],
                               di[:, :cut], do[:, :cut], s0)
    y2, s_end = ssd_chunk_scan(c[:, cut:], b[:, cut:], l[:, cut:], x[:, cut:],
                               di[:, cut:], do[:, cut:], s_mid)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_full, **F32)
    torch.testing.assert_close(s_end, s_full, **F32)


@pytest.mark.parametrize("fused", ["auto", "on", "off"])
def test_one_launch_per_scan(fused):
    ops = _torch(_scan_case(2, 5, 16, 8, 8))
    with use(fused=fused):
        ssd_chunk_scan(*ops)
    assert engine.stats()["ssd_chunk"]["launches"] == 1


def test_plain_fused_returns_entering_states():
    """``return_states``: chunk 0 enters with s0 and chunk i with the state
    after chunk i - 1, which a scan over the first i chunks returns."""
    ops = _torch(_scan_case(2, 4, 16, 8, 12))
    y, sf, states = ssd_scan_fused(*ops, return_states=True)
    torch.testing.assert_close(states[:, 0], ops[6])
    for i in range(1, 4):
        _, s_i = ssd_scan_fused_plain(*(o[:, :i] for o in ops[:6]), ops[6])
        torch.testing.assert_close(states[:, i], s_i)
    y_r, s_r = ref_ssd_chunk_scan(*ops)
    torch.testing.assert_close(y, y_r, **F32)
    torch.testing.assert_close(sf, s_r, **F32)


def test_wrappers_reject_what_the_kernels_do_not_take():
    c, b, l, x, di, do, s0 = _torch(_scan_case(2, 3, 16, 8, 12))
    with pytest.raises(ValueError, match="b must be"):
        ssd_scan_fused(c, b[:, :2], l, x, di, do, s0)
    with pytest.raises(ValueError, match="dtypes differ"):
        ssd_scan_fused(c, b.bfloat16(), l, x, di, do, s0)
    with pytest.raises(ValueError, match="s0 must be"):
        ssd_scan_fused(c, b, l, x, di, do, s0.double())
    with pytest.raises(ValueError, match="expected c"):
        diag_kernel(c, b, l, x)


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtypes", [
    ((2, 3, 16, 8, 12), (torch.float32,) * 3),
    ((3, 2, 100, 40, 24), (torch.bfloat16, torch.float32, torch.bfloat16)),
    ((8, 2, 256, 128, 64), (torch.bfloat16, torch.float32, torch.float32))])
def test_scan_and_diag_kernels_on_card(cuda_device, shape, dtypes):
    cdt, ldt, xdt = dtypes
    c, b, l, x, di, do, s0 = (t.to(cuda_device) for t in _torch(
        _scan_case(*shape), (cdt, cdt, ldt, xdt, None, None, None)))
    tol = BF16 if xdt == torch.bfloat16 else F32
    n0 = dict(LAUNCHES)
    y, sf, st = ssd_scan_fused(c, b, l, x, di, do, s0, return_states=True)
    g, nc, q, n = c.shape
    flat = [t.reshape(g * nc, *t.shape[2:]) for t in (c, b, l, x)]
    yd = diag_kernel(*flat)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan_fused"] == n0["ssd_scan_fused"] + 1
    assert LAUNCHES["ssd_chunk_diag"] == n0["ssd_chunk_diag"] + 1
    yp, sfp, stp = ssd_scan_fused_plain(c, b, l, x, di, do, s0,
                                        return_states=True)
    _close(y.cpu(), yp.cpu().float().numpy(), tol)
    torch.testing.assert_close(sf, sfp, **F32)
    torch.testing.assert_close(st, stp, **F32)
    _close(yd.cpu(), ssd_chunk_diag_plain(*flat).cpu().float().numpy(), tol)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")
