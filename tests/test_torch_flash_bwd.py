"""The port's flash-attention backward (plain versions on the CPU) against
the reference's: gradients through ``flash_attention`` against JAX's
(its scheduled Pallas backward in interpret mode), the forward's LSE rows
against the reference kernel's ``return_lse``, the backward descriptor
and plans, launch accounting, the ``fused="off"`` fallback and the
k-block index the CUDA backward walks.

Gradient tolerances are those of tests/test_grad_parity.py: atol 2e-4,
rtol 2e-3 in float32; 1e-1 in bfloat16 (the two packages round the bf16
operands and outputs at different points).  The LSE agrees to 1e-5
(float32, the same online-softmax arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.blocking import flash_bwd_fused_legal as j_bwd_legal
from repro.core.blocking import plan_flash_bwd as j_plan_flash_bwd
from repro.core.schedule import flash_tile_schedule as j_flash_tile_schedule
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention.kernel import build_fused_flash_kernel

from repro_torch.core import (H100_SXM, TPU_V5E, FlashBwdDescriptor,
                              FlashDescriptor, engine, flash_bwd_fused_legal,
                              flash_tile_schedule, plan_flash_bwd, use)
from repro_torch.kernels.flash_attention import flash_attention, ref_flat
from repro_torch.kernels.flash_attention.kernel import (
    LAUNCHES, FusedFlash, flash_bwd_fused, flash_bwd_fused_plain,
    flash_fwd_fused, flash_fwd_fused_plain)

GRAD_TOL = {"float32": dict(atol=2e-4, rtol=2e-3),
            "bfloat16": dict(atol=1e-1, rtol=1e-1)}

# The four cases of tests/test_grad_parity.py::test_flash_grad_parity.
GRAD_CASES = [
    (1, 2, 128, 128, 32, True, "float32"),
    (1, 1, 96, 80, 24, True, "float32"),    # tails on every dim + sq != sk
    (1, 2, 100, 128, 64, False, "float32"),  # sq tail, non-causal
    (1, 2, 128, 128, 32, True, "bfloat16"),
]


@pytest.fixture(autouse=True)
def _cpu():
    with use(device="cpu", backend="engine"):
        engine.reset_stats()
        yield


def _inputs(b, h, sq, sk, d, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d), (b, sq, h, d))]


def _port_grads(arrs, dtype, causal, **kw):
    q, k, v = (torch.from_numpy(x).to(getattr(torch, dtype))
               .requires_grad_(True) for x in arrs[:3])
    w = torch.from_numpy(arrs[3])
    out = flash_attention(q, k, v, causal=causal, **kw)
    return torch.autograd.grad((out.float() * w).sum(), (q, k, v))


def _jax_grads(arrs, dtype, causal):
    q, k, v = (jnp.asarray(x, dtype) for x in arrs[:3])
    w = jnp.asarray(arrs[3])

    def loss(q, k, v):
        out = j_flash(q, k, v, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * w)

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _close(got, want, dtype):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   **GRAD_TOL[dtype])


@pytest.mark.parametrize("b,h,sq,sk,d,causal,dtype", GRAD_CASES)
def test_grads_match_reference(b, h, sq, sk, d, causal, dtype):
    arrs = _inputs(b, h, sq, sk, d)
    got = _port_grads(arrs, dtype, causal)
    assert all(g.dtype == getattr(torch, dtype) for g in got)
    st = engine.stats()["flash_attention"]
    assert (st["launches"], st["launches_bwd"]) == (1, 1)
    _close(got, _jax_grads(arrs, dtype, causal), dtype)


@pytest.mark.parametrize("sq,sk,bq,bk,causal", [
    (128, 128, 64, 64, True), (100, 100, 64, 32, True),
    (130, 70, 32, 64, False), (96, 80, 32, 16, True),
])
def test_lse_matches_reference_kernel(sq, sk, bq, bk, causal):
    """The forward's LSE rows (and its output) against the reference's
    fused kernel with ``return_lse=True``, on the same tile table."""
    bh, d = 3, 32
    q, k, v = (np.random.default_rng(s).standard_normal((bh, n, d))
               .astype(np.float32) for s, n in ((0, sq), (1, sk), (2, sk)))
    jsched = j_flash_tile_schedule(sq, sk, bq, bk, causal)
    j_out, j_lse = build_fused_flash_kernel(
        schedule=jsched, batch_heads=bh, d=d, dtype=jnp.float32,
        interpret=True, return_lse=True)(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v))
    exe = FusedFlash(flash_tile_schedule(sq, sk, bq, bk, causal), "cpu")
    assert exe.schedule.tiles == jsched.tiles
    out, lse = flash_fwd_fused(exe, *(torch.from_numpy(x) for x in (q, k, v)),
                               return_lse=True)
    assert lse.shape == (bh, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-5,
                               rtol=1e-5)


def test_one_backward_launch_per_call():
    arrs = _inputs(2, 2, 200, 200, 16, seed=3)
    _port_grads(arrs, "float32", True)
    st = engine.stats()["flash_attention"]
    assert st["launches"] == 1 and st["launches_bwd"] == 1
    assert st["plan_misses_bwd"] == 1 and st["planner_calls_bwd"] == 1
    _port_grads(arrs, "float32", True)
    st = engine.stats()["flash_attention"]
    assert st["launches_bwd"] == 2 and st["plan_hits_bwd"] == 1
    assert "flash_attention_bwd" not in engine.stats()


def test_no_grad_forward_has_no_lse_and_no_backward():
    """Without gradients the forward is one ordinary dispatch."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 64, 64, 16)[:3])
    flash_attention(q, k, v)
    st = engine.stats()["flash_attention"]
    assert st["launches"] == 1 and st["launches_bwd"] == 0


@pytest.mark.parametrize("fused_kw", [{"ctx": "off"}, {"fused": False}])
def test_fused_off_falls_back_to_reference_autodiff(fused_kw):
    """fused="off" (configured or pinned per call) differentiates the
    reference in torch and never reaches the backward family; the
    gradients equal the scheduled walk's."""
    arrs = _inputs(1, 2, 64, 64, 32, seed=5)
    want = _port_grads(arrs, "float32", True)
    assert engine.stats()["flash_attention"]["launches_bwd"] == 1
    if "ctx" in fused_kw:
        with use(fused="off"):
            got = _port_grads(arrs, "float32", True)
    else:
        got = _port_grads(arrs, "float32", True, fused=False)
    st = engine.stats()["flash_attention"]
    assert st["launches_bwd"] == 1 and st["launches"] == 2
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("b,h,sq,sk,d,causal", [
    (1, 2, 96, 96, 32, True), (2, 1, 33, 257, 16, True),
    (1, 2, 130, 70, 24, False), (1, 1, 70, 130, 24, True),
])
@pytest.mark.parametrize("blocks", [(None, None), (16, 32), (32, 16)])
def test_plain_backward_matches_reference_autodiff(b, h, sq, sk, d, causal,
                                                   blocks):
    """The scheduled walk's arithmetic (owned rows and columns, clamped
    windows, causal k-blocks no query reaches) against autodiff of the
    reference, with the default and pinned blocks."""
    arrs = _inputs(b, h, sq, sk, d, seed=7)
    got = _port_grads(arrs, "float32", causal, block_q=blocks[0],
                      block_k=blocks[1])
    assert engine.stats()["flash_attention"]["launches_bwd"] == 1
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in arrs[:3])
    flat = [t.transpose(1, 2).reshape(b * h, t.shape[1], d) for t in (q, k, v)]
    out = ref_flat(causal, *flat).reshape(b, h, sq, d).transpose(1, 2)
    want = torch.autograd.grad((out * torch.from_numpy(arrs[3])).sum(),
                               (q, k, v))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-4, rtol=2e-3)


SCHEDULES = [(sq, sk, bq, bk, causal)
             for sq, sk in ((128, 128), (100, 100), (33, 257), (130, 70),
                            (257, 33), (64, 64), (1, 1))
             for bq, bk in ((64, 64), (16, 32), (32, 16))
             for causal in (True, False)]


@pytest.mark.parametrize("sq,sk,bq,bk,causal", SCHEDULES)
def test_k_block_index_covers_each_row_once(sq, sk, bq, bk, causal):
    s = flash_tile_schedule(sq, sk, bq, bk, causal)
    offsets, rows = s.k_block_index()
    assert offsets.dtype == rows.dtype == np.int32
    assert offsets[0] == 0 and offsets[-1] == s.num_tiles
    assert len(offsets) == s.num_k_blocks + 1
    assert sorted(rows.tolist()) == list(range(s.num_tiles))
    for j in range(s.num_k_blocks):
        run = rows[offsets[j]:offsets[j + 1]].tolist()
        assert run == sorted(run)
        assert all(s.tiles[t][3] == j * s.bk for t in run)


BWD_DESCS = [
    (8, 256, 256, 64, True, "float32"), (2, 96, 80, 24, True, "float32"),
    (6, 100, 128, 64, False, "bfloat16"), (128, 128, 128, 128, True,
                                           "bfloat16"),
    (64, 4096, 4096, 128, True, "bfloat16"), (4, 512, 512, 64, True,
                                              "float32"),
]


@pytest.mark.parametrize("bh,sq,sk,d,causal,dtype", BWD_DESCS)
def test_bwd_descriptor_and_tpu_plans_equal_reference(bh, sq, sk, d, causal,
                                                      dtype):
    kw = dict(batch_heads=bh, sq=sq, sk=sk, d=d, causal=causal, dtype=dtype)
    desc = FlashBwdDescriptor.from_forward(FlashDescriptor(**kw))
    jdesc = jcore.FlashBwdDescriptor.from_forward(jcore.FlashDescriptor(**kw))
    assert desc.cache_key() == jdesc.cache_key()
    assert (desc.flops, desc.in_bytes, desc.out_bytes) == \
        (jdesc.flops, jdesc.in_bytes, jdesc.out_bytes)
    assert flash_bwd_fused_legal(desc, TPU_V5E) == j_bwd_legal(jdesc)
    plan, jplan = plan_flash_bwd(desc, TPU_V5E), j_plan_flash_bwd(jdesc)
    assert (plan.block_q, plan.block_k, plan.fused) == \
        (jplan.block_q, jplan.block_k, jplan.fused)
    h100 = plan_flash_bwd(desc)
    assert flash_bwd_fused_legal(desc, H100_SXM) and h100.fused
    assert (h100.block_q, h100.block_k) in H100_SXM.flash_blocks


def test_backward_wrapper_rejects_what_the_kernel_does_not_take():
    exe = FusedFlash(flash_tile_schedule(32, 32, 16, 16, True), "cpu")
    q = torch.zeros(2, 32, 8)
    lse = torch.zeros(2, 32)
    with pytest.raises(ValueError, match="lse"):
        flash_bwd_fused(exe, q, q, q, q, q, lse.double())
    with pytest.raises(ValueError, match="do"):
        flash_bwd_fused(exe, q, q, q, q, q.bfloat16(), lse)
    with pytest.raises(ValueError, match="schedule"):
        flash_bwd_fused(exe, q[:, :16], q, q, q[:, :16], q[:, :16],
                        lse[:, :16])
    with pytest.raises(RuntimeError, match="device"):
        flash_bwd_fused(exe, q.to("meta"), q.to("meta"), q.to("meta"),
                        q.to("meta"), q.to("meta"), lse.to("meta"))


@pytest.mark.gpu
def test_flash_backward_kernel_on_card(cuda_device):
    """The CUDA backward and the LSE forward against their plain versions
    (tolerance 2e-2 in bf16; dQ's atomic adds change order run to run)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    bh, s, d = 8, 100, 128
    q, k, v, do = (torch.randn(bh, s, d, generator=gen, device=cuda_device)
                   .bfloat16() for _ in range(4))
    exe = FusedFlash(flash_tile_schedule(s, s, 64, 64, True), cuda_device)
    n0 = dict(LAUNCHES)
    o, lse = flash_fwd_fused(exe, q, k, v, return_lse=True)
    grads = flash_bwd_fused(exe, q, k, v, o, do, lse)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_fwd_fused"] == n0["flash_fwd_fused"] + 1
    assert LAUNCHES["flash_bwd_fused"] == n0["flash_bwd_fused"] + 1
    o_p, lse_p = flash_fwd_fused_plain(exe.schedule, q, k, v, return_lse=True)
    torch.testing.assert_close(lse, lse_p, atol=1e-3, rtol=1e-3)
    want = flash_bwd_fused_plain(exe.schedule, q, k, v, o, do, lse)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, atol=2e-2, rtol=2e-2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")
