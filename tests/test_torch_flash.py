"""The port's flash-attention forward (plain versions on the CPU) against
the reference's ``flash_attention`` in interpret mode and its
``ref_attention`` oracle, on both lowerings.  (The backward is in
tests/test_torch_flash_bwd.py.)

Tolerances 2e-3 for float32 and 3e-2 for bfloat16, as in the reference's
own flash parity test.  Causal sq != sk is held to the start-aligned
``ref_flat`` (the reference skips its end-aligned oracle there).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import ref_attention as j_ref_attention

from repro_torch.core import FlashDescriptor, engine, plan_flash, use
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 ref_attention, ref_flat)
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.kernel import (
    LAUNCHES, FusedFlash, flash_fwd_dense, flash_fwd_dense_plain,
    flash_fwd_fused, flash_fwd_fused_plain)

TOL = {"float32": 2e-3, "bfloat16": 3e-2}

# (b, h, sq, sk, d): the reference's flash parity shapes
# (tests/test_kernels_other.py), ragged in sq, sk and d.
CASES = [
    (2, 4, 256, 256, 64),
    (1, 2, 96, 96, 64),
    (2, 3, 100, 100, 48),
    (1, 1, 130, 70, 32),
    (3, 2, 33, 257, 16),
]


@pytest.fixture(autouse=True)
def _cpu():
    with use(device="cpu", backend="engine"):
        engine.reset_stats()
        yield


def _qkv(b, h, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for s in (sq, sk, sk)]


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _flat(x):
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,sq,sk,d", CASES)
def test_both_lowerings_match_oracle(b, h, sq, sk, d, causal, dtype):
    arrs = _qkv(b, h, sq, sk, d)
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in arrs)
    if causal and sq != sk:
        want = ref_flat(True, _flat(tq), _flat(tk), _flat(tv))
        want = want.reshape(b, h, sq, d).transpose(1, 2).float().numpy()
    else:
        jq, jk, jv = (jnp.asarray(x, dtype) for x in arrs)
        want = np.asarray(j_ref_attention(jq, jk, jv, causal=causal),
                          np.float32)
        np.testing.assert_allclose(
            ref_attention(tq, tk, tv, causal=causal).float().numpy(), want,
            atol=TOL[dtype], rtol=TOL[dtype])
    for fused in (True, False):
        got = flash_attention(tq, tk, tv, causal=causal, fused=fused)
        assert got.shape == (b, sq, h, d) and got.dtype == tq.dtype
        _close(got, want, dtype)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("b,h,sq,sk,d,causal,dtype", [
    (2, 3, 100, 100, 48, True, "float32"),
    (1, 1, 130, 70, 32, False, "bfloat16"),
])
def test_matches_reference_pallas_flash(b, h, sq, sk, d, causal, dtype,
                                        fused):
    """Against the reference's Pallas kernels in interpret mode (their
    plans, the port's H100 plans: different tiles, the same function)."""
    arrs = _qkv(b, h, sq, sk, d, seed=1)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in arrs)
    with jcore.use(backend="pallas"):
        want = np.asarray(j_flash(jq, jk, jv, causal=causal, fused=fused),
                          np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in arrs)
    _close(flash_attention(tq, tk, tv, causal=causal, fused=fused), want,
           dtype)


def test_pinned_blocks_and_tpu_plan():
    """Explicit block sizes (tiles with rows masked entirely, past the
    causal diagonal) and the TPU_V5E plan (large tiles) give the same
    function as the default H100 plan, with finite values throughout."""
    tq, tk, tv = (torch.from_numpy(x) for x in _qkv(2, 2, 96, 96, 32))
    base = flash_attention(tq, tk, tv, causal=True)
    for bq, bk in ((32, 16), (64, 16), (16, 64)):
        for fused in (True, False):
            got = flash_attention(tq, tk, tv, causal=True, block_q=bq,
                                  block_k=bk, fused=fused)
            assert torch.isfinite(got).all()
            _close(got, base.numpy(), "float32")
    with use(machine="tpu_v5e"):
        _close(flash_attention(tq, tk, tv, causal=True), base.numpy(),
               "float32")


def test_one_launch_per_call_on_either_lowering():
    tq, tk, tv = (torch.from_numpy(x) for x in _qkv(1, 2, 200, 200, 16))
    for fused in (True, False):
        engine.reset_stats()
        flash_attention(tq, tk, tv, fused=fused)
        assert engine.stats()["flash_attention"]["launches"] == 1


# ---------------------------------------------------------------------------
# the forward kernels' routes (kernel.py chooses; flash_fwd.cu runs them)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,ptrs,route", [
    (128, (0, 0, 0), "A"),            # the main path (Qwen3, phi3.5-moe)
    (64, (16, 1 << 20, 48), "A"),
    (48, (0, 0, 0), "A"),             # 96-byte rows: TMA zero-fills to 64 columns
    (8, (0, 0, 0), "A"),
    (36, (0, 0, 0), "C"),             # 72-byte rows
    (100, (0, 0, 0), "C"),            # 200-byte rows
    (128, (2, 0, 0), "C"),            # q 2 bytes past a 16-byte boundary
    (128, (0, 8, 0), "C"),            # k 8 bytes past one
    (128, (0, 0, 1 << 4 | 2), "C")])  # v
def test_choose_route(d, ptrs, route):
    assert flash_kernel.choose_route(torch.bfloat16, d, ptrs) == route
    assert flash_kernel.choose_route(torch.float32, d, ptrs) == "fp32"


def test_main_path_operands_take_route_a():
    """The engine hands the kernels contiguous (BH, s, 128) bf16 tensors of
    their own (``execute``'s ``contiguous()``), whose bases the allocator
    aligns: route A."""
    q, k, v = (torch.zeros((4, 256, 128), dtype=torch.bfloat16)
               for _ in range(3))
    assert flash_kernel._route(q, k, v) == "A"
    assert flash_kernel._route(q.float(), k.float(), v.float()) == "fp32"


def test_cpu_wrappers_count_no_route():
    """The CPU path runs the plain versions: no launch, so no route; a
    reset clears the route counts with the launches."""
    tq, tk, tv = (torch.from_numpy(x).bfloat16()
                  for x in _qkv(1, 2, 70, 70, 64))
    flat = [_flat(t) for t in (tq, tk, tv)]
    desc = FlashDescriptor(batch_heads=2, sq=70, sk=70, d=64, causal=True,
                           dtype="bfloat16")
    exe = FusedFlash(plan_flash(desc).tile_schedule(), "cpu")
    before = dict(flash_kernel.ROUTES)
    flash_fwd_fused(exe, *flat)
    flash_fwd_dense(*flat, block_q=64, block_k=64, causal=True)
    assert flash_kernel.ROUTES == before
    flash_kernel.ROUTES["A"] += 1
    flash_kernel.reset_launches()
    assert set(flash_kernel.ROUTES.values()) == {0}


@pytest.mark.gpu
def test_flash_kernels_on_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(8, 100, 128, generator=gen, device=cuda_device)
               .bfloat16() for _ in range(3))
    desc = FlashDescriptor(batch_heads=8, sq=100, sk=100, d=128,
                           causal=True, dtype="bfloat16")
    exe = FusedFlash(plan_flash(desc).tile_schedule(), cuda_device)
    n0 = LAUNCHES["flash_fwd_fused"]
    got = flash_fwd_fused(exe, q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_fwd_fused"] == n0 + 1
    want = flash_fwd_fused_plain(exe.schedule, q, k, v)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


# (bh, sq, sk, d, causal, per-head scales or None): route A on a ragged
# causal case, a non-causal one with sk < sq and d 64, neighbouring heads
# of very different magnitude (windows run past each head's end), and the
# encoder-decoder's cross-attention at d 64: a decode step's one query row
# (a block of one row) and a prefill's 256 rows, over 1,000 encoder rows.
ROUTE_A_CASES = [
    pytest.param(8, 100, 100, 128, True, None, id="ragged_causal_100"),
    pytest.param(6, 130, 70, 64, False, None, id="noncausal_130x70_d64"),
    pytest.param(4, 100, 100, 128, True, (1.0, 1e3, 1e-3, 30.0),
                 id="heads_magnitude"),
    pytest.param(16, 1, 1000, 64, False, None, id="cross_decode_1x1000_d64"),
    pytest.param(16, 256, 1000, 64, False, None,
                 id="cross_prefill_256x1000_d64"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("bh,sq,sk,d,causal,head_scales", ROUTE_A_CASES)
def test_route_a_on_card(cuda_device, bh, sq, sk, d, causal, head_scales):
    """Both forwards on route A against their plain versions, one launch
    and one route-A count each; the fused one also with the LSE rows."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(bh, s, d, generator=gen, device=cuda_device)
               for s in (sq, sk, sk))
    if head_scales is not None:
        scale = torch.tensor(head_scales, device=cuda_device)[:, None, None]
        k, v = k * scale.sqrt(), v * scale
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    desc = FlashDescriptor(batch_heads=bh, sq=sq, sk=sk, d=d, causal=causal,
                           dtype="bfloat16")
    plan = plan_flash(desc)
    exe = FusedFlash(plan.tile_schedule(), cuda_device)
    bq, bk = min(plan.block_q, sq), min(plan.block_k, sk)
    r0 = flash_kernel.ROUTES["A"]
    got, lse = flash_fwd_fused(exe, q, k, v, return_lse=True)
    dense = flash_fwd_dense(q, k, v, block_q=bq, block_k=bk, causal=causal)
    torch.cuda.synchronize()
    assert flash_kernel.ROUTES["A"] == r0 + 2
    want, want_lse = flash_fwd_fused_plain(exe.schedule, q, k, v,
                                           return_lse=True)
    tol = dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(
        dense.float(),
        flash_fwd_dense_plain(q, k, v, block_q=bq, block_k=bk,
                              causal=causal).float(), **tol)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")
