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
from repro_torch.kernels.flash_attention.kernel import (
    LAUNCHES, FusedFlash, flash_fwd_fused, flash_fwd_fused_plain)

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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")
