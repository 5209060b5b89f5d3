"""The kernels at the shapes the remaining decoder configurations bring:
phi3-mini-3.8b's head dim 96 on route A of the flash forward and backward
(the DN 128 instantiation over 96-column rows: TMA zero-fills the last
32-column box, and no column past d is stored), and starcoder2-15b's
biased MLP GEMMs (d 6144 <-> d_ff 24,576, ``bias_gelu`` up, ``bias`` down).
On the CPU: the plain versions at d 96 against textbook attention and its
autograd.  On the card (``gpu``), each kernel against its plain version.
The file imports no JAX:

    python3 -m pytest -q -m gpu tests/test_torch_arch_kernels.py

Tolerances: bf16 forwards and GEMMs atol = rtol = 2e-2 (bf16 outputs of
fp32 sums in another order; ``chip_smoke.py``'s TOL); LSE rows 1e-4 (fp32
both sides); the backward 1e-3 (fp32 sums in another order, dQ by atomic
adds; ``BWD_TOL``); the CPU plain versions against the textbook 1e-5
(fp32 both sides).
"""
import math

import pytest
import torch

from repro_torch.core import (FlashBwdDescriptor, FlashDescriptor,
                              GemmDescriptor, plan_flash, plan_flash_bwd,
                              plan_gemm)
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.gemm import kernel as gk

TOL = dict(atol=2e-2, rtol=2e-2)
BWD_TOL = dict(atol=1e-3, rtol=1e-3)


def _qkv(device, bh, sq, sk, d, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device=device)
               .to(dtype) for s in (sq, sk, sk))
    do = torch.randn((bh, sq, d), generator=gen, device=device).to(dtype)
    return q, k, v, do


def _textbook(q, k, v, causal):
    """softmax(q k^T / sqrt(d)) v in fp32, the causal mask aligned at the
    first query and key (the port's convention: key j <= query i)."""
    s = q.float() @ k.float().transpose(1, 2) / math.sqrt(q.shape[-1])
    if causal:
        sq, sk = s.shape[1:]
        keep = torch.arange(sk)[None, :] <= torch.arange(sq)[:, None]
        s = s.masked_fill(~keep, float("-inf"))
    return torch.softmax(s, -1) @ v.float()


def _exe(device, bh, sq, sk, d, causal, dtype):
    desc = FlashDescriptor(batch_heads=bh, sq=sq, sk=sk, d=d, causal=causal,
                           dtype="bfloat16" if dtype == torch.bfloat16
                           else "float32")
    return fk.FusedFlash(plan_flash(desc).tile_schedule(), device), desc


# (bh, sq, sk, causal): phi3-mini's prefill heads (a batch of 32), ragged
# causal and non-causal windows (sk > sq clamps the last blocks).
CASES = [pytest.param(32, 256, 256, True, id="phi3_causal_256"),
         pytest.param(6, 100, 100, True, id="ragged_causal_100"),
         pytest.param(6, 100, 130, False, id="ragged_noncausal_100x130")]


@pytest.mark.parametrize("bh,sq,sk,causal", [
    pytest.param(3, 40, 40, True, id="causal_40"),
    pytest.param(3, 40, 70, False, id="noncausal_40x70")])
def test_plain_forward_at_d96_is_attention(bh, sq, sk, causal):
    q, k, v, _ = _qkv("cpu", bh, sq, sk, 96, torch.float32, 0)
    exe, _ = _exe("cpu", bh, sq, sk, 96, causal, torch.float32)
    got = fk.flash_fwd_fused_plain(exe.schedule, q, k, v)
    torch.testing.assert_close(got, _textbook(q, k, v, causal), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_at_d96_is_attention_autograd(causal):
    bh, sq, sk, d = 3, 40, 56, 96
    q, k, v, do = _qkv("cpu", bh, sq, sk, d, torch.float32, 1)
    desc = FlashDescriptor(batch_heads=bh, sq=sq, sk=sk, d=d, causal=causal,
                           dtype="float32")
    plan = plan_flash_bwd(FlashBwdDescriptor.from_forward(desc))
    exe = fk.FusedFlash(plan.tile_schedule(), "cpu")
    o, lse = fk.flash_fwd_fused(exe, q, k, v, return_lse=True)
    got = fk.flash_bwd_fused_plain(exe.schedule, q, k, v, o, do, lse)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(_textbook(*leaves, causal), leaves, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5, msg=name)


def test_head_dim_96_plans_route_a():
    """bf16 rows of 192 bytes are whole 16-byte units: route A, both ways,
    and phi3-mini's prefill plans a valid causal tile table (every query
    row drained once, no tile past the diagonal)."""
    assert fk.choose_route(torch.bfloat16, 96, (0, 0, 0)) == "A"
    assert fk.choose_route(torch.bfloat16, 96, (0,) * 5) == "A"
    sched = plan_flash(FlashDescriptor(
        batch_heads=128, sq=256, sk=256, d=96, causal=True,
        dtype="bfloat16")).tile_schedule()
    assert sched.validate()
    assert sched.num_tiles < sched.dense_tiles


@pytest.mark.gpu
@pytest.mark.parametrize("bh,sq,sk,causal", CASES)
def test_forward_route_a_at_d96_on_card(cuda_device, bh, sq, sk, causal):
    """Both forwards on route A at d 96 against their plain versions, the
    fused one with its LSE rows; no column past d written (the output is
    (bh, sq, 96): a store past d would land in the next row)."""
    q, k, v, _ = _qkv(cuda_device, bh, sq, sk, 96, torch.bfloat16, 2)
    exe, desc = _exe(cuda_device, bh, sq, sk, 96, causal, torch.bfloat16)
    plan = plan_flash(desc)
    bq, bk = min(plan.block_q, sq), min(plan.block_k, sk)
    r0 = fk.ROUTES["A"]
    got, lse = fk.flash_fwd_fused(exe, q, k, v, return_lse=True)
    dense = fk.flash_fwd_dense(q, k, v, block_q=bq, block_k=bk, causal=causal)
    torch.cuda.synchronize()
    assert fk.ROUTES["A"] == r0 + 2
    want, want_lse = fk.flash_fwd_fused_plain(exe.schedule, q, k, v,
                                              return_lse=True)
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(
        dense.float(), fk.flash_fwd_dense_plain(
            q, k, v, block_q=bq, block_k=bk, causal=causal).float(), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,sq,sk,causal", [
    pytest.param(256, 128, 128, True, id="phi3_train_causal_128"),
    pytest.param(6, 100, 100, True, id="ragged_causal_100"),
    pytest.param(6, 100, 130, False, id="ragged_noncausal_100x130")])
def test_backward_route_a_at_d96_on_card(cuda_device, bh, sq, sk, causal):
    q, k, v, do = _qkv(cuda_device, bh, sq, sk, 96, torch.bfloat16, 3)
    desc = FlashDescriptor(batch_heads=bh, sq=sq, sk=sk, d=96, causal=causal,
                           dtype="bfloat16")
    plan = plan_flash_bwd(FlashBwdDescriptor.from_forward(desc))
    exe = fk.FusedFlash(plan.tile_schedule(), cuda_device)
    o, lse = fk.flash_fwd_fused(exe, q, k, v, return_lse=True)
    before = dict(fk.BWD_ROUTES)
    got = fk.flash_bwd_fused(exe, q, k, v, o, do, lse)
    torch.cuda.synchronize()
    assert {r: fk.BWD_ROUTES[r] - before[r] for r in before
            if fk.BWD_ROUTES[r] != before[r]} == {"A": 1}
    want = fk.flash_bwd_fused_plain(exe.schedule, q, k, v, o, do, lse)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, w, **BWD_TOL, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k,epilogue", [
    pytest.param(256, 24576, 6144, "bias_gelu", id="up_bias_gelu"),
    pytest.param(256, 6144, 24576, "bias", id="down_bias"),
    pytest.param(4, 24576, 6144, "bias_gelu", id="decode_up_bias_gelu")])
def test_starcoder2_mlp_gemms_on_card(cuda_device, m, n, k, epilogue):
    """starcoder2-15b's MLP GEMMs with their bias epilogues, both
    lowerings (one fused launch; one launch a region) against their plain
    versions."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    a = torch.randn((1, m, k), generator=gen, device=cuda_device).bfloat16()
    b = (torch.randn((1, k, n), generator=gen, device=cuda_device)
         * k ** -0.5).bfloat16()
    bias = torch.randn((n,), generator=gen, device=cuda_device).bfloat16()
    desc = GemmDescriptor(m=m, n=n, k=k, in_dtype="bfloat16",
                          out_dtype="bfloat16", epilogue=epilogue)
    plan = plan_gemm(desc)
    exe = gk.FusedGemm(plan.tile_schedule(), cuda_device)
    kw = dict(epilogue=epilogue, bias=bias)
    n0 = gk.LAUNCHES["gemm_fused"]
    got = gk.gemm_fused(exe, a, b, out_dtype=torch.bfloat16, **kw)
    out = torch.empty((1, m, n), dtype=torch.bfloat16, device=cuda_device)
    for region in plan.regions:
        gk.gemm_region(a, b, out, region, **kw)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["gemm_fused"] == n0 + 1
    want = gk.gemm_fused_plain(exe.schedule, a, b, out_dtype=torch.bfloat16,
                               **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    torch.testing.assert_close(out.float(), want.float(), **TOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")
