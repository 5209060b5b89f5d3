"""The flash backward's routes (``kernels/flash_attention/csrc/flash_bwd.cu``):
the route choice over the backward's five operands, the route counts, the
premise of route A's split operands, and -- on the card -- each route
against the plain version.  The file imports no JAX, so its ``gpu`` tests
run on a machine with the card and without JAX:

    python3 -m pytest -q -m gpu tests/test_torch_flash_bwd_routes.py

Tolerances: the kernel and ``flash_bwd_fused_plain`` both compute in fp32
from the same bf16 or fp32 operands, in other summation orders (and dQ by
atomic adds whose order changes from run to run); route A also carries P
and dS as bf16 hi + lo pairs (about 2^-16 relative).  They must agree to
atol = rtol = 1e-3, the bound ``chip_smoke.py`` holds them to (BWD_TOL).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (FlashBwdDescriptor, FlashDescriptor,
                              flash_tile_schedule, plan_flash_bwd)
from repro_torch.kernels.flash_attention import kernel as fk

BWD_TOL = dict(atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("d,ptrs,route", [
    (128, (0,) * 5, "A"),                   # the main path (Qwen3, phi3.5-moe)
    (96, (0, 16, 32, 48, 1 << 20), "A"),
    (64, (0,) * 5, "A"),
    (36, (0,) * 5, "C"),                    # 72-byte rows
    (128, (0, 0, 0, 2, 0), "C"),            # o 2 bytes past a boundary
    (128, (0, 0, 0, 0, 1 << 4 | 8), "C"),   # dO 8 bytes past one
    (128, (0, 8, 0, 0, 0), "C")])           # k
def test_choose_route_for_the_backward(d, ptrs, route):
    """The backward reads q, k, v, o and dO by TMA on route A: every one
    of the five bases counts."""
    assert fk.choose_route(torch.bfloat16, d, ptrs) == route
    assert fk.choose_route(torch.float32, d, ptrs) == "fp32"


def test_backward_route_reads_o_and_do():
    """The wrapper's route takes all five operands: the engine's own
    contiguous bf16 tensors give "A", a dO two bytes off its allocation's
    16-byte boundary gives "C"."""
    q, k, v, o, do = (torch.zeros((4, 128, 128), dtype=torch.bfloat16)
                      for _ in range(5))
    assert fk._route(q, k, v, o, do) == "A"
    shifted = torch.zeros(4 * 128 * 128 + 1, dtype=torch.bfloat16)[1:]
    assert fk._route(q, k, v, o, shifted.view(4, 128, 128)) == "C"
    assert fk._route(*(t.float() for t in (q, k, v, o, do))) == "fp32"


def test_cpu_backward_counts_no_route():
    """The CPU path runs the plain version: no launch, so no route; a
    reset clears the backward's route counts with the launches."""
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((2, 70, 64), generator=gen).bfloat16()
                   for _ in range(4))
    exe = fk.FusedFlash(flash_tile_schedule(70, 70, 64, 64, True), "cpu")
    o, lse = fk.flash_fwd_fused(exe, q, k, v, return_lse=True)
    launches, routes = dict(fk.LAUNCHES), dict(fk.BWD_ROUTES)
    fk.flash_bwd_fused(exe, q, k, v, o, do, lse)
    assert fk.LAUNCHES == launches and fk.BWD_ROUTES == routes
    fk.BWD_ROUTES["A"] += 1
    fk.reset_launches()
    assert set(fk.BWD_ROUTES.values()) == {0}


def _split(x):
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def test_split_operands_keep_the_products_at_fp32():
    """Route A's premise, emulated in plain torch at the Qwen3 training
    shape (BH 8, s = d = 128, causal): with P and dS split into bf16 hi and
    lo and each product run on both (bf16 operands, fp32 sums, as wgmma
    does), P^T dO, dS^T Q and dS K stay within 1e-4 of their fp32 values;
    one bf16 pass of P or dS breaks the kernel's 1e-3."""
    rng = np.random.default_rng(0)
    bh, s, d = 8, 128, 128
    q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, s, d))
                                    .astype(np.float32)).bfloat16().float()
                   for _ in range(4))
    scale = d ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    sc = torch.where(causal, q @ k.transpose(1, 2) * scale, -torch.inf)
    lse = torch.logsumexp(sc, -1, keepdim=True)
    p = torch.where(causal, torch.exp(sc - lse), 0.0)
    o = (p @ v).bfloat16().float()
    drow = (do * o).sum(-1, keepdim=True)
    ds = torch.where(causal, p * (do @ v.transpose(1, 2) - drow) * scale, 0.0)
    products = {"dv": (p.transpose(1, 2), do), "dk": (ds.transpose(1, 2), q),
                "dq": (ds, k)}
    for name, (a, b) in products.items():
        want = a @ b
        hi, lo = _split(a)
        torch.testing.assert_close(hi @ b + lo @ b, want, atol=1e-4,
                                   rtol=1e-4, msg=name)
        one = hi @ b
        bad = (one - want).abs() > 1e-3 + 1e-3 * want.abs()
        assert bad.any(), f"{name}: one bf16 pass stayed within 1e-3"


def _case(device, bh, sq, sk, d, causal, dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device=device)
               .to(dtype) for s in (sq, sk, sk))
    do = torch.randn((bh, sq, d), generator=gen, device=device).to(dtype)
    desc = FlashDescriptor(batch_heads=bh, sq=sq, sk=sk, d=d, causal=causal,
                           dtype="bfloat16" if dtype == torch.bfloat16
                           else "float32")
    plan = plan_flash_bwd(FlashBwdDescriptor.from_forward(desc))
    exe = fk.FusedFlash(plan.tile_schedule(), device)
    o, lse = fk.flash_fwd_fused(exe, q, k, v, return_lse=True)
    return exe, (q, k, v, o, do, lse)


# (bh, sq, sk, d, causal, dtype, route): route A on the Qwen3 training
# shape (16 heads of one sequence), ragged non-causal windows (sk > sq, the
# last k-block and q-block clamped) at d 96 and 64, a clamped causal case
# and k-blocks no query reaches (causal, sk > sq: stored zeros), the
# encoder-decoder's cross-attention in training (128 decoder rows over 512
# encoder rows, non-causal, d 64); route C on fp32 and on bf16 rows TMA
# cannot read (d 36).
CARD_CASES = [
    pytest.param(16, 128, 128, 128, True, torch.bfloat16, "A",
                 id="train_bh16"),
    pytest.param(6, 100, 130, 96, False, torch.bfloat16, "A",
                 id="ragged_noncausal_100x130_d96"),
    pytest.param(6, 100, 130, 64, False, torch.bfloat16, "A",
                 id="ragged_noncausal_100x130_d64"),
    pytest.param(8, 100, 100, 128, True, torch.bfloat16, "A",
                 id="clamped_causal_100"),
    pytest.param(4, 33, 257, 64, True, torch.bfloat16, "A",
                 id="unreached_k_blocks_33x257"),
    pytest.param(16, 128, 512, 64, False, torch.bfloat16, "A",
                 id="cross_train_128x512_d64"),
    pytest.param(6, 100, 130, 64, True, torch.float32, "fp32",
                 id="f32_causal_100x130"),
    pytest.param(8, 100, 100, 36, True, torch.bfloat16, "C",
                 id="route_c_causal_d36"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("bh,sq,sk,d,causal,dtype,route", CARD_CASES)
def test_backward_routes_on_card(cuda_device, bh, sq, sk, d, causal, dtype,
                                 route):
    """One launch on the expected route, dQ, dK and dV within 1e-3 of the
    plain version."""
    exe, ops = _case(cuda_device, bh, sq, sk, d, causal, dtype)
    before = dict(fk.BWD_ROUTES)
    got = fk.flash_bwd_fused(exe, *ops)
    torch.cuda.synchronize()
    assert {r: fk.BWD_ROUTES[r] - before[r] for r in before
            if fk.BWD_ROUTES[r] != before[r]} == {route: 1}
    want = fk.flash_bwd_fused_plain(exe.schedule, *ops)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, w, **BWD_TOL, msg=name)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")
