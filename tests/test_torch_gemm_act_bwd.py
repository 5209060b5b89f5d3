"""The backward epilogue of an activation GEMM on the card.

``gemm_act_bwd`` recomputes the pre-activation on the bf16 wgmma GEMM and
writes ``dy * act'(C? + A @ op(B) + bias?)``; its oracle is the fp32 form
of ``core.matmul``'s backward (``gemm_act_bwd_plain``: the fp32 product of
the upcast operands, then autograd of the epilogue).  Both accumulate
exact bf16 products in fp32, in other orders.  A bf16 output agrees within
two bf16 ulps of its largest entry, as ``tests/test_torch_matmul_bwd.py``
holds the backward to the reference; an fp32 output, rounded nowhere on
either side, within ``FP32_TOL`` of each entry plus ``FP32_TOL`` of the
largest, which a kernel that rounded the pre-activation or the result to
bf16 on the way fails.  Relu's derivative steps at 0: an element whose
pre-activation lies within the two sums' rounding of 0 may take the other
side, so its cases compare the elements away from the step.  This file
imports no JAX, so ``python -m pytest -m gpu
tests/test_torch_gemm_act_bwd.py`` runs on the card's machine.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import GemmDescriptor, engine, matmul, plan_gemm, use
from repro_torch.core.matmul import _product32
from repro_torch.kernels.gemm import kernel as gk

# fp32 outputs: the two summation orders of K exact products differ by a
# few fp32 ulps of the partial sums; one bf16 rounding is 2**-9 relative.
FP32_TOL = 1e-4

# (label, m, n, k, layout, epilogue, C, batch, out dtype, route)
CASES = [
    ("phi3_gate_slice", 4096, 8192, 3072, "nn", "silu", False, 0,
     "bfloat16", "A"),
    ("m1000_gelu_acc", 1000, 1536, 768, "nn", "gelu", True, 0, "bfloat16",
     "A"),
    ("nt_bias_silu_f32", 777, 640, 512, "nt", "bias_silu", False, 0,
     "float32", "A"),
    ("nt_relu_acc", 256, 384, 320, "nt", "relu", True, 0, "bfloat16", "A"),
    ("route_c_k1001", 97, 103, 1001, "nt", "bias_gelu", True, 0, "float32",
     "C"),
    ("decode_split", 8, 1024, 1024, "nn", "silu", False, 0, "bfloat16", "B"),
    ("batched3_nt", 100, 200, 96, "nt", "gelu", True, 3, "bfloat16", "A"),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _bf16_ulps(x: torch.Tensor, n: int) -> float:
    top = float(x.abs().max())
    return n * 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_gemm_act_bwd_matches_the_fp32_oracle(case, cuda_device):
    label, m, n, k, layout, epi, acc, nb, oname, route = case
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    nbx = max(nb, 1)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cuda_device)
                * scale).bfloat16()

    a = rnd(nbx, m, k)
    b = rnd(nbx, *((k, n) if layout == "nn" else (n, k)), scale=k ** -0.5)
    c = rnd(nbx, m, n) if acc else None
    bias = rnd(n) if epi.startswith("bias") else None
    dy = rnd(nbx, m, n)
    odt = getattr(torch, oname)
    plan = plan_gemm(GemmDescriptor(m=m, n=n, k=k, layout=layout,
                                    in_dtype="bfloat16", out_dtype="bfloat16",
                                    epilogue=epi, accumulate=acc, batch=nb))
    exe = gk.FusedGemm(plan.tile_schedule(), cuda_device)
    before, n0 = dict(gk.ROUTES), gk.LAUNCHES["gemm_act_bwd"]
    got = gk.gemm_act_bwd(exe, a, b, dy, layout=layout, epilogue=epi,
                          bias=bias, c=c, out_dtype=odt)
    torch.cuda.synchronize()
    assert [r for r in gk.ROUTES if gk.ROUTES[r] != before[r]] == [route]
    assert gk.LAUNCHES["gemm_act_bwd"] == n0 + 1
    want = gk.gemm_act_bwd_plain(a, b, dy, layout=layout, epilogue=epi,
                                 bias=bias, c=c)
    assert got.dtype == odt and torch.isfinite(got.float()).all()
    keep = torch.ones_like(want, dtype=torch.bool)
    if epi == "relu":
        pre = _product32(a, b, layout) + c.float()
        keep = pre.abs() > 1e-3
        assert keep.float().mean() > 0.99
    err = (got.float() - want).abs()[keep]
    if odt == torch.float32:
        limit = FP32_TOL * (want.abs()[keep] + want.abs().max())
        assert (err <= limit).all(), (label, (err - limit).max().item())
    else:
        assert err.max().item() <= _bf16_ulps(want, 2), \
            (label, err.max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("epilogue,bias", [("silu", False),
                                           ("bias_gelu", True)])
def test_matmul_backward_takes_the_fused_route(epilogue, bias, cuda_device,
                                               monkeypatch):
    """``matmul``'s backward with bf16 operands on the card: one fused
    launch a recompute (``launches_bwd`` of the gemm family), and the
    gradients of the plain route within two bf16 ulps."""
    mm = importlib.import_module("repro_torch.core.matmul")
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    m, k, n = 512, 384, 1024
    a = torch.randn((2, m // 2, k), generator=gen, device=cuda_device)
    w = torch.randn((k, n), generator=gen, device=cuda_device) * k ** -0.5
    s = torch.randn((n,), generator=gen, device=cuda_device)
    dy = torch.randn((2, m // 2, n), generator=gen, device=cuda_device)
    grads = {}
    for route in ("fused", "plain"):
        if route == "plain":
            monkeypatch.setattr(mm, "_fused_recompute", lambda t: False)
        leaves = [t.bfloat16().requires_grad_(True)
                  for t in ((a, w, s) if bias else (a, w))]
        with use(backend="engine", device="cuda"):
            engine.reset_stats(entries=False)
            out = matmul(leaves[0], leaves[1], epilogue=epilogue,
                         bias=leaves[2] if bias else None)
            grads[route] = torch.autograd.grad(out, leaves, dy.bfloat16())
            torch.cuda.synchronize()
            assert engine.stats()["gemm"]["launches_bwd"] == \
                (1 if route == "fused" else 0)
    for got, want in zip(grads["fused"], grads["plain"]):
        assert got.dtype == want.dtype
        assert (got.float() - want.float()).abs().max().item() <= \
            _bf16_ulps(want.float(), 2)
