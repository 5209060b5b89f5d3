"""The GEMM backward in bf16 against the reference's.

``jax.vjp`` of ``repro.core.matmul.matmul`` (its backward is the VJP of
the XLA oracle, ending in ``_dot_bwd`` under both JAX backends) against
``torch.autograd.grad`` of the port's ``matmul`` under both port backends,
from the same numpy inputs rounded to bf16: nn and nt, every epilogue,
with a bias where the epilogue takes one and with and without ``C``.

The gradients must come back in the dtypes the reference gives (dA and dB
in the operands' dtype, d(C) and d(bias) in theirs) and agree within two
bf16 ulps of each gradient's largest entry: both sides accumulate in fp32
and round once to bf16, in another summation order, and the cotangent is
rounded to bf16 before the products on both sides, so an element may land
one rounding step apart (and the fp32 cotangent of the activation
epilogues passes through that rounding too).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.matmul import matmul as j_matmul

from repro_torch.core import matmul, use
from repro_torch.core.descriptor import EPILOGUES

M, K, N = 24, 40, 56


def _bf16_ulps(x: np.ndarray, n: int) -> float:
    """``n`` bf16 ulps at the magnitude of ``x``'s largest entry."""
    top = float(np.abs(x).max())
    return n * 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


def _inputs(layout, epilogue, accumulate, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b_shape = (K, N) if layout == "nn" else (N, K)
    b = (rng.standard_normal(b_shape) / np.sqrt(K)).astype(np.float32)
    c = rng.standard_normal((M, N)).astype(np.float32) if accumulate else None
    bias = rng.standard_normal(N).astype(np.float32) \
        if epilogue and epilogue.startswith("bias") else None
    g = rng.standard_normal((M, N)).astype(np.float32)
    return a, b, c, bias, g


def _jax_grads(inputs, layout, epilogue, backend):
    a, b, c, bias, g = (None if x is None else jnp.asarray(x, jnp.bfloat16)
                        for x in inputs)
    names = [n for n, x in zip("abcs", (a, b, c, bias)) if x is not None]

    def f(*leaves):
        kw = dict(zip(names, leaves))
        return j_matmul(kw["a"], kw["b"], kw.get("c"), layout=layout,
                        epilogue=epilogue, bias=kw.get("s"))

    with jcore.use(backend=backend):
        _, pullback = jax.vjp(f, *(x for x in (a, b, c, bias)
                                   if x is not None))
        grads = pullback(g)
    return dict(zip(names, grads))


def _port_grads(inputs, layout, epilogue, backend):
    a, b, c, bias, g = (None if x is None
                        else torch.from_numpy(x).to(torch.bfloat16)
                        for x in inputs)
    leaves = {n: x.requires_grad_(True)
              for n, x in zip("abcs", (a, b, c, bias)) if x is not None}
    with use(backend=backend, device="cpu"):
        out = matmul(leaves["a"], leaves["b"], leaves.get("c"),
                     layout=layout, epilogue=epilogue, bias=leaves.get("s"))
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out, list(leaves.values()), g)
    return dict(zip(leaves, grads))


CASES = [(layout, epi, True) for layout in ("nn", "nt") for epi in EPILOGUES]
CASES += [(layout, None, False) for layout in ("nn", "nt")]


@pytest.mark.parametrize("layout,epilogue,accumulate", CASES)
def test_bf16_gemm_backward_matches_reference(layout, epilogue, accumulate):
    inputs = _inputs(layout, epilogue, accumulate)
    want = {be: _jax_grads(inputs, layout, epilogue, be)
            for be in ("xla", "pallas")}
    for backend in ("engine", "torch"):
        got = _port_grads(inputs, layout, epilogue, backend)
        for j_backend, ref in want.items():
            assert sorted(got) == sorted(ref)
            for name, gj in ref.items():
                gt = got[name]
                assert str(gt.dtype).split(".")[-1] == str(gj.dtype), \
                    (name, gt.dtype, gj.dtype)
                w = np.asarray(gj.astype(jnp.float32))
                tol = _bf16_ulps(w, 2)
                np.testing.assert_allclose(
                    gt.float().numpy(), w, atol=tol, rtol=0,
                    err_msg=f"d{name} {backend} vs {j_backend}")


def test_backward_recomputes_the_product_only_for_activations(monkeypatch):
    """Without an activation the backward runs no forward product."""
    mm = importlib.import_module("repro_torch.core.matmul")
    calls = []
    real = mm._product32
    monkeypatch.setattr(mm, "_product32",
                        lambda *a: calls.append(1) or real(*a))
    a = torch.randn(8, 16, requires_grad=True)
    b = torch.randn(16, 12, requires_grad=True)
    bias = torch.randn(12, requires_grad=True)
    for epilogue, recomputed in (("bias", 0), ("bias_gelu", 1)):
        calls.clear()
        with use(backend="engine", device="cpu"):
            out = matmul(a, b, epilogue=epilogue, bias=bias)
        out.sum().backward()
        assert len(calls) == recomputed, epilogue
