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

The activation epilogues' backward epilogue (the pre-activation's
cotangent) is held to ``torch.autograd`` of ``apply_epilogue`` in its
plain form, and the fused route's glue in ``core.matmul`` (forced onto
CPU tensors, where the kernel wrapper runs that plain form) to the plain
route; ``tests/test_torch_gemm_act_bwd.py`` holds the kernel on the card.
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
from repro_torch.kernels.epilogue import ACTIVATIONS

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
    real = mm._pre_activation_grad
    monkeypatch.setattr(mm, "_pre_activation_grad",
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


# ---------------------------------------------------------------------------
# The backward epilogue: the pre-activation's cotangent, fused or plain
# ---------------------------------------------------------------------------

ACT_CASES = [(epi, acc, out) for epi in ACTIVATIONS for acc in (False, True)
             for out in ("bfloat16", "float32")]


def _act_operands(epilogue, accumulate, batch=0, layout="nn", seed=1):
    g = torch.Generator().manual_seed(seed)
    lead = (batch,) if batch else ()

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(torch.bfloat16)

    a = rnd(*lead, M, K)
    b = rnd(*lead, *((K, N) if layout == "nn" else (N, K)), scale=K ** -0.5)
    c = rnd(*lead, M, N) if accumulate else None
    bias = rnd(N) if epilogue.startswith("bias") else None
    dy = rnd(*lead, M, N)
    return a, b, c, bias, dy


@pytest.mark.parametrize("epilogue,accumulate,out_dtype", ACT_CASES)
def test_plain_backward_epilogue_matches_autograd(epilogue, accumulate,
                                                  out_dtype):
    """The engine's backward epilogue on CPU tensors (``act_bwd`` on the
    forward's plan, the kernel wrapper's plain form) against
    ``torch.autograd`` of ``apply_epilogue`` on the fp32 pre-activation,
    written out here: fp32 within fp32 rounding (the wrapper's product is
    batched), bf16 within two bf16 ulps (one rounding each, of values that
    differ in the last fp32 bits).  Each call counts one backward launch
    of the family."""
    from repro_torch.core import engine
    from repro_torch.core.descriptor import GemmDescriptor
    from repro_torch.kernels.epilogue import apply_epilogue
    from repro_torch.kernels.gemm.ops import act_bwd
    a, b, c, bias, dy = _act_operands(epilogue, accumulate)
    pre = a.float() @ b.float()
    if c is not None:
        pre = pre + c.float()
    pre.requires_grad_(True)
    want, = torch.autograd.grad(apply_epilogue(pre, epilogue, bias), pre,
                                dy.float())
    desc = GemmDescriptor.from_operands(a, b, accumulate=accumulate,
                                        epilogue=epilogue,
                                        out_dtype=torch.bfloat16)
    odt = getattr(torch, out_dtype)
    with use(device="cpu"):
        before = engine.stats().get("gemm", {}).get("launches_bwd", 0)
        got = act_bwd(desc, engine.resolve(desc, a, b), a, b, dy, bias=bias,
                      c=c, out_dtype=odt)
        assert engine.stats()["gemm"]["launches_bwd"] == before + 1
    assert got.dtype == odt and got.shape == (M, N)
    w = want.numpy()
    if odt == torch.float32:
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    else:
        np.testing.assert_allclose(got.float().numpy(), w,
                                   atol=_bf16_ulps(w, 2), rtol=0)


FUSED_CASES = [("nn", "silu", False, 0), ("nt", "gelu", True, 0),
               ("nn", "bias_gelu", True, 0), ("nt", "bias_silu", False, 0),
               ("nn", "relu", True, 2), ("nt", "bias_silu", True, 3)]


@pytest.mark.parametrize("layout,epilogue,accumulate,batch", FUSED_CASES)
def test_fused_route_glue_matches_plain_route(monkeypatch, layout, epilogue,
                                              accumulate, batch):
    """``matmul``'s backward on route "fused" (forced onto CPU tensors,
    where the kernel wrapper runs its plain form) against route "plain":
    the same gradients, in the same dtypes, within two bf16 ulps, with or
    without C, a bias and a batch; the fused route writes the
    pre-activation's cotangent once, in bf16 unless a bias or an fp32 C
    needs it in fp32."""
    mm = importlib.import_module("repro_torch.core.matmul")
    a, b, c, bias, dy = _act_operands(epilogue, accumulate, batch, layout)
    grads, seen = {}, []
    real = mm._pre_activation_grad

    def spy(*args):
        out = real(*args)
        seen.append(out.dtype)
        return out

    monkeypatch.setattr(mm, "_pre_activation_grad", spy)
    for route in ("plain", "fused"):
        monkeypatch.setattr(mm, "_fused_recompute",
                            lambda a, fused=route == "fused": fused)
        leaves = {n: x.clone().requires_grad_(True)
                  for n, x in zip("abcs", (a, b, c, bias)) if x is not None}
        with use(backend="engine", device="cpu"):
            out = matmul(leaves["a"], leaves["b"], leaves.get("c"),
                         layout=layout, epilogue=epilogue,
                         bias=leaves.get("s"))
        grads[route] = dict(zip(leaves, torch.autograd.grad(
            out, list(leaves.values()), dy)))
    assert seen[0] == torch.float32
    assert seen[1] == (torch.float32 if bias is not None else torch.bfloat16)
    for name, want in grads["plain"].items():
        got = grads["fused"][name]
        assert got.dtype == want.dtype, name
        w = want.float().numpy()
        np.testing.assert_allclose(got.float().numpy(), w,
                                   atol=_bf16_ulps(w, 2), rtol=0,
                                   err_msg=f"d{name}")


def test_recompute_span_names_its_route():
    """The ``matmul.recompute`` span carries the route it took: "plain" for
    CPU tensors."""
    a = torch.randn(8, 16).bfloat16().requires_grad_(True)
    b = torch.randn(16, 12).bfloat16().requires_grad_(True)
    with use(backend="engine", device="cpu"):
        out = matmul(a, b, epilogue="gelu")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        out.float().sum().backward()
    names = [e.name for e in prof.events()
             if e.name.startswith("repro_torch.matmul.recompute")]
    assert names == ["repro_torch.matmul.recompute|route=plain"]
