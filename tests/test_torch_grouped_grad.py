"""The port's grouped-GEMM backward against the reference: dX, dW and db
through the port's autograd function against ``jax.grad`` through the
reference's ``grouped_gemm`` (its custom VJP, the scheduled backward
kernel in interpret mode) on tests/test_grad_parity.py's cases, one
backward launch a call (plus the pre-activation recompute where an
activation is peeled off), the ``fused="off"`` fallback, the plain
expert-by-expert oracle against ``jax.vjp`` of the reference's
``_ref_grouped``, and an empty expert's dW and db exactly zero.

Tolerances: tests/test_grad_parity.py's ``assert_grads_close`` (float32
atol 2e-4 / rtol 2e-3; bfloat16 1e-1).  The oracle against ``jax.vjp``:
float32 atol = rtol = 1e-4 (float32 on both sides, summed in another
order).  The kernel against its plain version on the card: atol = rtol =
1e-3 (both fp32, summed in another order over up to 4096 rows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_gemm import grouped_gemm as j_grouped_gemm
from repro.kernels.grouped_gemm.ops import _ref_grouped as j_ref_grouped

from repro_torch.core import GroupedTileSchedule, engine, use
from repro_torch.kernels.grouped_gemm import grouped_gemm, ref_grouped_gemm_bwd
from repro_torch.kernels.grouped_gemm.kernel import (LAUNCHES, grouped_bwd,
                                                     grouped_bwd_plain)

# tests/test_grad_parity.py's grouped cases.
CASES = [
    (64, 32, 48, [20, 0, 30], None, "float32"),   # zero-size expert + tail
    (96, 40, 56, [96, 0, 0], None, "float32"),    # one expert owns all rows
    (80, 48, 64, [10, 30, 25], "bias", "float32"),
    (80, 48, 64, [10, 30, 25], "bias_gelu", "float32"),
    (80, 48, 64, [10, 30, 25], "silu", "float32"),
    (64, 32, 48, [20, 0, 30], None, "bfloat16"),
]


@pytest.fixture(autouse=True)
def _cpu():
    with use(device="cpu", backend="engine"):
        engine.reset_stats()
        yield


def _grads_close(got, want, dtype):
    tol = dict(atol=2e-4, rtol=2e-3) if dtype == "float32" \
        else dict(atol=1e-1, rtol=1e-1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


def _inputs(t, k, n, sizes, epilogue, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((t, k)).astype(np.float32)
    w = (r.standard_normal((len(sizes), k, n)) * 0.3).astype(np.float32)
    bias = (r.standard_normal((len(sizes), n)) * 0.2).astype(np.float32) \
        if epilogue and epilogue.startswith("bias") else None
    wy = r.standard_normal((t, n)).astype(np.float32)
    return x, w, np.asarray(sizes, np.int32), bias, wy


def _port_grads(x, w, sizes, bias, wy, epilogue, dtype):
    dt = getattr(torch, dtype)
    leaves = [torch.from_numpy(x).to(dt).requires_grad_(),
              torch.from_numpy(w).to(dt).requires_grad_()]
    if bias is not None:
        leaves.append(torch.from_numpy(bias).to(dt).requires_grad_())
    out = grouped_gemm(leaves[0], leaves[1], torch.from_numpy(sizes),
                       epilogue=epilogue,
                       bias=leaves[2] if bias is not None else None)
    (out.float() * torch.from_numpy(wy)).sum().backward()
    for leaf in leaves:
        assert leaf.grad.dtype == dt
    return [leaf.grad for leaf in leaves]


def _jax_grads(x, w, sizes, bias, wy, epilogue, dtype):
    dt = jnp.dtype(dtype)
    gs = jnp.asarray(sizes)
    args = [jnp.asarray(x, dt), jnp.asarray(w, dt)]
    if bias is not None:
        args.append(jnp.asarray(bias, dt))

    def loss(*a):
        out = j_grouped_gemm(a[0], a[1], gs, epilogue=epilogue,
                             bias=a[2] if len(a) > 2 else None)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(wy))

    return jax.grad(loss, argnums=tuple(range(len(args))))(*args)


@pytest.mark.parametrize("t,k,n,sizes,epilogue,dtype", CASES)
def test_grads_match_reference(t, k, n, sizes, epilogue, dtype):
    x, w, sizes, bias, wy = _inputs(t, k, n, sizes, epilogue)
    got = _port_grads(x, w, sizes, bias, wy, epilogue, dtype)
    want = _jax_grads(x, w, sizes, bias, wy, epilogue, dtype)
    assert len(got) == len(want)
    _grads_close(got, want, dtype)
    st = engine.stats()["grouped_gemm"]
    # One backward launch; an activation is peeled off by recomputing the
    # pre-activation through the engine (one more forward launch).
    peeled = epilogue not in (None, "bias")
    assert st["launches_bwd"] == 1
    assert st["launches"] == 1 + int(peeled)


def test_fused_off_backward_differentiates_the_reference():
    """Under fused="off" the forward runs the pad/scatter lowering and the
    backward differentiates the plain version: no backward launch."""
    x, w, sizes, bias, wy = _inputs(80, 48, 64, [10, 30, 25], "bias_gelu")
    with use(fused="off"):
        got = _port_grads(x, w, sizes, bias, wy, "bias_gelu", "float32")
    _grads_close(got, _jax_grads(x, w, sizes, bias, wy, "bias_gelu",
                                 "float32"), "float32")
    st = engine.stats()["grouped_gemm"]
    assert st["launches"] == 1 and st["launches_bwd"] == 0


@pytest.mark.parametrize("sizes,epilogue", [([20, 0, 30], None),
                                            ([10, 30, 25], "bias"),
                                            ([0, 0, 17], "bias"),
                                            ([37, 0, 201, 70], None)])
def test_oracle_matches_jax_vjp(sizes, epilogue):
    """ref_grouped_gemm_bwd (the backward kernel's plain version, from the
    pre-activation cotangent) against jax.vjp of the reference's
    differentiable oracle; rows past the sum get zero dX."""
    t = sum(sizes) + 6
    x, w, sizes, bias, _ = _inputs(t, 40, 56, sizes, epilogue)
    dy = np.random.default_rng(3).standard_normal((t, 56)).astype(np.float32)
    gs = jnp.asarray(sizes)
    if bias is None:
        _, vjp = jax.vjp(lambda a, b: j_ref_grouped(None, a, b, gs, None),
                         jnp.asarray(x), jnp.asarray(w))
    else:
        _, vjp = jax.vjp(lambda a, b, c: j_ref_grouped("bias", a, b, gs, c),
                         jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    want = vjp(jnp.asarray(dy))
    dx, dw, db = ref_grouped_gemm_bwd(
        torch.from_numpy(x), torch.from_numpy(dy), torch.from_numpy(w),
        torch.from_numpy(sizes), with_db=bias is not None)
    got = (dx, dw) if bias is None else (dx, dw, db)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=1e-4,
                                   rtol=1e-4)
    assert np.all(dx.numpy()[int(sizes.sum()):] == 0)


def test_empty_expert_gets_exactly_zero_dw_and_db():
    x, w, sizes, bias, wy = _inputs(64, 32, 48, [20, 0, 30, 0], "bias")
    dx, dw, db = _port_grads(x, w, sizes, bias, wy, "bias", "float32")
    for e in (1, 3):
        assert torch.count_nonzero(dw[e]) == 0
        assert torch.count_nonzero(db[e]) == 0
    assert torch.count_nonzero(dx[50:]) == 0


def test_backward_wrapper_on_cpu_is_its_plain_version():
    x, w, sizes, bias, _ = _inputs(80, 48, 64, [10, 0, 25], "bias")
    dy = torch.randn(80, 64, generator=torch.Generator().manual_seed(0))
    xt, wt, st = torch.from_numpy(x), torch.from_numpy(w), \
        torch.from_numpy(sizes)
    table = GroupedTileSchedule(t=80, k=48, n=64, num_experts=3, bm=16,
                                bk=32, bn=64).tables(st)
    n0 = dict(LAUNCHES)
    got = grouped_bwd(table, xt, dy, wt, st, bm=16, with_db=True)
    want = grouped_bwd_plain(table, xt, dy, wt, st, with_db=True)
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)
    assert LAUNCHES == n0
    with pytest.raises(ValueError, match="dy must be"):
        grouped_bwd(table, xt, dy.double(), wt, st, bm=16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,bm", [(torch.float32, 16),
                                      (torch.bfloat16, 128)])
def test_backward_kernel_on_card(cuda_device, dtype, bm):
    x, w, sizes, bias, _ = _inputs(300, 100, 70, [37, 0, 201, 50], "bias")
    xt, wt = (torch.from_numpy(a).to(cuda_device, dtype) for a in (x, w))
    st = torch.from_numpy(sizes).to(cuda_device)
    dy = torch.randn(300, 70, device=cuda_device)
    table = GroupedTileSchedule(t=300, k=100, n=70, num_experts=4, bm=bm,
                                bk=32, bn=64).tables(st)
    n0 = LAUNCHES["grouped_bwd"]
    got = grouped_bwd(table, xt, dy, wt, st, bm=bm, with_db=True)
    torch.cuda.synchronize()
    assert LAUNCHES["grouped_bwd"] == n0 + 1
    want = grouped_bwd_plain(table, xt, dy, wt, st, with_db=True)
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, atol=1e-3, rtol=1e-3)
    assert torch.count_nonzero(got[1][1]) == 0
    assert torch.count_nonzero(got[2][1]) == 0
