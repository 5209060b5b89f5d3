"""The port's SSD chunked-scan backward against the reference: gradients
of all seven inputs through the port's autograd function against
``jax.grad`` of the reference's ``ssd_chunk_scan`` (its custom VJP, the
reverse-walk kernel in interpret mode), across the carried-state seam,
with one backward launch a scan, under ``fused="off"`` (the backward
then differentiates the plain oracle), and the plain reverse-walk
oracle against ``jax.vjp`` of the reference's ``ref_ssd_chunk_scan``.

Tolerances: tests/test_grad_parity.py's ``assert_grads_close`` (float32
atol 2e-4 / rtol 2e-3; bfloat16 1e-1: both sides round the operands and
the cotangents to bfloat16 at the same points, and sum in another
order).  The oracle against ``jax.vjp``: float32 atol = rtol = 1e-4.  The
kernel against its plain version on the card: atol = rtol = 1e-3 (both
fp32, summed in another order over up to 256 rows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.kernels.ssd_chunk import ref_ssd_chunk_scan as j_ref_scan
from repro.kernels.ssd_chunk import ssd_chunk_scan as j_scan

from repro_torch.core import engine, use
from repro_torch.kernels.ssd_chunk import (ref_ssd_chunk_scan,
                                           ref_ssd_chunk_scan_bwd,
                                           ssd_chunk_scan)
from repro_torch.kernels.ssd_chunk.kernel import (LAUNCHES, ssd_scan_bwd,
                                                  ssd_scan_bwd_plain,
                                                  ssd_scan_fused)

ARGNUMS = tuple(range(7))


@pytest.fixture(autouse=True)
def _cpu():
    with use(device="cpu", backend="engine"):
        engine.reset_stats()
        yield


def _grad_case(g, nc, q, n, p, seed=11):
    """tests/test_grad_parity.py's ``_ssd_grad_case`` in numpy (float32;
    the tests cast C, B, L and xdt)."""
    r = np.random.default_rng(seed)
    rand = lambda s, scale: (r.standard_normal(s) * scale).astype(np.float32)
    c = rand((g, nc, q, n), 0.5)
    b = rand((g, nc, q, n), 0.5)
    l = np.tril(np.exp(-np.abs(r.standard_normal((g, nc, q, q))))) \
        .astype(np.float32)
    x = rand((g, nc, q, p), 0.5)
    di = np.exp(-np.abs(r.standard_normal((g, nc, q)))).astype(np.float32)
    do = np.exp(-np.abs(r.standard_normal((g, nc, q)))).astype(np.float32)
    s0 = rand((g, p, n), 0.3)
    wy, ws = rand((g, nc, q, p), 1.0), rand((g, p, n), 1.0)
    return (c, b, l, x, di, do, s0), wy, ws


def _jax_grads(fn, ops, wy, ws, jdt):
    def loss(*a):
        y, sf = fn(*a)
        return jnp.sum(y.astype(jnp.float32) * wy) + jnp.sum(sf * ws)
    arrs = [jnp.asarray(o, jdt if i < 4 else jnp.float32)
            for i, o in enumerate(ops)]
    return jax.grad(loss, argnums=ARGNUMS)(*arrs)


def _port_grads(ops, wy, ws, tdt):
    ts = [torch.from_numpy(o).to(tdt if i < 4 else torch.float32)
          .requires_grad_() for i, o in enumerate(ops)]
    y, sf = ssd_chunk_scan(*ts)
    loss = (y.float() * torch.from_numpy(wy)).sum() \
        + (sf * torch.from_numpy(ws)).sum()
    loss.backward()
    return [t.grad for t in ts]


def _assert_grads_close(got, want, bf16):
    tol = dict(atol=1e-1, rtol=1e-1) if bf16 else dict(atol=2e-4, rtol=2e-3)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   err_msg=f"input {i}", **tol)


# tests/test_grad_parity.py's SSD cases
GRAD_CASES = [((2, 4, 16, 8, 12), False),
              ((1, 1, 8, 8, 8), False),   # single chunk: s0 only
              ((2, 3, 16, 8, 8), True)]


@pytest.mark.parametrize("shape,bf16", GRAD_CASES)
@pytest.mark.parametrize("fused", ["auto", "off"])
def test_grads_match_reference(shape, bf16, fused):
    ops, wy, ws = _grad_case(*shape)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    with jcore.use(backend="pallas"):
        want = _jax_grads(j_scan, ops, wy, ws, jdt)
    with use(fused=fused):
        got = _port_grads(ops, wy, ws, tdt)
    assert [g.dtype for g in got] == [tdt] * 4 + [torch.float32] * 3
    _assert_grads_close(got, want, bf16)
    st = engine.stats()["ssd_chunk"]
    assert st["launches"] == 1
    # fused="off": the backward differentiates the plain oracle in torch
    assert st["launches_bwd"] == (1 if fused == "auto" else 0)


def test_grads_across_the_carried_state_seam():
    """Differentiating a scan split in two (state handed across the cut,
    its cotangent handed back through ds0 / dsf) equals differentiating
    the unsplit scan."""
    ops, wy, _ = _grad_case(2, 4, 16, 8, 12)
    cut = 2
    wy_t = torch.from_numpy(wy)

    def grads(split):
        ts = [torch.from_numpy(o).requires_grad_() for o in ops]
        if split:
            head = [t[:, :cut] for t in ts[:6]]
            tail = [t[:, cut:] for t in ts[:6]]
            y1, s_mid = ssd_chunk_scan(*head, ts[6])
            y2, _ = ssd_chunk_scan(*tail, s_mid)
            y = torch.cat([y1, y2], dim=1)
        else:
            y, _ = ssd_chunk_scan(*ts)
        (y * wy_t).sum().backward()
        return [t.grad for t in ts]

    for g, w in zip(grads(True), grads(False)):
        torch.testing.assert_close(g, w, atol=2e-4, rtol=2e-3)
    assert engine.stats()["ssd_chunk"]["launches_bwd"] == 3


def test_one_backward_launch_per_scan():
    ops, _, _ = _grad_case(2, 5, 16, 8, 8)
    ts = [torch.from_numpy(o).requires_grad_() for o in ops]
    (ssd_chunk_scan(*ts)[0] ** 2).sum().backward()
    st = engine.stats()["ssd_chunk"]
    assert (st["launches"], st["launches_bwd"]) == (1, 1)


def test_no_grad_scan_has_no_states_and_no_backward():
    ops, _, _ = _grad_case(2, 3, 16, 8, 8)
    with torch.no_grad():
        ssd_chunk_scan(*[torch.from_numpy(o) for o in ops])
    st = engine.stats()["ssd_chunk"]
    assert (st["launches"], st["launches_bwd"]) == (1, 0)


@pytest.mark.parametrize("shape", [(2, 4, 16, 8, 12), (1, 1, 8, 8, 8),
                                   (3, 3, 12, 5, 7)])
def test_plain_reverse_walk_matches_jax_vjp(shape):
    """``ref_ssd_chunk_scan_bwd`` from the forward's entering states
    against ``jax.vjp`` of the reference's oracle."""
    ops, wy, ws = _grad_case(*shape)
    _, vjp = jax.vjp(j_ref_scan, *map(jnp.asarray, ops))
    want = vjp((jnp.asarray(wy), jnp.asarray(ws)))
    t = [torch.from_numpy(o) for o in ops]
    _, _, states = ssd_scan_fused(*t, return_states=True)
    got = ref_ssd_chunk_scan_bwd(*t[:6], states, torch.from_numpy(wy),
                                 torch.from_numpy(ws))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_plain_reverse_walk_matches_torch_autograd():
    """The same oracle against torch autograd through the port's own
    forward oracle (no JAX in the loop)."""
    ops, wy, ws = _grad_case(2, 3, 16, 8, 12, seed=5)
    ts = [torch.from_numpy(o).requires_grad_() for o in ops]
    y, sf = ref_ssd_chunk_scan(*ts)
    want = torch.autograd.grad((y, sf), ts, (torch.from_numpy(wy),
                                             torch.from_numpy(ws)))
    _, _, states = ssd_scan_fused(*[t.detach() for t in ts],
                                  return_states=True)
    got = ref_ssd_chunk_scan_bwd(*[t.detach() for t in ts[:6]], states,
                                 torch.from_numpy(wy), torch.from_numpy(ws))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_backward_wrapper_rejects_what_the_kernel_does_not_take():
    ops, wy, ws = _grad_case(2, 3, 16, 8, 12)
    t = [torch.from_numpy(o) for o in ops]
    _, _, states = ssd_scan_fused(*t, return_states=True)
    dy, dsf = torch.from_numpy(wy), torch.from_numpy(ws)
    with pytest.raises(ValueError, match="dy must be"):
        ssd_scan_bwd(*t[:6], states, dy.bfloat16(), dsf)
    with pytest.raises(ValueError, match="states must be"):
        ssd_scan_bwd(*t[:6], states[:, :2], dy, dsf)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cdt,ldt,xdt", [
    ((2, 4, 16, 8, 12), torch.float32, torch.float32, torch.float32),
    ((3, 2, 100, 40, 24), torch.bfloat16, torch.float32, torch.bfloat16),
    ((8, 2, 256, 128, 64), torch.bfloat16, torch.float32, torch.float32)])
def test_backward_kernel_on_card(cuda_device, shape, cdt, ldt, xdt):
    ops, wy, ws = _grad_case(*shape)
    t = [torch.from_numpy(o).to(cuda_device).to(d) for o, d in
         zip(ops, (cdt, cdt, ldt, xdt) + (torch.float32,) * 3)]
    _, _, states = ssd_scan_fused(*t, return_states=True)
    dy = torch.from_numpy(wy).to(cuda_device)
    dsf = torch.from_numpy(ws).to(cuda_device)
    n0 = LAUNCHES["ssd_scan_bwd"]
    got = ssd_scan_bwd(*t[:6], states, dy, dsf)
    again = ssd_scan_bwd(*t[:6], states, dy, dsf)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan_bwd"] == n0 + 2
    want = ssd_scan_bwd_plain(*t[:6], states, dy, dsf)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)  # no atomics: the same bits every run
        torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")
