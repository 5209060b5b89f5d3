"""The SSD forward kernels' routes (``kernels/ssd_chunk/csrc/ssd_scan.cu``:
``ssd_scan_fused`` and ``ssd_chunk_diag``): the route choice, the cluster
fold of the carried state, the route counts, the premise of route A's
arithmetic, and -- on the card -- both kernels on both routes against
their plain versions, and route A's wgmma groups as ptxas compiles them.  The file imports no JAX, so its ``gpu`` tests run
on a machine with the card and without JAX:

    python3 -m pytest -q -m gpu tests/test_torch_ssd_fwd_routes.py

Tolerance: the kernels and ``ssd_scan_fused_plain`` /
``ssd_chunk_diag_plain`` compute from the same operands with the same
rounding points, in other fp32 summation orders; route A also carries
every fp32 operand of a product as three bf16 pieces (hi, lo, lo2) and
folds the carried state rank by rank over the cluster.  y must agree to
atol = rtol = 1e-4 where xdt is fp32 (2e-2 where it is bf16), the states
and s_final to 1e-4: ``chip_smoke.py``'s TOL.
"""
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_chunk import kernel as sk

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtypes,q,n,p,chunks,ptrs,route", [
    ((BF, F32, F32), 256, 128, 64, 4, (0,) * 10, "A"),  # mamba2
    ((BF, F32, F32), 64, 128, 64, 1, (0, 16, 1 << 20), "A"),
    ((BF, F32, F32), 192, 128, 64, 8, (), "A"),       # a full cluster
    ((BF, F32, F32), 128, 128, 64, 9, (), "B"),       # past the cluster
    ((BF, F32, F32), 256, 128, 64, 17, (), "B"),
    ((F32, F32, F32), 256, 128, 64, 4, (), "B"),      # fp32 C / B
    ((BF, BF, BF), 256, 128, 64, 4, (), "B"),         # bf16 L and xdt
    ((BF, BF, F32), 256, 128, 64, 4, (), "B"),
    ((BF, F32, BF), 256, 128, 64, 4, (), "B"),
    ((BF, F32, F32), 100, 128, 64, 4, (), "B"),       # Q not a multiple of 64
    ((BF, F32, F32), 256, 64, 64, 4, (), "B"),        # another state size
    ((BF, F32, F32), 256, 128, 12, 4, (), "B"),       # another head dim
    ((BF, F32, F32), 256, 128, 64, 4, (0, 4), "B")])  # a base off 16 bytes
def test_choose_fwd_route(dtypes, q, n, p, chunks, ptrs, route):
    assert sk.choose_fwd_route(*dtypes, q, n, p, chunks, ptrs) == route


def _operands(shape, dtypes=(BF, F32, F32), seed=0):
    """Physical inputs from numpy, as chip_smoke.py draws them: C and B
    0.5 N(0, 1), decays in (0, 1] from a negative cumulative log-decay
    (steps 0.02 |N(0, 1)|), L lower-triangular, xdt 0.5 N(0, 1), s0
    0.3 N(0, 1)."""
    g, nc, q, n, p = shape
    rng = np.random.default_rng(seed)

    def rnd(*s, scale=1.0):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                                * np.float32(scale))

    c, b = rnd(g, nc, q, n, scale=0.5), rnd(g, nc, q, n, scale=0.5)
    da = -(rnd(g, nc, q).abs() * 0.02).cumsum(-1)
    l = torch.where(torch.ones(q, q, dtype=torch.bool).tril(),
                    torch.exp(da[..., :, None] - da[..., None, :]), 0.0)
    x, s0 = rnd(g, nc, q, p, scale=0.5), rnd(g, p, n, scale=0.3)
    di, do = torch.exp(da), torch.exp(da[..., -1:] - da)
    cdt, ldt, xdt = dtypes
    return c.to(cdt), b.to(cdt), l.to(ldt), x.to(xdt), di, do, s0


def _rank_fold(inc, dlast, s0):
    """The states entering each chunk and s_final as route A folds them,
    one chunk a rank: s0 through the lower ranks' increments, rank 0
    first; the last rank folds its own increment into s_final."""
    nc = len(inc)
    states = []
    for r in range(nc):
        acc = s0
        for rr in range(r):
            acc = acc * dlast[rr] + inc[rr]
        states.append(acc)
    return states, states[-1] * dlast[-1] + inc[-1]


@pytest.mark.parametrize("nc", [1, 3, 4, 8])
def test_cluster_fold_is_the_reference_order_at_one_chunk_a_rank(nc):
    """Route A takes up to 8 chunks, a rank each, and the fold over the
    cluster (one multiply and one add a rank, no FMA) gives the states of
    the sequential walk bit for bit."""
    assert sk.choose_fwd_route(BF, F32, F32, 256, 128, 64, nc) == "A"
    rng = np.random.default_rng(nc)
    inc = [torch.from_numpy(rng.standard_normal((3, 8, 16),
                                                dtype=np.float32))
           for _ in range(nc)]
    dlast = [torch.from_numpy(rng.uniform(0.2, 1.0, (3, 1, 1))
                              .astype(np.float32)) for _ in range(nc)]
    s0 = torch.from_numpy(rng.standard_normal((3, 8, 16), dtype=np.float32))
    states, s_final = _rank_fold(inc, dlast, s0)
    s = s0
    for k in range(nc):
        assert torch.equal(states[k], s)
        s = s * dlast[k] + inc[k]
    assert torch.equal(s_final, s)


@pytest.mark.parametrize("nc", [9, 16, 20])
def test_more_chunks_than_a_cluster_take_route_b(nc):
    """A cluster holds at most SSD_MAX_CLUSTER (8) blocks, a chunk each,
    so a scan of more chunks a group takes route B, whatever its dtypes;
    its diag form (one chunk a cell) stays on route A."""
    assert sk.SSD_MAX_CLUSTER == 8
    assert sk.choose_fwd_route(BF, F32, F32, 256, 128, 64, nc) == "B"
    assert sk.choose_fwd_route(BF, F32, F32, 256, 128, 64) == "A"


def test_cpu_forward_counts_no_route():
    """The CPU path runs the plain versions: no launch, so no route; a
    reset clears the route counts with the launches."""
    c, b, l, x, di, do, s0 = ops = _operands((2, 3, 64, 128, 64))
    launches, routes = dict(sk.LAUNCHES), dict(sk.SSD_FWD_ROUTES)
    got = sk.ssd_scan_fused(*ops, return_states=True)
    flat = [t.reshape(6, *t.shape[2:]) for t in (c, b, l, x)]
    yd = sk.ssd_chunk_diag(*flat)
    assert sk.LAUNCHES == launches and sk.SSD_FWD_ROUTES == routes
    for g, w in zip(got, sk.ssd_scan_fused_plain(*ops, return_states=True)):
        assert torch.equal(g, w)
    assert torch.equal(yd, sk.ssd_chunk_diag_plain(*flat))
    sk.SSD_FWD_ROUTES["A"] += 1
    sk.reset_launches()
    assert set(sk.SSD_FWD_ROUTES.values()) == {0}


def _pieces(t, k):
    """t as k bf16 pieces, each of what the earlier ones leave out."""
    out = []
    for _ in range(k):
        out.append(t.bfloat16().float())
        t = t - out[-1]
    return out


def _route_a(c, b, l, x, di, do, s0, k=3, s_pieces=None):
    """Route A's arithmetic in plain torch with every fp32 operand of a
    product in k bf16 pieces (xdt ⊙ decay_out in the increment, S in C·Sᵀ
    -- s_pieces of them where given --, W and xdt in W·xdt), each product
    the sum of its piece products (exact in fp32) with fp32 sums -- W·xdt
    over the piece pairs whose indices sum to less than k (six at k = 3,
    three at k = 2) -- and the carried state folded over the cluster, a
    chunk a rank."""
    nc = c.shape[1]
    inc = [sum(a.transpose(1, 2) @ b[:, j].float()
               for a in _pieces(x[:, j] * do[:, j, :, None], k))
           for j in range(nc)]
    dlast = [di[:, j, -1, None, None] for j in range(nc)]
    states, s_final = _rank_fold(inc, dlast, s0)
    ys = []
    for j in range(nc):
        cj = c[:, j].float()
        w = (cj @ b[:, j].float().transpose(1, 2)) * l[:, j]
        ws, xs = _pieces(w, k), _pieces(x[:, j], k)
        y_diag = sum(ws[u] @ xs[v] for u in range(k) for v in range(k)
                     if u + v < k)
        y_off = sum(cj @ s.transpose(1, 2)
                    for s in _pieces(states[j], s_pieces or k)) \
            * di[:, j, :, None]
        ys.append(y_diag + y_off)
    return torch.stack(ys, 1), s_final, torch.stack(states, 1)


def _excess(got, want, tol=1e-4):
    """The largest |got - want| as a share of atol + rtol |want|."""
    return max(((g - w).abs() / (tol + tol * w.abs())).max().item()
               for g, w in zip(got, want))


@pytest.mark.parametrize("nc", [4, 9])
def test_route_a_arithmetic_matches_the_plain_scan(nc):
    """Route A's premise at mamba2-130m's full serving width (96 groups,
    chunks of 256, n 128, p 64, bf16 C / B, fp32 L / xdt; NC 4, and NC 9,
    the same arithmetic past the cluster limit, where the card takes route
    B): three bf16 pieces of every fp32 operand and the per-rank fold stay
    within 1e-4 of
    ``ssd_scan_fused_plain`` (y at 0.08-0.09 of the bound, the states at
    0.011-0.015).  Two pieces (the backward's split, W·xdt in three passes)
    miss y's bound about twice over; one bf16 rounding about a thousand
    times.  The state alone: in two pieces y comes to 0.6-0.7 of the
    bound (eight times nearer), in one piece about 400 times past it."""
    ops = _operands((96, nc, 256, 128, 64))
    want = sk.ssd_scan_fused_plain(*ops, return_states=True)

    def y_excess(**kw):
        return _excess([_route_a(*ops, **kw)[0]], [want[0]])

    three = [_excess([g], [w]) for g, w in zip(_route_a(*ops), want)]
    assert max(three) < 0.25, three
    assert 1.5 < y_excess(k=2) < 5
    assert y_excess(k=1) > 300
    assert 0.3 < y_excess(s_pieces=2) < 1
    assert y_excess(s_pieces=1) > 100


def test_route_a_diag_arithmetic_matches_the_plain_ladder():
    """The diag form's premise at serving's 384 flat cells: W and xdt in
    three pieces, six passes, within 1e-4 of ``ssd_chunk_diag_plain``
    (at 0.06 of the bound); in two pieces, three passes, past it."""
    c, b, l, x, *_ = _operands((96, 4, 256, 128, 64))
    flat = [t.reshape(384, *t.shape[2:]) for t in (c, b, l, x)]
    want = sk.ssd_chunk_diag_plain(*flat)
    fc, fb, fl, fx = flat
    w = (fc.float() @ fb.float().transpose(1, 2)) * fl

    def ladder(k, pairs):
        ws, xs = _pieces(w, k), _pieces(fx, k)
        return sum(ws[u] @ xs[v] for u, v in pairs)

    six = ladder(3, [(0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0)])
    three = ladder(2, [(0, 0), (0, 1), (1, 0)])
    assert _excess([six], [want]) < 0.25
    assert _excess([three], [want]) > 1.2


def _card_ops(device, shape, dtypes, seed=0):
    return [t.to(device) for t in _operands(shape, dtypes, seed)]


# (G, NC, Q, n, p), (C/B, L, xdt) dtypes, route: route A at mamba2-130m's
# serving (96 groups of 4 chunks) and training (192 groups, with the
# states) shapes and at NC 1 (one rank), 2, 3, 5 and 8 (a full cluster), at
# Q 64, 128 and 192; route B past the cluster (NC 9 and 17 in the model's
# dtypes), in fp32 and with bf16 L and xdt.
SCAN_CASES = [
    pytest.param((96, 4, 256, 128, 64), (BF, F32, F32), "A", id="serve"),
    pytest.param((192, 4, 256, 128, 64), (BF, F32, F32), "A", id="train"),
    pytest.param((3, 1, 256, 128, 64), (BF, F32, F32), "A", id="nc1"),
    pytest.param((3, 3, 192, 128, 64), (BF, F32, F32), "A", id="nc3_q192"),
    pytest.param((2, 5, 256, 128, 64), (BF, F32, F32), "A", id="nc5"),
    pytest.param((2, 8, 128, 128, 64), (BF, F32, F32), "A", id="nc8_q128"),
    pytest.param((2, 9, 64, 128, 64), (BF, F32, F32), "B", id="nc9_q64"),
    pytest.param((3, 2, 64, 128, 64), (BF, F32, F32), "A", id="nc2_q64"),
    pytest.param((2, 17, 128, 128, 64), (BF, F32, F32), "B",
                 id="nc17_q128"),
    pytest.param((2, 4, 256, 128, 64), (F32, F32, F32), "B", id="f32"),
    pytest.param((2, 3, 100, 40, 24), (BF, BF, BF), "B", id="bf16_odd"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtypes,route", SCAN_CASES)
def test_scan_routes_on_card(cuda_device, shape, dtypes, route):
    """One launch a call on the expected route; y, the states and s_final
    finite and within TOL of the plain version; the same bits on a second
    run."""
    ops = _card_ops(cuda_device, shape, dtypes)
    before = dict(sk.SSD_FWD_ROUTES)
    got = sk.ssd_scan_fused(*ops, return_states=True)
    again = sk.ssd_scan_fused(*ops, return_states=True)
    torch.cuda.synchronize()
    assert {r: sk.SSD_FWD_ROUTES[r] - before[r] for r in before
            if sk.SSD_FWD_ROUTES[r] != before[r]} == {route: 2}
    want = sk.ssd_scan_fused_plain(*ops, return_states=True)
    tols = (TOL[dtypes[2]], TOL[F32], TOL[F32])
    for name, g, a, w, tol in zip(("y", "s_final", "states"), got, again,
                                  want, tols):
        assert torch.isfinite(g.float()).all(), name
        assert torch.equal(g, a), name
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol,
                                   msg=name)


# Flat cells (G, Q, n, p): serving's 384, Q 64 and 128 on route A; fp32 and
# an odd bf16 shape on route B.
DIAG_CASES = [
    pytest.param((384, 256, 128, 64), (BF, F32, F32), "A", id="serve"),
    pytest.param((5, 64, 128, 64), (BF, F32, F32), "A", id="q64"),
    pytest.param((3, 128, 128, 64), (BF, F32, F32), "A", id="q128"),
    pytest.param((6, 256, 128, 64), (F32, F32, F32), "B", id="f32"),
    pytest.param((6, 100, 40, 24), (BF, BF, BF), "B", id="bf16_odd"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtypes,route", DIAG_CASES)
def test_diag_routes_on_card(cuda_device, shape, dtypes, route):
    g, q, n, p = shape
    c, b, l, x, *_ = _card_ops(cuda_device, (g, 1, q, n, p), dtypes)
    flat = [t[:, 0].contiguous() for t in (c, b, l, x)]
    before = dict(sk.SSD_FWD_ROUTES)
    got, again = sk.ssd_chunk_diag(*flat), sk.ssd_chunk_diag(*flat)
    torch.cuda.synchronize()
    assert {r: sk.SSD_FWD_ROUTES[r] - before[r] for r in before
            if sk.SSD_FWD_ROUTES[r] != before[r]} == {route: 2}
    want = sk.ssd_chunk_diag_plain(*flat)
    tol = TOL[dtypes[2]]
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_route_a_wgmma_groups_compile_as_written(cuda_device, tmp_path):
    """ptxas takes route A's wgmma groups as the source fences them: it
    injects no warpgroup fence of its own (C7519) and serializes no wgmma
    (C7520) in either form of ssd_fwd_wgmma, and neither spills."""
    from repro_torch.kernels import _build
    src = _build.sources()["ssd_scan"]
    out = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(tmp_path / "ssd_scan.so"), str(src)],
        capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    log = (out.stdout + out.stderr).splitlines()
    assert not [ln for ln in log if "C7519" in ln or "C7520" in ln], log
    entries = [i for i, ln in enumerate(log)
               if "Compiling entry function" in ln and "ssd_fwd_wgmma" in ln]
    assert len(entries) == 2, log
    for i in entries:
        props = " ".join(log[i + 1:i + 4])
        assert "0 bytes stack frame, 0 bytes spill stores" in props, props


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")
