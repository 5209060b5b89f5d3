"""The SSD scan backward's routes (``kernels/ssd_chunk/csrc/ssd_scan_bwd.cu``):
the route choice, the cluster rule and the chunk split, the route counts,
the premise of route A's arithmetic, and -- on the card -- each route
against the plain version.  The file imports no JAX, so its ``gpu`` tests
run on a machine with the card and without JAX:

    python3 -m pytest -q -m gpu tests/test_torch_ssd_bwd_routes.py

Tolerance: the kernel and ``ssd_scan_bwd_plain`` both compute in fp32 from
the same operands, in other summation orders; route A also carries every
fp32 operand of a product as a bf16 hi + lo pair (2^-16 relative left
out; S_in and dS in three pieces in C·S_inᵀ and B·dSᵀ) and folds the
carried state cotangent rank by rank.  They must agree to
atol = rtol = 1e-3, the bound ``chip_smoke.py`` holds them to (BWD_TOL).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_chunk import kernel as sk

BWD_TOL = dict(atol=1e-3, rtol=1e-3)
NAMES = ("dc", "db", "dl", "dx", "ddi", "ddo", "ds0")
BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtypes,q,n,p,ptrs,route", [
    ((BF, F32, F32), 256, 128, 64, (0,) * 9, "A"),   # mamba2 training
    ((BF, F32, F32), 64, 128, 64, (0, 16, 1 << 20), "A"),
    ((BF, F32, F32), 192, 128, 64, (), "A"),
    ((F32, F32, F32), 256, 128, 64, (), "B"),        # fp32 C / B
    ((BF, BF, BF), 256, 128, 64, (), "B"),           # bf16 L and xdt
    ((BF, BF, F32), 256, 128, 64, (), "B"),
    ((BF, F32, BF), 256, 128, 64, (), "B"),
    ((BF, F32, F32), 100, 128, 64, (), "B"),         # Q not a multiple of 64
    ((BF, F32, F32), 256, 64, 64, (), "B"),          # another state size
    ((BF, F32, F32), 256, 128, 12, (), "B"),         # another head dim
    ((BF, F32, F32), 256, 128, 64, (0, 8), "B")])    # a base off 16 bytes
def test_choose_bwd_route(dtypes, q, n, p, ptrs, route):
    assert sk.choose_bwd_route(*dtypes, q, n, p, ptrs) == route


@pytest.mark.parametrize("chunks,cluster", [(1, 1), (3, 3), (4, 4), (5, 5),
                                            (8, 8), (9, 8), (16, 8),
                                            (20, 8)])
def test_cluster_rule_and_chunk_split(chunks, cluster):
    """One block a chunk up to the portable cluster size of 8; the ranks'
    runs cover the chunks in order, none empty, lengths within one."""
    assert sk.bwd_cluster(chunks) == cluster
    runs = [sk.bwd_chunks(chunks, cluster, r) for r in range(cluster)]
    assert runs[0][0] == 0 and runs[-1][1] == chunks
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    sizes = {hi - lo for lo, hi in runs}
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def _operands(shape, dtypes, seed=0):
    """Physical inputs from numpy (decays in (0, 1] from a negative
    cumulative log-decay, L lower-triangular, as the model builds them),
    the forward's entering states from the plain scan, and fp32 dY and
    dS_final."""
    g, nc, q, n, p = shape
    rng = np.random.default_rng(seed)

    def rnd(*s, scale=1.0):
        return torch.from_numpy((rng.standard_normal(s) * scale)
                                .astype(np.float32))

    c, b = rnd(g, nc, q, n, scale=0.5), rnd(g, nc, q, n, scale=0.5)
    da = -(rnd(g, nc, q).abs() * 0.02).cumsum(-1)
    l = torch.where(torch.ones(q, q, dtype=torch.bool).tril(),
                    torch.exp(da[..., :, None] - da[..., None, :]), 0.0)
    x, s0 = rnd(g, nc, q, p, scale=0.5), rnd(g, p, n, scale=0.3)
    di, do = torch.exp(da), torch.exp(da[..., -1:] - da)
    cdt, ldt, xdt = dtypes
    c, b, l, x = c.to(cdt), b.to(cdt), l.to(ldt), x.to(xdt)
    _, _, states = sk.ssd_scan_fused_plain(c, b, l, x, di, do, s0,
                                           return_states=True)
    return (c, b, l, x, di, do, states, rnd(g, nc, q, p), rnd(g, p, n))


def test_cpu_backward_counts_no_route():
    """The CPU path runs the plain version: no launch, so no route; a
    reset clears the route counts with the launches."""
    ops = _operands((2, 3, 64, 128, 64), (BF, F32, F32))
    launches, routes = dict(sk.LAUNCHES), dict(sk.SSD_BWD_ROUTES)
    got = sk.ssd_scan_bwd(*ops)
    assert sk.LAUNCHES == launches and sk.SSD_BWD_ROUTES == routes
    for g, w in zip(got, sk.ssd_scan_bwd_plain(*ops)):
        assert torch.equal(g, w)
    sk.SSD_BWD_ROUTES["A"] += 1
    sk.reset_launches()
    assert set(sk.SSD_BWD_ROUTES.values()) == {0}


def _split(t, lo=True, pieces=2):
    out = []
    for _ in range(pieces if lo else 1):
        out.append(t.bfloat16().float())
        t = t - out[-1]
    return out + [torch.zeros_like(t)] * (2 - len(out))


def _route_a(c, b, l, x, di, do, states, dy, dsf, lo=True):
    """Route A's arithmetic in plain torch: each fp32 operand of a product
    split into bf16 hi and lo (S_in, dS and dY ⊙ di into three pieces
    where they meet C or B; ``lo=False``: rounded once to bf16), each
    product the sum of its bf16 piece products (exact in fp32) with fp32
    sums, and the carried cotangent folded rank by rank over the cluster,
    in the kernel's order."""
    def mm2(a, w):      # a fp32, w bf16-exact
        ah, al = _split(a, lo)
        return ah @ w + al @ w

    def mm3(a, w):      # both fp32
        (ah, al), (wh, wl) = _split(a, lo), _split(w, lo)
        return ah @ wh + ah @ wl + al @ wh

    g, nc = c.shape[:2]
    c, b = c.float(), b.float()
    outs = [torch.empty_like(t, dtype=torch.float32)
            for t in (c, b, l, x, di, do)]
    inc = [sum(a.transpose(1, 2) @ c[:, k] for a in
               _split(dy[:, k] * di[:, k, :, None], lo, 3))
           for k in range(nc)]
    dlast = [di[:, k, -1, None, None] for k in range(nc)]
    cl = sk.bwd_cluster(nc)
    runs = [sk.bwd_chunks(nc, cl, r) for r in range(cl)]
    pub = []
    for lo_, hi_ in runs:   # each rank's chunks folded from zero
        acc, dprod = inc[hi_ - 1], dlast[hi_ - 1]
        for k in range(hi_ - 2, lo_ - 1, -1):
            acc, dprod = acc * dlast[k] + inc[k], dprod * dlast[k]
        pub.append((acc, dprod))
    ds_out = [None] * nc
    for r, (lo_, hi_) in enumerate(runs):
        acc = dsf
        for rr in range(cl - 1, r, -1):
            acc = acc * pub[rr][1] + pub[rr][0]
        if r == 0:
            ds0 = acc * pub[0][1] + pub[0][0]
        for k in range(hi_ - 1, lo_ - 1, -1):
            ds_out[k] = acc
            acc = acc * dlast[k] + inc[k]
    dc, db, dl, dx, ddi, ddo = outs
    for k in range(nc):
        ck, bk, lk, xk, dik, dok = (t[:, k] for t in (c, b, l, x, di, do))
        ds, sin, dyk = ds_out[k], states[:, k], dy[:, k]
        dxw = _mm_wt(bk, ds, lo)
        ddo[:, k] = (dxw * xk).sum(-1)
        s = ck @ bk.transpose(1, 2)
        dw = mm3(dyk, xk.transpose(1, 2))
        dl[:, k] = dw * s
        dsc, w = dw * lk, s * lk
        db[:, k] = mm3(xk, ds) * dok[..., None] \
            + mm2(dsc.transpose(1, 2), ck)
        dx[:, k] = dxw * dok[..., None] + mm3(w.transpose(1, 2), dyk)
        yoff = _mm_wt(ck, sin, lo)
        ddi[:, k] = (dyk * yoff).sum(-1)
        ddi[:, k, -1] += (sin * ds).sum((1, 2))
        dc[:, k] = mm3(dyk, sin) * dik[..., None] + mm2(dsc, bk)
    return dc, db, dl, dx, ddi, ddo, ds0


def _mm_wt(w, a, lo):
    """w·aᵀ with w bf16-exact and a fp32 in three pieces."""
    return sum(w @ piece.transpose(1, 2) for piece in _split(a, lo, 3))


def _excess(got, want):
    """The largest |got - want| as a share of atol + rtol |want|."""
    return max(((g - w).abs() / (1e-3 + 1e-3 * w.abs())).max().item()
               for g, w in zip(got, want))


@pytest.mark.parametrize("nc", [4, 9])
def test_route_a_arithmetic_matches_the_plain_walk(nc):
    """Route A's premise at a small training-like shape (2 groups, chunks
    of 256, n 128, p 64, bf16 C / B, fp32 L / xdt; NC 4: one chunk a rank,
    NC 9: a cluster of 8 with one rank walking two): split operands and the
    per-rank fold stay within 1e-3 of the plain reverse walk, at 0.31 (NC
    4) and 0.44 (NC 9) of the bound, nearly all of it the two-piece
    split's 2^-16 in dW and dL; one bf16 rounding of the fp32 operands
    misses it 193 and 243 times over."""
    ops = _operands((2, nc, 256, 128, 64), (BF, F32, F32))
    want = sk.ssd_scan_bwd_plain(*ops)
    split = _excess(_route_a(*ops), want)
    once = _excess(_route_a(*ops, lo=False), want)
    assert split < 0.6, split
    assert once > 50, once


def _card_case(device, shape, dtypes, seed=0):
    return [t.to(device) for t in _operands(shape, dtypes, seed)]


# (G, NC, Q, n, p), (C/B, L, xdt) dtypes, route: route A at mamba2-130m's
# training shape (8 x 1024: 192 groups of 4 chunks) and at NC 1 (one
# rank), 3, 5 (a cluster of 5) and 9 (a cluster of 8, one rank with two
# chunks), at Q 64 and 192; route B in fp32 and with bf16 L and xdt.
CARD_CASES = [
    pytest.param((192, 4, 256, 128, 64), (BF, F32, F32), "A", id="train"),
    pytest.param((3, 1, 256, 128, 64), (BF, F32, F32), "A", id="nc1"),
    pytest.param((3, 3, 192, 128, 64), (BF, F32, F32), "A", id="nc3_q192"),
    pytest.param((2, 5, 256, 128, 64), (BF, F32, F32), "A", id="nc5"),
    pytest.param((2, 9, 64, 128, 64), (BF, F32, F32), "A", id="nc9_q64"),
    pytest.param((2, 4, 256, 128, 64), (F32, F32, F32), "B", id="f32"),
    pytest.param((2, 3, 100, 40, 24), (BF, BF, BF), "B", id="bf16_odd"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtypes,route", CARD_CASES)
def test_backward_routes_on_card(cuda_device, shape, dtypes, route):
    """One launch on the expected route, all seven cotangents finite and
    within 1e-3 of the plain version, and the same bits on a second run."""
    ops = _card_case(cuda_device, shape, dtypes)
    before = dict(sk.SSD_BWD_ROUTES)
    got = sk.ssd_scan_bwd(*ops)
    again = sk.ssd_scan_bwd(*ops)
    torch.cuda.synchronize()
    assert {r: sk.SSD_BWD_ROUTES[r] - before[r] for r in before
            if sk.SSD_BWD_ROUTES[r] != before[r]} == {route: 2}
    want = sk.ssd_scan_bwd_plain(*ops)
    for name, g, a, w in zip(NAMES, got, again, want):
        assert torch.isfinite(g).all(), name
        assert torch.equal(g, a), name
        torch.testing.assert_close(g, w, **BWD_TOL, msg=name)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")
