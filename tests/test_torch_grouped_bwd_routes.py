"""The grouped-GEMM backward's routes (``kernels/grouped_gemm/csrc/
grouped.cu``): the route choice, the route counts, the premise of route
A's arithmetic, and -- on the card -- each route against the plain
version.  The file imports no JAX, so its ``gpu`` tests run on a machine
with the card and without JAX:

    python3 -m pytest -q -m gpu tests/test_torch_grouped_bwd_routes.py

Tolerance: the kernel and ``grouped_bwd_plain`` both compute in fp32 from
the same operands, in other summation orders; route A also carries the
fp32 cotangent as a bf16 hi + lo pair (2^-16 relative left out).  They
must agree to atol = rtol = 1e-3, the bound ``chip_smoke.py`` holds them
to (BWD_TOL).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import GroupedTileSchedule
from repro_torch.kernels.grouped_gemm import kernel as grk
from repro_torch.kernels.grouped_gemm.ref import expert_offsets

BWD_TOL = dict(atol=1e-3, rtol=1e-3)
BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,k,n,ptrs,route", [
    (BF, 4096, 6400, (0, 0, 0), "A"),         # phi3.5-moe's gate / up
    (BF, 6400, 4096, (16, 32, 1 << 20), "A"),  # its down projection
    (BF, 200, 136, (), "A"),                   # K and N tails of the tile
    (BF, 1000, 300, (), "C"),                  # w rows of 600 bytes
    (BF, 100, 160, (), "C"),                   # x rows of 200 bytes
    (BF, 96, 160, (0, 8, 0), "C"),             # w's base off 16 bytes
    (BF, 96, 160, (0, 0, 4), "C"),             # dy's base off 16 bytes
    (F32, 4096, 6400, (), "fp32"),
    (F32, 100, 70, (4, 4, 4), "fp32")])
def test_choose_bwd_route(dtype, k, n, ptrs, route):
    assert grk.choose_bwd_route(dtype, k, n, ptrs) == route


def _operands(sizes, extra, k, n, dtype, seed=0, nan_tail=False):
    """x, w and the fp32 cotangent from numpy at the model's scales (w
    times K^-1/2), int32 group sizes; with ``nan_tail`` x and dy hold NaN
    in the rows past sum(sizes)."""
    rng = np.random.default_rng(seed)
    total = sum(sizes)
    t = total + extra
    x = torch.from_numpy(rng.standard_normal((t, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((len(sizes), k, n))
                          * k ** -0.5).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((t, n)).astype(np.float32))
    if nan_tail:
        x[total:] = float("nan")
        dy[total:] = float("nan")
    return (x.to(dtype), w.to(dtype), dy,
            torch.tensor(sizes, dtype=torch.int32))


def _table(sizes, t, k, n, bm, device="cpu"):
    return GroupedTileSchedule(t=t, k=k, n=n, num_experts=len(sizes), bm=bm,
                               bk=32, bn=min(128, n)).tables(
        torch.tensor(sizes, dtype=torch.int32, device=device))


def test_cpu_backward_counts_no_route():
    """The CPU path runs the plain version: no launch, so no route; a
    reset clears the route counts with the launches."""
    x, w, dy, gs = _operands([20, 0, 30], 5, 48, 64, BF)
    table = _table([20, 0, 30], 55, 48, 64, 16)
    launches, routes = dict(grk.LAUNCHES), dict(grk.BWD_ROUTES)
    got = grk.grouped_bwd(table, x, dy, w, gs, bm=16, with_db=True)
    assert grk.LAUNCHES == launches and grk.BWD_ROUTES == routes
    for g, want in zip(got, grk.grouped_bwd_plain(table, x, dy, w, gs,
                                                  with_db=True)):
        assert torch.equal(g, want)
    grk.BWD_ROUTES["A"] += 1
    grk.reset_launches()
    assert set(grk.BWD_ROUTES.values()) == {0}


def _split(t, lo=True):
    hi = t.bfloat16().float()
    return hi, (t - hi).bfloat16().float() if lo else torch.zeros_like(t)


def _route_a(x, dy, w, sizes, lo=True, mask_by_product=False):
    """Route A's arithmetic in plain torch: the fp32 cotangent split into
    bf16 hi and lo (``lo=False``: rounded once to bf16), each product the
    sum of its piece products with bf16-exact operands (exact in fp32) and
    fp32 sums.  dW reduces over the expert's rows in panels of BWD_PANEL:
    a panel past the expert's end reads the following rows of x and dy
    (the next expert's, or rows past the sum) and zeroes both with
    `where` -- or, with ``mask_by_product``, by multiplying them by 0."""
    panel = grk.BWD_PANEL
    xf, wf = x.float(), w.float()
    t, k = x.shape
    e, _, n = w.shape
    dx = torch.zeros(t, k)
    dw = torch.zeros(e, k, n)
    db = torch.zeros(e, n)
    offs = expert_offsets(torch.tensor(sizes)).tolist()
    pad = panel  # rows a last panel may read past the tensor: TMA's zeros
    xp = torch.cat([xf, torch.zeros(pad, k)])
    dyp = torch.cat([dy, torch.zeros(pad, n)])
    for i in range(e):
        r0, r1 = offs[i], offs[i + 1]
        if r1 == r0:
            continue
        hi, lo_ = _split(dy[r0:r1], lo)
        dx[r0:r1] = hi @ wf[i].T + lo_ @ wf[i].T
        for p0 in range(r0, r1, panel):
            rows = torch.arange(p0, p0 + panel)
            own = (rows < r1)[:, None]
            xs, ds = xp[p0:p0 + panel], dyp[p0:p0 + panel]
            if mask_by_product:
                xs, ds = xs * own, ds * own
            else:
                xs, ds = torch.where(own, xs, 0.0), torch.where(own, ds, 0.0)
            hi, lo_ = _split(ds, lo)
            dw[i] += xs.T @ hi + xs.T @ lo_
            db[i] += ds.sum(0)
    return dx, dw, db


def _excess(got, want):
    """The largest |got - want| as a share of atol + rtol |want|."""
    return max(((g - w).abs() / (1e-3 + 1e-3 * w.abs())).max().item()
               for g, w in zip(got, want))


def test_route_a_arithmetic_matches_the_plain_version():
    """Route A's premise at a small shape with the main path's scales
    (groups of 1-256 rows, one empty, NaN in x and dy past the sum, K 256,
    N 320): the hi + lo split with `where`-masked panels stays within 1e-3
    of the plain expert-by-expert product at 0.13 of the bound, nearly all
    of it dW's (the split leaves about 2^-17 of each term out, and a
    256-row sum of unit terms can end near zero, where the bound is its
    atol); one bf16 rounding of dy misses the bound 86 times over in dW
    and 7 in dX; and masking by a product instead of `where` lets the NaN
    rows through into dW and db."""
    sizes = [1, 256, 0, 37, 100]
    x, w, dy, gs = _operands(sizes, 20, 256, 320, BF, nan_tail=True)
    table = _table(sizes, x.shape[0], 256, 320, 128)
    want = grk.grouped_bwd_plain(table, x, dy, w, gs, with_db=True)
    assert all(torch.isfinite(t).all() for t in want)
    split = _excess(_route_a(x, dy, w, sizes), want)
    once = _excess(_route_a(x, dy, w, sizes, lo=False), want)
    assert split < 0.2, split
    assert once > 50, once
    by_product = _route_a(x, dy, w, sizes, mask_by_product=True)
    assert not torch.isfinite(by_product[1]).all()
    assert not torch.isfinite(by_product[2]).all()


# (group sizes, rows past the sum, K, N, dtype, bm, NaN past the sum,
# route): route A at phi3.5-moe's uniform groups (narrowed), on row-aware
# tiles (groups of 1-65 rows on bm 128 and 64 tiles), a bm 16 table with
# NaN past the sum, K and N tails of the 128-wide tile; route C (N = 300,
# and a base 8 bytes off 16), fp32.
CARD_CASES = [
    pytest.param([256] * 4, 0, 512, 640, BF, 128, False, "A", id="uniform"),
    pytest.param([1, 17, 0, 32, 64, 65], 0, 512, 256, BF, 128, False, "A",
                 id="rows_bm128"),
    pytest.param([1, 17, 0, 32, 64, 65], 0, 512, 256, BF, 64, False, "A",
                 id="rows_bm64"),
    pytest.param([40, 0, 90], 30, 256, 192, BF, 16, True, "A",
                 id="nan_past_sum_bm16"),
    pytest.param([40, 0, 90], 30, 256, 192, BF, 128, True, "A",
                 id="nan_past_sum_bm128"),
    pytest.param([50, 0, 80], 3, 200, 136, BF, 64, False, "A", id="tails"),
    pytest.param([100, 0, 0, 250], 20, 1000, 300, BF, 128, False, "C",
                 id="route_c_n300"),
    pytest.param([60, 85], 5, 96, 160, "misaligned", 128, False, "C",
                 id="route_c_base"),
    pytest.param([37, 0, 201, 70], 4, 100, 70, F32, 16, False, "fp32",
                 id="fp32"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,extra,k,n,dtype,bm,nan_tail,route",
                         CARD_CASES)
def test_backward_routes_on_card(cuda_device, sizes, extra, k, n, dtype, bm,
                                 nan_tail, route):
    """One launch a call on the expected route; dX, dW and db finite and
    within 1e-3 of the plain version; the same bits on a second run; an
    empty expert's dW and db exactly zero, and dX rows past the sum
    exactly zero."""
    misaligned = dtype == "misaligned"
    x, w, dy, gs = _operands(sizes, extra, k, n, BF if misaligned else dtype,
                             nan_tail=nan_tail)
    x, w, dy, gs = (a.to(cuda_device) for a in (x, w, dy, gs))
    if misaligned:  # the same values from a base 8 bytes past 16
        buf = torch.empty(x.numel() + 4, dtype=BF, device=cuda_device)
        buf[4:] = x.flatten()
        x = buf[4:].view(x.shape)
    table = _table(sizes, x.shape[0], k, n, bm, cuda_device)
    before = dict(grk.BWD_ROUTES)
    got = grk.grouped_bwd(table, x, dy, w, gs, bm=bm, with_db=True)
    again = grk.grouped_bwd(table, x, dy, w, gs, bm=bm, with_db=True)
    torch.cuda.synchronize()
    assert {r: grk.BWD_ROUTES[r] - before[r] for r in before
            if grk.BWD_ROUTES[r] != before[r]} == {route: 2}
    want = grk.grouped_bwd_plain(table, x, dy, w, gs, with_db=True)
    for name, g, a, ref in zip(("dx", "dw", "db"), got, again, want):
        assert torch.isfinite(g).all(), name
        assert torch.equal(g, a), name
        torch.testing.assert_close(g, ref, **BWD_TOL, msg=name)
    for e, size in enumerate(sizes):
        if size == 0:
            assert torch.count_nonzero(got[1][e]) == 0
            assert torch.count_nonzero(got[2][e]) == 0
    assert torch.count_nonzero(got[0][sum(sizes):]) == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")
