"""The tile transpose's routes (``kernels/transpose/csrc/transpose.cu``):
the route choice, route A's persistent tile walk, the route counts, and --
on the card -- both routes against ``transpose_plain`` at every element
size, on batched, ragged and NaN-padded views.  The file imports no JAX,
so its ``gpu`` tests run on a machine with the card and without JAX:

    python3 -m pytest -q -m gpu tests/test_torch_transpose_routes.py

Tolerance: none.  The transpose moves bits, so every comparison is
``torch.equal`` (NaN never reaches a compared output).
"""
import itertools

import pytest
import torch

from repro_torch.core import H100_SXM
from repro_torch.kernels.transpose import kernel as tk

BF, F32 = torch.bfloat16, torch.float32


# dtype, rows, cols, (batch, row, column) strides, base pointer, route.
ROUTE_CASES = [
    (BF, 151936, 1024, (151936 * 1024, 1024, 1), 0, "A"),   # Qwen3's table
    (F32, 256, 512, (256 * 512, 512, 1), 256, "A"),          # fig89
    (F32, 1000, 777, (1005 * 788, 788, 1), 0, "A"),          # padded rows
    (torch.int8, 32, 48, (32 * 48, 48, 1), 16, "A"),
    (torch.uint8, 16, 16, (256, 16, 1), 0, "A"),
    (torch.float16, 8, 8, (64, 8, 1), 0, "A"),
    (torch.int32, 4, 4, (16, 4, 1), 0, "A"),
    (torch.float64, 2, 2, (4, 2, 1), 0, "A"),
    (torch.int64, 998, 130, (998 * 130, 130, 1), 0, "A"),
    (torch.complex64, 6, 2, (12, 2, 1), 0, "A"),             # 8 bytes
    (BF, 999, 777, (1002 * 780, 780, 1), 0, "B"),    # 1560-byte rows
    (BF, 64, 64, (64 * 64, 64, 1), 8, "B"),          # a base off 16 bytes
    (BF, 64, 64, (64 * 64, 64, 1), 2, "B"),
    (BF, 64, 64, (4100, 64, 1), 0, "B"),             # batch stride off 16
    (BF, 63, 64, (63 * 64, 64, 1), 0, "B"),          # output row 126 bytes
    (F32, 6, 8, (48, 8, 1), 0, "B"),                 # output row 24 bytes
    (torch.int8, 24, 32, (768, 32, 1), 0, "B"),      # output row 24 bytes
    (torch.int8, 32, 40, (1280, 40, 1), 0, "B"),     # 40-byte rows
    (torch.float64, 3, 2, (6, 2, 1), 0, "B"),        # output row 24 bytes
    (torch.complex128, 4, 4, (16, 4, 1), 0, "B"),    # 16-byte elements
    (F32, 64, 64, (4096, 64, 2), 0, "B"),            # column stride 2
    (torch.int8, 16, 1 << 35, (1 << 39, 1 << 35, 1), 0, "A"),
    (torch.int8, 32, 1 << 35, (1 << 40, 1 << 35, 1), 0, "B"),  # 2^40 bytes
    (F32, 4, 4, (1 << 38, 4, 1), 0, "B"),            # batch stride 2^40
]


@pytest.mark.parametrize("dtype,rows,cols,strides,ptr,route", ROUTE_CASES)
def test_choose_route(dtype, rows, cols, strides, ptr, route):
    assert tk.choose_route(dtype, rows, cols, strides, ptr) == route


def test_chip_smoke_views_take_their_routes():
    """The padded views chip_smoke.py draws: the ragged batch padded by
    (5, 11) in fp32 (a 3152-byte row) on route A, the (2, 999, 777) bf16
    batch padded by 3 columns (a 1560-byte row) on route B."""
    for (nb, rows, cols), pad, dtype, route in (
            ((3, 1000, 777), (5, 11), F32, "A"),
            ((2, 999, 777), (0, 3), BF, "B")):
        base = torch.full((nb, rows + pad[0], cols + pad[1]), float("nan"),
                          dtype=dtype)
        view = base[:, :rows, :cols]
        assert tk.choose_route(dtype, rows, cols, view.stride(),
                               view.data_ptr()) == route


def test_cpu_call_counts_no_route():
    """The CPU path runs the plain version: no launch, so no route; a
    reset clears the route counts with the launches."""
    x = torch.randn(2, 48, 40)
    launches, routes = dict(tk.LAUNCHES), dict(tk.TRANSPOSE_ROUTES)
    got = tk.transpose_tiles(x, bt=32)
    assert torch.equal(got, x.transpose(1, 2))
    assert tk.LAUNCHES == launches and tk.TRANSPOSE_ROUTES == routes
    tk.TRANSPOSE_ROUTES["A"] += 1
    tk.LAUNCHES["transpose"] += 1
    tk.reset_launches()
    assert tk.TRANSPOSE_ROUTES == {"A": 0, "B": 0}
    assert tk.LAUNCHES == {"transpose": 0}


WALK_SHAPES = [(1, 256, 512), (1, 1000, 777), (3, 1000, 777), (2, 65, 129),
               (5, 1, 1), (1, 4096, 64), (2, 33, 2000)]


@pytest.mark.parametrize("nb,rows,cols", WALK_SHAPES)
@pytest.mark.parametrize("bt", H100_SXM.transpose_tiles)
def test_route_a_walk_covers_every_tile_once(nb, rows, cols, bt):
    """Route A's persistent blocks, whatever their count, own every
    (b, i, j) tile exactly once between them, each walking its tiles in
    the walk's order."""
    ti, tj = -(-rows // bt), -(-cols // bt)
    every = set(itertools.product(range(nb), range(ti), range(tj)))
    for blocks in (1, 7, 132, 528, 10 ** 6):
        walks = tk.route_a_walk(nb, rows, cols, bt, blocks)
        assert len(walks) == min(blocks, len(every))
        flat = [t for w in walks for t in w]
        assert len(flat) == len(every) and set(flat) == every
        assert all(w == sorted(w) for w in walks)


def test_route_a_walk_order():
    """Batch by batch, row tile by row tile, the column tile fastest: the
    tiles in flight read whole source rows."""
    ti, tj = 5, 3
    order = [tk.walk_tile(t, ti, tj) for t in range(2 * ti * tj)]
    assert order == list(itertools.product(range(2), range(ti), range(tj)))
    assert tk.route_a_walk(1, 64, 192, 64, 2) == [
        [(0, 0, 0), (0, 0, 2)], [(0, 0, 1)]]


def test_ring_fits_an_sm_at_every_instantiation():
    """Route A's ring at every element size and tile edge fits a block's
    227 KB of shared memory; bf16 at the large tile leaves room for four
    blocks an SM, fp32 for two."""
    for elem, bt in itertools.product((1, 2, 4, 8), H100_SXM.transpose_tiles):
        assert tk.ring_smem_bytes(elem, bt) <= 232448
        assert tk.box_row(elem, bt) in (32, 64, 128)
    big = max(H100_SXM.transpose_tiles)
    assert 233472 // (tk.ring_smem_bytes(2, big) + 1024) == 4
    assert 233472 // (tk.ring_smem_bytes(4, big) + 1024) == 2


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _draw(shape, dtype, device, gen):
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    if dtype.is_complex:
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dtype)
    return torch.randint(0, 100, shape, generator=gen, device=device,
                         dtype=dtype)


def _padded(shape, pad, dtype, device, gen):
    """A view of ``shape`` into a larger buffer padded by ``pad`` rows and
    columns, NaN past the view where the dtype has it."""
    nb, rows, cols = shape
    fill = float("nan") if dtype.is_floating_point else 77
    base = torch.full((nb, rows + pad[0], cols + pad[1]), fill,
                      dtype=dtype, device=device)
    view = base[:, :rows, :cols]
    view.copy_(_draw(shape, dtype, device, gen))
    return view


# (nb, rows, cols), (row pad, column pad) or None, dtype, route.
CARD_CASES = [
    pytest.param((1, 256, 512), None, F32, "A", id="fig89"),
    pytest.param((3, 1000, 777), (5, 11), F32, "A", id="ragged_padded"),
    pytest.param((2, 1008, 528), None, torch.int8, "A", id="int8"),
    pytest.param((3, 80, 200), (3, 8), torch.uint8, "A", id="uint8_padded"),
    pytest.param((2, 200, 136), (1, 8), BF, "A", id="bf16_padded"),
    pytest.param((1, 72, 40), None, torch.float16, "A", id="f16_ragged"),
    pytest.param((2, 998, 130), None, torch.float64, "A", id="f64"),
    pytest.param((2, 66, 70), (2, 2), torch.int64, "A", id="i64_padded"),
    pytest.param((2, 999, 777), (0, 3), BF, "B", id="route_b_bf16"),
    pytest.param((2, 63, 45), None, F32, "B", id="route_b_f32_rows"),
    pytest.param((2, 31, 65), (0, 3), torch.int8, "B", id="route_b_int8"),
    pytest.param((3, 7, 9), None, torch.float64, "B", id="route_b_f64"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,pad,dtype,route", CARD_CASES)
def test_routes_on_card(cuda_device, shape, pad, dtype, route):
    """Each tile edge: one launch on the expected route, bit for bit the
    plain version, the same bits on a second run, no NaN from past a
    padded view's edge."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = _padded(shape, pad, dtype, cuda_device, gen) if pad else \
        _draw(shape, dtype, cuda_device, gen)
    for bt in H100_SXM.transpose_tiles:
        before = dict(tk.TRANSPOSE_ROUTES)
        got, again = tk.transpose_tiles(x, bt=bt), tk.transpose_tiles(x, bt=bt)
        torch.cuda.synchronize()
        assert {r: tk.TRANSPOSE_ROUTES[r] - before[r] for r in before
                if tk.TRANSPOSE_ROUTES[r] != before[r]} == {route: 2}
        assert torch.equal(got, tk.transpose_plain(x, bt=bt))
        assert torch.equal(got, again)
        if dtype.is_floating_point:
            assert not torch.isnan(got).any()


@pytest.mark.gpu
def test_a_view_neither_route_takes_raises(cuda_device):
    """16-byte elements fit neither route, nor does a batch past route B's
    grid on a view TMA cannot address: the wrapper raises."""
    x = torch.zeros((1, 4, 4), dtype=torch.complex128, device=cuda_device)
    with pytest.raises(RuntimeError, match="transpose"):
        tk.transpose_tiles(x, bt=32)
    y = torch.zeros((70000, 1, 3), dtype=torch.int8, device=cuda_device)
    assert tk.choose_route(y.dtype, 1, 3, y.stride(), y.data_ptr()) == "B"
    with pytest.raises(RuntimeError, match="transpose"):
        tk.transpose_tiles(y, bt=32)
    torch.cuda.synchronize()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")
