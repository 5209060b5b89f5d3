"""Wrapper around the Hopper tile-transpose kernel (``csrc/transpose.cu``)
beside its plain torch version.

:func:`transpose_tiles` -- ``(nb, rows, cols) -> (nb, cols, rows)`` in one
launch (the counterpart of the reference's ``build_transpose_kernel``).
The source may be a view with a row stride larger than its width (a padded
buffer): nothing past its logical extent is read.  Any dtype of 1, 2, 4 or
8 bytes: the copy moves bits, so the output is bit-exact.  Each call takes
one of two routes (:func:`choose_route`) and adds one to it in
:data:`TRANSPOSE_ROUTES`:

  * "A", views TMA can address: a persistent grid walks the (bt, bt)
    tiles (:func:`route_a_walk`), TMA loads a ring of
    :data:`RING_STAGES` tiles a block, the warps transpose a tile through
    shared memory, and TMA stores the output tile whole;
  * "B", everything else: one thread block a tile, element-wide loads and
    stores through a padded shared tile (the first version's kernel).

A wrapper runs its plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.  Each launch adds one to :data:`LAUNCHES`.
"""
from __future__ import annotations

import torch

from repro_torch.core.machine import H100_SXM
from repro_torch.kernels import _build

LAUNCHES = {"transpose": 0}
TRANSPOSE_ROUTES = {"A": 0, "B": 0}

# The tile edges csrc/transpose.cu instantiates (its BT_SMALL, BT_LARGE).
TILE_EDGES = H100_SXM.transpose_tiles

# transpose.cu's ROUTE_A / ROUTE_B.
_ROUTE_CODE = {"A": 0, "B": 1}
# Route A's ring (transpose.cu's A_STAGES, OUT_TILES, BOX_BYTES): tiles in
# flight a block, output tiles in shared memory, the widest box row.
RING_STAGES = 4
OUT_TILES = 2
BOX_BYTES = 128
# TMA's limit on a global stride, bytes.
TMA_STRIDE_LIMIT = 1 << 40

_LIB = None


def _lib():
    """The built ``transpose`` library, with its C signature declared."""
    global _LIB
    if _LIB is None:
        lib = _build.library("transpose")
        P, I, L = _build.P, _build.I, _build.L
        lib.transpose.argtypes = [P, P, I, I, I, L, L, I, I, I, P]
        lib.transpose.restype = I
        _LIB = lib
    return _LIB


def _source(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernel reads it: unit column stride (else a
    contiguous copy), rows and batches at any larger stride."""
    return x if x.stride(-1) == 1 else x.contiguous()


def choose_route(dtype, rows: int, cols: int, strides, data_ptr: int) -> str:
    """The route of one :func:`transpose_tiles` call on a source of
    ``dtype`` with element strides ``(batch, row, column)`` at ``data_ptr``
    (transpose.cu's ``route_a_ok`` mirrors it): "A" for an element of 1,
    2, 4 or 8 bytes at a 16-byte aligned base, with unit column stride,
    row and batch strides and an output row (``rows`` elements) of whole
    16-byte units, strides under TMA's 2^40 bytes; else "B"."""
    e = dtype.itemsize
    bstride, rstride, cstride = strides
    ok = (e in (1, 2, 4, 8) and data_ptr % 16 == 0 and cstride == 1
          and rstride * e % 16 == 0 and bstride * e % 16 == 0
          and rows * e % 16 == 0
          and max(rstride, bstride, rows * cols) * e < TMA_STRIDE_LIMIT)
    return "A" if ok else "B"


def box_row(elem: int, bt: int) -> int:
    """Bytes of one box row of route A's ring: ``bt`` elements, at most
    :data:`BOX_BYTES` (so 32, 64 or 128, in the swizzle of that width)."""
    return min(elem * bt, BOX_BYTES)


def ring_smem_bytes(elem: int, bt: int) -> int:
    """Route A's dynamic shared memory (transpose.cu's ``a_smem``): 1024
    bytes of alignment slack, :data:`RING_STAGES` staged tiles and
    :data:`OUT_TILES` output tiles of ``bt * bt`` elements, an mbarrier
    a stage."""
    return 1024 + (RING_STAGES + OUT_TILES) * elem * bt * bt \
        + RING_STAGES * 8


def walk_tile(t: int, ti: int, tj: int):
    """Tile ``t`` of route A's walk (transpose.cu's ``a_tile``) over a
    batch of ``ti`` row tiles and ``tj`` column tiles: ``(b, i, j)``,
    batch by batch, row tile by row tile, the column tile fastest (the
    tiles in flight read whole source rows)."""
    b, u = divmod(t, ti * tj)
    i, j = divmod(u, tj)
    return b, i, j


def route_a_walk(nb: int, rows: int, cols: int, bt: int, blocks: int):
    """The tiles each of route A's ``blocks`` persistent blocks walks, in
    order: block k takes tiles k, k + blocks, ... of :func:`walk_tile`."""
    ti, tj = -(-rows // bt), -(-cols // bt)
    tiles = nb * ti * tj
    return [[walk_tile(t, ti, tj) for t in range(k, tiles, blocks)]
            for k in range(min(blocks, tiles))]


def transpose_tiles(x: torch.Tensor, *, bt: int) -> torch.Tensor:
    """One launch: ``x (nb, rows, cols)`` -> contiguous ``(nb, cols,
    rows)``."""
    if x.ndim != 3:
        raise ValueError(f"expected (nb, rows, cols), got {tuple(x.shape)}")
    if bt < 1:
        raise ValueError(f"tile edge must be positive, got {bt}")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise RuntimeError(f"no transpose kernel for device {x.device}")
        return transpose_plain(x, bt=bt)
    if bt not in TILE_EDGES:
        raise NotImplementedError(f"the CUDA transpose takes tile edges "
                                  f"{TILE_EDGES}, got {bt}; plan with the "
                                  f"H100_SXM machine model")
    nb, rows, cols = x.shape
    src = _source(x)
    # A single batch's stride is never stepped: the kernel takes the one
    # its rows imply.
    strides = (src.stride(0) if nb > 1 else rows * src.stride(1),
               src.stride(1), src.stride(2))
    route = choose_route(x.dtype, rows, cols, strides, src.data_ptr())
    out = torch.empty((nb, cols, rows), dtype=x.dtype, device=x.device)
    status = _lib().transpose(
        _build.ptr(src), _build.ptr(out), nb, rows, cols, strides[1],
        strides[0], bt, x.element_size(), _ROUTE_CODE[route],
        _build.stream_ptr(x))
    _build.check(status, "transpose")
    LAUNCHES["transpose"] += 1
    TRANSPOSE_ROUTES[route] += 1
    return out


def transpose_plain(x: torch.Tensor, *, bt: int) -> torch.Tensor:
    """The kernel's blocked copy in torch, one strip of ``bt`` source rows
    at a time (every tile of the strip at once), reading only the logical
    extent."""
    nb, rows, cols = x.shape
    out = torch.empty((nb, cols, rows), dtype=x.dtype, device=x.device)
    for r0 in range(0, rows, bt):
        out[:, :, r0:r0 + bt] = x[:, r0:r0 + bt, :].transpose(1, 2)
    return out


def reset_launches() -> None:
    for counts in (LAUNCHES, TRANSPOSE_ROUTES):
        for name in counts:
            counts[name] = 0
