"""The schedule layer: tile tables the fused single-launch kernels walk.

  * :class:`TileSchedule` -- the flattening of a dense GEMM region cover:
    per-tile ownership rectangles plus clamped window origins;
  * :class:`FlashTileSchedule` -- the flattened (q-block, k-block) walk
    of one flash-attention problem, with causal k-blocks above the
    diagonal dropped at plan time;
  * :func:`pack_table` -- int32 packing of tile rows (the CUDA kernels
    read one row per thread block);
  * :func:`plan_launches` -- kernel launches one plan's lowering emits.

Two contracts carry over from the reference unchanged: every output
element is owned by exactly one tile, and causal-masked tiles never
reach a kernel.  Tables are computed on the host with plain Python and
uploaded once per plan by the kernel executors.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


def ceil_div(a: int, b: int) -> int:
    """Ceiling division on Python ints."""
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    """Round ``a`` up to the nearest multiple of ``b``."""
    return ceil_div(a, b) * b


# Channel-block width of the reference's per-tile quant scales.  The
# quant axis is not ported, but every tile row still carries its
# ``scale_idx`` column so the tables stay equal to the reference's.
QUANT_TILE = 128


@dataclasses.dataclass(frozen=True)
class TileSchedule:
    """Flattened tile schedule of one dense region cover.

    ``blocks`` are the distinct effective block geometries (region blocks
    clamped to the matrix); each tile row is

        (row0, col0, row_end, col_end, row_start, col_start, block_id,
         scale_idx)

    where ``[row0, row_end) x [col0, col_end)`` are the C elements the
    tile owns and ``(row_start, col_start)`` is the clamped origin of its
    fixed-shape window: edge windows slide inward, and the ownership mask
    keeps each element owned by exactly one tile.
    """

    m: int
    n: int
    k: int
    bk: int
    k_steps: int
    blocks: Tuple[Tuple[int, int], ...]
    tiles: Tuple[Tuple[int, int, int, int, int, int, int, int], ...]

    @property
    def num_tiles(self) -> int:
        return len(self.tiles)

    def validate(self):
        """Every C element owned by exactly one tile mask."""
        owned = 0
        for row0, col0, row_end, col_end, rs, cs, bid, sidx in self.tiles:
            bm_e, bn_e = self.blocks[bid]
            assert 0 <= rs and rs + bm_e <= self.m, (rs, bm_e, self.m)
            assert 0 <= cs and cs + bn_e <= self.n, (cs, bn_e, self.n)
            assert rs <= row0 and row_end <= rs + bm_e
            assert cs <= col0 and col_end <= cs + bn_e
            assert sidx == rs // QUANT_TILE, (sidx, rs)
            owned += (row_end - row0) * (col_end - col0)
        assert owned == self.m * self.n, (owned, self.m * self.n)
        return True


def flatten_regions(m: int, n: int, k: int, bk: int,
                    regions: Sequence) -> TileSchedule:
    """Flatten a region cover into the fused kernel's tile table.

    ``regions`` are objects with ``row0/col0/rows/cols`` ownership
    rectangles and ``bm/bn`` block geometry.  Blocks are clamped to the
    matrix (``bm_e = min(bm, m)``) and walk their region with the
    effective stride, so raggedness is absorbed by the ownership mask.
    """
    bk = max(1, min(bk, k))
    blocks: List[Tuple[int, int]] = []
    ids = {}
    tiles = []
    for r in regions:
        bm_e, bn_e = min(r.bm, m), min(r.bn, n)
        bid = ids.get((bm_e, bn_e))
        if bid is None:
            bid = ids[(bm_e, bn_e)] = len(blocks)
            blocks.append((bm_e, bn_e))
        for i in range(ceil_div(r.rows, bm_e)):
            row0 = r.row0 + i * bm_e
            row_end = min(row0 + bm_e, r.row0 + r.rows)
            for j in range(ceil_div(r.cols, bn_e)):
                col0 = r.col0 + j * bn_e
                col_end = min(col0 + bn_e, r.col0 + r.cols)
                rs = min(row0, m - bm_e)
                tiles.append((row0, col0, row_end, col_end,
                              rs, min(col0, n - bn_e),
                              bid, rs // QUANT_TILE))
    return TileSchedule(m=m, n=n, k=k, bk=bk, k_steps=ceil_div(k, bk),
                        blocks=tuple(blocks), tiles=tuple(tiles))


def pack_table(rows: Sequence[Sequence[int]]) -> np.ndarray:
    """Pack tile rows into an int32 ``(tiles, width)`` table."""
    table = np.asarray(rows, dtype=np.int32)
    assert table.ndim == 2, table.shape
    return table


@dataclasses.dataclass(frozen=True)
class FlashTileSchedule:
    """Flattened (q-block, k-block) walk of one flash attention problem.

    Tiles are ordered q-block-major, each q-block's k-blocks contiguous
    and ascending, so the online-softmax carry threads through a q-block's
    run of rows: reset at ``first``, drained at ``last``.  Each row is
    ``(q0, q_end, qs, k0, k_end, ks, first, last)``: ``[q0, q_end)`` the
    owned query rows, ``qs``/``ks`` the clamped window origins, ``[k0,
    k_end)`` the key columns the tile contributes.
    """

    sq: int
    sk: int
    bq: int
    bk: int
    causal: bool
    tiles: Tuple[Tuple[int, int, int, int, int, int, int, int], ...]

    @property
    def num_tiles(self) -> int:
        return len(self.tiles)

    @property
    def dense_tiles(self) -> int:
        return ceil_div(self.sq, self.bq) * ceil_div(self.sk, self.bk)

    @property
    def num_q_blocks(self) -> int:
        return ceil_div(self.sq, self.bq)

    def q_block_index(self) -> np.ndarray:
        """``(num_q_blocks, 2)`` int32 ``(row_start, row_count)``: each
        q-block's contiguous run of table rows.  One CUDA thread block
        walks one run."""
        runs = []
        for i, tile in enumerate(self.tiles):
            if tile[6]:
                runs.append([i, 0])
            runs[-1][1] += 1
        return np.asarray(runs, dtype=np.int32)

    def validate(self):
        """Every query row drained exactly once; every kept tile's k
        range in bounds, non-empty and causal-reachable; carry flags
        bracket each q-block's contiguous k walk."""
        drained = np.zeros(self.sq, dtype=np.int64)
        open_q = None
        prev_k_end = 0
        for q0, q_end, qs, k0, k_end, ks, first, last in self.tiles:
            assert 0 <= qs and qs + self.bq <= self.sq, (qs, self.bq, self.sq)
            assert 0 <= ks and ks + self.bk <= self.sk, (ks, self.bk, self.sk)
            assert qs <= q0 and q_end <= qs + self.bq
            assert ks <= k0 and k_end <= ks + self.bk
            assert k0 < k_end <= self.sk
            if self.causal:
                assert k0 <= q_end - 1, (k0, q_end)
            if first:
                assert open_q is None, "carry re-opened before drain"
                open_q, prev_k_end = (q0, q_end), 0
            assert open_q == (q0, q_end), "tile outside the open carry"
            assert k0 == prev_k_end, "k walk not contiguous ascending"
            prev_k_end = k_end
            if last:
                drained[q0:q_end] += 1
                open_q = None
        assert open_q is None, "carry never drained"
        assert (drained == 1).all(), "query rows not drained exactly once"
        if self.causal and self.sq == self.sk and self.sq > self.bq + self.bk:
            assert self.num_tiles < self.dense_tiles
        return True


def flash_tile_schedule(sq: int, sk: int, bq: int, bk: int,
                        causal: bool) -> FlashTileSchedule:
    """Build the flattened causal-aware (q, k) tile walk.  For
    ``causal=True`` a k-block whose first column exceeds the q-block's
    last owned row is fully masked and never enters the table."""
    bq = max(1, min(bq, sq))
    bk = max(1, min(bk, sk))
    ck = ceil_div(sk, bk)
    tiles: List[Tuple[int, ...]] = []
    for qi in range(ceil_div(sq, bq)):
        q0 = qi * bq
        q_end = min(q0 + bq, sq)
        qs = min(q0, sq - bq)
        k_hi = min(ck, ceil_div(q_end, bk)) if causal else ck
        row = []
        for ki in range(k_hi):
            k0 = ki * bk
            row.append([q0, q_end, qs, k0, min(k0 + bk, sk),
                        min(k0, sk - bk), 0, 0])
        row[0][6] = 1
        row[-1][7] = 1
        tiles.extend(tuple(r) for r in row)
    return FlashTileSchedule(sq=sq, sk=sk, bq=bq, bk=bk, causal=causal,
                             tiles=tuple(tiles))


def plan_launches(plan, fused: bool) -> int:
    """Kernel launches one plan's lowering emits: 1 when fused, one per
    region for a multi-launch GEMM plan."""
    if fused:
        return 1
    regions = getattr(plan, "regions", None)
    return len(regions) if regions is not None else 1
