"""The schedule layer: tile tables the fused single-launch kernels walk.

  * :class:`TileSchedule` -- the flattening of a dense GEMM region cover:
    per-tile ownership rectangles plus clamped window origins;
  * :class:`FlashTileSchedule` -- the flattened (q-block, k-block) walk
    of one flash-attention problem, with causal k-blocks above the
    diagonal dropped at plan time;
  * :class:`GroupedTileSchedule` -- the ragged row blocks of a grouped
    GEMM: its tables are runtime data, built on the device from the
    router's group sizes;
  * :class:`DecodeTileSchedule` -- one continuous-batching decode step
    over a paged KV pool: its tables are runtime data, built on the
    device from this step's block tables and lengths;
  * :func:`pack_table` -- int32 packing of tile rows (the CUDA kernels
    read one row per thread block);
  * :func:`plan_launches` -- kernel launches one plan's lowering emits.

Two contracts carry over from the reference unchanged: every output
element is owned by exactly one tile, and causal-masked tiles never
reach a kernel.  GEMM and flash tables are computed on the host with
plain Python and uploaded once per plan by the kernel executors; grouped
and decode tables are torch ops on the device, with no host sync.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch


def ceil_div(a: int, b: int) -> int:
    """Ceiling division on Python ints."""
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    """Round ``a`` up to the nearest multiple of ``b``."""
    return ceil_div(a, b) * b


# Channel-block width of the per-tile quant scales (``per_tile`` scheme,
# ``repro_torch.optim.compression``).  Every tile row carries its
# ``scale_idx`` column, as the reference's tables do; the kernels take
# dense expanded scale vectors and do not read it.
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

    @property
    def num_k_blocks(self) -> int:
        return ceil_div(self.sk, self.bk)

    def k_block_index(self) -> Tuple[np.ndarray, np.ndarray]:
        """The k-block-major counterpart of :meth:`q_block_index`, in CSR
        form: ``offsets`` (``(num_k_blocks + 1,)`` int32) and ``rows``
        (int32 table-row ids) such that ``rows[offsets[j]:offsets[j+1]]``
        are the rows whose key columns are k-block ``j``, ascending.  One
        CUDA thread block of the backward walks one k-block's rows and
        owns its dK/dV rows; a causal k-block no query reaches has none."""
        per_block = [[] for _ in range(self.num_k_blocks)]
        for i, tile in enumerate(self.tiles):
            per_block[tile[3] // self.bk].append(i)
        offsets = np.cumsum([0] + [len(r) for r in per_block])
        rows = [i for r in per_block for i in r]
        return (offsets.astype(np.int32), np.asarray(rows, dtype=np.int32))

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


# ---------------------------------------------------------------------------
# Ragged (grouped) tile schedules -- runtime tables, static geometry
# ---------------------------------------------------------------------------

# Tile states in the grouped table's ``state`` column.
TILE_SKIP = 0     # beyond the active tile count: no work
TILE_COMPUTE = 1  # owns rows of one expert: accumulate and store
TILE_ZERO = 2     # owns rows past sum(group_sizes): store zeros


@dataclasses.dataclass(frozen=True)
class GroupedTileSchedule:
    """Schedule of a ragged row partition (the grouped GEMM).

    The geometry (blocks, grid extents, the static ``max_tiles`` bound) is
    fixed by the descriptor and plan; the tables are data: the router
    decides ``group_sizes`` per call, so each expert's row blocks are
    computed by device ops (:meth:`tables`), with no host sync, no padded
    intermediate and no gather-back.

    Each table row is ``(row0, row_end, row_start, expert, state)``:
    ``[row0, row_end)`` are the x/out rows the tile owns, ``row_start``
    the clamped origin of a fixed ``bm``-row window (the reference's
    kernels read that window; the CUDA kernels address rows element by
    element from ``row0``), ``expert`` selects the weight and bias panel,
    and ``state`` marks the tile compute / zero-fill (rows past
    ``sum(group_sizes)``) / skip.
    """

    t: int
    k: int
    n: int
    num_experts: int
    bm: int
    bk: int
    bn: int

    def __post_init__(self):
        assert self.bm <= self.t and self.bn <= self.n and self.bk <= self.k

    @property
    def max_tiles(self) -> int:
        """Static row-tile bound: every expert may add one partial block,
        plus the zero-fill tail region."""
        return ceil_div(self.t, self.bm) + self.num_experts + 1

    @property
    def k_steps(self) -> int:
        return ceil_div(self.k, self.bk)

    @property
    def n_steps(self) -> int:
        return ceil_div(self.n, self.bn)

    def tables(self, group_sizes: torch.Tensor) -> torch.Tensor:
        """The ``(max_tiles, 5)`` int32 tile table from the router's
        ``group_sizes``, on their device, without a host sync
        (``torch.searchsorted(..., right=True)`` is the reference's
        ``jnp.searchsorted(side="right")``).  Rows past
        ``sum(group_sizes)`` form a zero-fill pseudo-group, so the tiles
        cover every output row exactly once."""
        bm, t, e = self.bm, self.t, self.num_experts
        dev = group_sizes.device
        sizes = group_sizes.long()
        tail = t - sizes.sum()
        all_sizes = torch.cat([sizes, tail[None]])                 # (E+1,)
        zero = torch.zeros(1, dtype=torch.long, device=dev)
        all_off = torch.cat([zero, torch.cumsum(all_sizes, 0)])    # (E+2,)
        nblocks = (all_sizes + bm - 1) // bm                       # (E+1,)
        bstart = torch.cat([zero, torch.cumsum(nblocks, 0)])       # (E+2,)
        g = torch.arange(self.max_tiles, dtype=torch.long, device=dev)
        # Which (pseudo-)group owns tile g; empty groups own no tiles.
        owner = torch.clamp(torch.searchsorted(bstart, g, right=True) - 1,
                            0, e)
        local = g - bstart[owner]
        row0 = all_off[owner] + local * bm
        row_end = torch.minimum(row0 + bm, all_off[owner] + all_sizes[owner])
        active = g < bstart[-1]
        row0 = torch.where(active, row0, t)
        row_end = torch.where(active, row_end, t)
        rs = torch.clamp_min(torch.clamp_max(row0, t - bm), 0)
        expert = torch.clamp_max(owner, e - 1)  # always a legal panel index
        state = torch.where(
            active & (row_end > row0),
            torch.where(owner < e, TILE_COMPUTE, TILE_ZERO), TILE_SKIP)
        return torch.stack([row0, row_end, rs, expert, state],
                           dim=1).to(torch.int32)

    def validate_tables(self, table, group_sizes) -> bool:
        """Property check on one concrete table (tests): every output row
        owned by exactly one tile, windows in bounds, experts consistent."""
        table = np.asarray(table)
        sizes = np.asarray(group_sizes, dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        assert table.shape == (self.max_tiles, 5), table.shape
        assert table.dtype == np.int32, table.dtype
        owner_of = np.full(self.t, -1, dtype=np.int64)
        for row0, row_end, rs, expert, state in table:
            if state == TILE_SKIP:
                assert row0 == row_end, (row0, row_end)
                continue
            assert 0 <= rs and rs + self.bm <= self.t, (rs, self.bm, self.t)
            assert rs <= row0 and row_end <= rs + self.bm
            assert 0 <= expert < self.num_experts
            assert (owner_of[row0:row_end] == -1).all(), "row owned twice"
            owner_of[row0:row_end] = expert if state == TILE_COMPUTE else -2
            if state == TILE_COMPUTE:
                # owned rows really belong to that expert
                assert offsets[expert] <= row0
                assert row_end <= offsets[expert + 1]
            else:  # TILE_ZERO: rows past the ragged total
                assert row0 >= offsets[-1]
        assert (owner_of != -1).all(), "uncovered output rows"
        return True


# ---------------------------------------------------------------------------
# Paged decode tile schedules -- runtime tables over live KV pages
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecodeTileSchedule:
    """Schedule of one continuous-batching decode step over a paged KV pool.

    The geometry (slots, pool size, page size, block-table width and the
    static ``max_tiles`` bound) is fixed when the pool is built; the
    tables are data, computed each step from ``(block_tables, lengths)``
    by device ops, so a churning batch never rebuilds anything.

    Each table row is ``(seq, page, k_len, first, last)``: query row
    ``seq`` against pool page ``page``, of which the first ``k_len`` slots
    are live, with ``first``/``last`` bracketing the slot's contiguous page
    walk for the online-softmax carry.  A slot always owns at least one
    row: an empty (length-0 / inactive) slot gets one fully-masked row, so
    its carry still initialises and drains (to zeros).  Slot ``s``'s rows
    are ``[bstart[s], bstart[s + 1])``: one CUDA thread block per (slot,
    KV head) walks them.
    """

    num_seqs: int    # decode slots (pool block-table rows)
    pages: int       # pool size in pages
    page_size: int   # KV slots per page
    max_blocks: int  # block-table width: max pages one sequence may own

    def __post_init__(self):
        assert self.num_seqs > 0 and self.pages > 0
        assert self.page_size > 0 and self.max_blocks > 0

    @property
    def max_tiles(self) -> int:
        """Static tile bound: live pages are exclusively owned, so at most
        ``pages`` compute rows exist pool-wide (never more than
        ``num_seqs * max_blocks``), plus one dummy row per slot."""
        return min(self.num_seqs * self.max_blocks, self.pages) \
            + self.num_seqs

    @property
    def max_len(self) -> int:
        """Longest sequence the block tables can map."""
        return self.max_blocks * self.page_size

    def tables_and_offsets(self, block_tables: torch.Tensor,
                           lengths: torch.Tensor):
        """``(table, bstart)``: the ``(max_tiles, 5)`` int32 tile table and
        the ``(num_seqs + 1,)`` int32 row offsets of each slot's run, from
        this step's ``block_tables`` ``(num_seqs, max_blocks)`` and
        ``lengths`` ``(num_seqs,)``, on their device, without a host sync
        (``torch.searchsorted(..., right=True)`` is the reference's
        ``jnp.searchsorted(side="right")``)."""
        P, S = self.page_size, self.num_seqs
        dev = lengths.device
        lengths = lengths.long()
        # ceil(len / P) live pages per slot, floored at one (dummy) row.
        nblocks = torch.clamp_min((lengths + P - 1) // P, 1)       # (S,)
        bstart = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                            torch.cumsum(nblocks, 0)])             # (S+1,)
        g = torch.arange(self.max_tiles, dtype=torch.long, device=dev)
        seq = torch.clamp(torch.searchsorted(bstart, g, right=True) - 1,
                          0, S - 1)
        local = g - bstart[seq]
        active = g < bstart[-1]
        lcl = torch.clamp(local, 0, self.max_blocks - 1)
        page = torch.clamp(block_tables.long()[seq, lcl], 0, self.pages - 1)
        k_len = torch.clamp(lengths[seq] - local * P, 0, P)
        first = active & (local == 0)
        last = active & (local == nblocks[seq] - 1)
        zero = torch.zeros_like(page)
        table = torch.stack([seq, torch.where(active, page, zero),
                             torch.where(active, k_len, zero),
                             first.long(), last.long()], dim=1)
        return table.to(torch.int32), bstart.to(torch.int32)

    def tables(self, block_tables: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
        """The ``(max_tiles, 5)`` int32 tile table alone (the reference's
        ``DecodeTileSchedule.tables``)."""
        return self.tables_and_offsets(block_tables, lengths)[0]

    def validate_tables(self, table, block_tables, lengths) -> bool:
        """Property check on one concrete table (tests): every slot's live
        pages visited exactly once, in block-table order, with correct
        tail lengths and carry flags; inactive tail rows inert."""
        table = np.asarray(table)
        bt = np.asarray(block_tables)
        lengths = np.asarray(lengths, dtype=np.int64)
        P = self.page_size
        assert table.shape == (self.max_tiles, 5), table.shape
        assert table.dtype == np.int32, table.dtype
        nblocks = np.maximum(-(-lengths // P), 1)
        total = int(nblocks.sum())
        assert total <= self.max_tiles, (total, self.max_tiles)
        visited = {}  # seq -> list of (page, k_len)
        open_seq = None
        for i, (seq, page, k_len, first, last) in enumerate(table):
            if i >= total:  # inactive tail: inert rows, legal indices only
                assert first == 0 and last == 0 and k_len == 0, table[i]
                assert 0 <= seq < self.num_seqs and 0 <= page < self.pages
                continue
            assert 0 <= seq < self.num_seqs and 0 <= page < self.pages
            if first:
                assert open_seq is None, "carry re-opened before drain"
                open_seq = seq
                visited.setdefault(int(seq), [])
            assert open_seq == seq, "row outside the open carry"
            visited[int(seq)].append((int(page), int(k_len)))
            if last:
                open_seq = None
        assert open_seq is None, "carry never drained"
        for s in range(self.num_seqs):
            walk = visited.get(s, [])
            n, length = int(nblocks[s]), int(lengths[s])
            assert len(walk) == n, (s, walk, n)
            pages_seen = [p for p, _ in walk]
            if length > 0:
                expect = [int(bt[s, j]) for j in range(n)]
                assert pages_seen == expect, (s, pages_seen, expect)
                assert len(set(pages_seen)) == n, "page visited twice"
            assert sum(kl for _, kl in walk) == length, (s, walk, length)
            for j, (_, kl) in enumerate(walk):
                want = min(max(length - j * P, 0), P)
                assert kl == want, (s, j, kl, want)
        return True
