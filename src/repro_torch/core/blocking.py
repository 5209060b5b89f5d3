"""Blocking planners: GEMM region covers and flash tilings (paper §IV-B).

The paper's generator owns a *palette* of accumulator blockings and
covers a ragged C with a heterogeneous mix of them, minimising kernel
executions under predicate-masked edges (Fig 7).  ``plan_gemm`` does the
same against a :class:`~repro_torch.core.machine.MachineModel`: the
palette, the accumulator budget, the K-panel depth and fused legality
all come from the machine, so ``TPU_V5E`` reproduces the reference's
plans exactly and ``H100_SXM`` plans only the block shapes the CUDA
kernel instantiates.  The cost model is the reference's napkin math:
max(compute on issued MACs, memory traffic) plus per-step and per-launch
overheads, with the fused-versus-multi-launch terms.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from .descriptor import FlashBwdDescriptor, FlashDescriptor, GemmDescriptor
from .machine import DEFAULT_MACHINE, MachineModel, itemsize
from .schedule import (FlashTileSchedule, TileSchedule, ceil_div,
                       flash_tile_schedule, flatten_regions, round_up)


def palette(budget: Optional[int] = None,
            machine: MachineModel = DEFAULT_MACHINE,
            dtype: str = "float32") -> List[Tuple[int, int]]:
    """All legal (bm, bn) accumulator blockings under ``budget`` elements
    (default: the machine's accumulator budget)."""
    budget = machine.acc_budget_elems if budget is None else budget
    sub, lane = machine.reg_tile(dtype)
    return [(bm, bn) for bm in machine.bm_candidates if bm % sub == 0
            for bn in machine.bn_candidates
            if bn % lane == 0 and bm * bn <= budget]


@dataclasses.dataclass(frozen=True)
class Region:
    """A rectangular sub-block of C covered with a single blocking."""

    row0: int
    col0: int
    rows: int
    cols: int
    bm: int
    bn: int

    @property
    def grid(self) -> Tuple[int, int]:
        return (ceil_div(self.rows, self.bm), ceil_div(self.cols, self.bn))

    @property
    def num_microkernels(self) -> int:
        gm, gn = self.grid
        return gm * gn

    def issued_macs(self, k: int) -> int:
        gm, gn = self.grid
        return gm * self.bm * gn * self.bn * k


@dataclasses.dataclass(frozen=True)
class BlockingPlan:
    """Planned heterogeneous region cover of one GEMM descriptor: the
    regions, the K-panel depth ``bk`` and the ``fused`` lowering bit."""

    desc: GemmDescriptor
    regions: Tuple[Region, ...]
    bk: int
    heterogeneous: bool
    fused: bool = False

    def predicted_seconds(self, machine: MachineModel = DEFAULT_MACHINE) -> float:
        return _predict_seconds(self.regions, self.desc, self.bk, machine,
                                fused=self.fused)

    def tile_schedule(self) -> TileSchedule:
        """Flatten the region cover into the fused kernel's tile table."""
        d = self.desc
        return flatten_regions(d.m, d.n, d.k, self.bk, self.regions)

    def validate(self):
        """Every C element covered exactly once by the regions."""
        total = sum(r.rows * r.cols for r in self.regions)
        assert total == self.desc.m * self.desc.n, (
            f"cover mismatch: {total} vs {self.desc.m * self.desc.n}")
        rects = [(r.row0, r.col0, r.row0 + r.rows, r.col0 + r.cols)
                 for r in self.regions]
        for a in rects:
            assert 0 <= a[0] < a[2] <= self.desc.m
            assert 0 <= a[1] < a[3] <= self.desc.n
        for i in range(len(rects)):
            for j in range(i + 1, len(rects)):
                a, b = rects[i], rects[j]
                if not (a[2] <= b[0] or b[2] <= a[0] or a[3] <= b[1]
                        or b[3] <= a[1]):
                    raise AssertionError(f"regions overlap: {a} {b}")
        return True


def _predict_seconds(regions: Sequence[Region], desc: GemmDescriptor, bk: int,
                     machine: MachineModel, fused: bool = False) -> float:
    """Napkin-math time used to rank candidate plans: compute on issued
    MACs against memory traffic, plus per-step and per-launch overheads;
    the fused path adds per-step table decode and the output re-read, the
    multi-launch path pays extra launches and stitching traffic."""
    k = desc.k
    a_sz, b_sz = desc.a_wire_itemsize, desc.b_wire_itemsize
    out_sz = itemsize(desc.out_dtype)
    issued = sum(r.issued_macs(k) for r in regions)
    compute_s = 2.0 * issued / machine.peak(desc.compute_dtype)
    traffic = sum(r.num_microkernels * (r.bm * a_sz + r.bn * b_sz) * k
                  for r in regions)
    out_elems = sum(r.rows * r.cols for r in regions)
    traffic += out_elems * out_sz * (2 if desc.accumulate else 1)
    memory_s = traffic / machine.hbm_bw
    steps = sum(r.num_microkernels for r in regions) * ceil_div(k, bk)
    launches = 1 if fused else len(regions)
    launch_s = machine.launch_overhead_s * (
        1 + (launches - 1) * machine.extra_launch_factor)
    stitch_s = 0.0
    fused_s = 0.0
    if fused:
        fused_s = (steps * machine.fused_tile_decode_s
                   + out_elems * out_sz / machine.hbm_bw)
    elif len(regions) > 1:
        stitch_bytes = sum((r.rows * a_sz + r.cols * b_sz) * k
                           for r in regions)
        stitch_bytes += 2 * out_elems * out_sz
        stitch_s = machine.stitch_discount * stitch_bytes / machine.hbm_bw
    return (max(compute_s, memory_s) + steps * machine.step_overhead_s
            + launch_s + stitch_s + fused_s)


def _pick_bk(desc: GemmDescriptor, bm: int, bn: int,
             machine: MachineModel) -> int:
    """K-panel depth: the kernel's fixed panel where it has one, else the
    largest aligned bk whose double-buffered blocks fit half of VMEM."""
    if machine.k_panel is not None:
        return machine.k_panel
    acc_bytes = bm * bn * 4
    budget = machine.vmem_bytes // 2 - acc_bytes
    if budget <= 0:
        return machine.lanes
    bk_max = budget // (2 * (desc.a_wire_itemsize * bm
                             + desc.b_wire_itemsize * bn))
    _, lane = machine.reg_tile(desc.in_dtype)
    bk = max(lane, (bk_max // lane) * lane)
    return min(bk, round_up(desc.k, lane), 2048)


def fused_legal(desc: GemmDescriptor,
                machine: MachineModel = DEFAULT_MACHINE) -> bool:
    """Can this GEMM run as one fused launch?  On a machine whose fused
    kernel stages whole operands on chip, only when they fit; a kernel
    that streams from device memory takes every problem."""
    if not machine.stages_whole_operands:
        return True
    out_sz = itemsize(desc.out_dtype)
    need = (desc.m * desc.k * desc.a_wire_itemsize
            + desc.k * desc.n * desc.b_wire_itemsize)
    need += desc.m * desc.n * out_sz * (2 if desc.accumulate else 1)
    need += machine.acc_budget_elems * 4
    return need <= machine.vmem_bytes


def plan_gemm(desc: GemmDescriptor,
              machine: MachineModel = DEFAULT_MACHINE,
              budget: Optional[int] = None,
              heterogeneous: bool = True,
              force_block: Optional[Tuple[int, int]] = None) -> BlockingPlan:
    """Produce the blocking plan for one GEMM descriptor.

    ``heterogeneous=False`` is the paper's baseline (one blocking tiles
    the whole matrix); ``force_block`` pins the primary blocking.
    """
    m, n = desc.m, desc.n
    shapes = palette(budget, machine, desc.in_dtype)
    fused = fused_legal(desc, machine)
    primary = force_block if force_block is not None else \
        _best_homogeneous(m, n, shapes, desc, machine)

    if not heterogeneous:
        regions = (Region(0, 0, m, n, *primary),)
        return BlockingPlan(desc, regions, _pick_bk(desc, *primary, machine),
                            heterogeneous=False, fused=fused)

    regions = _heterogeneous_cover(m, n, primary, shapes)
    bk = _pick_bk(desc, *primary, machine)
    plan = BlockingPlan(desc, tuple(regions), bk,
                        heterogeneous=len(regions) > 1, fused=fused)
    homo = BlockingPlan(desc, (Region(0, 0, m, n, *primary),), bk, False,
                        fused=fused)
    if homo.predicted_seconds(machine) < plan.predicted_seconds(machine):
        plan = homo
    # Multi-region covers pay the fused walk's per-step decode on every
    # region's tiles: compare both lowerings under the model.
    if plan.fused and len(plan.regions) > 1:
        multi = dataclasses.replace(plan, fused=False)
        if multi.predicted_seconds(machine) < plan.predicted_seconds(machine):
            plan = multi
    return plan


def _best_homogeneous(m: int, n: int, shapes, desc, machine) -> Tuple[int, int]:
    best, best_t = None, float("inf")
    for bm, bn in shapes:
        region = Region(0, 0, m, n, bm, bn)
        t = _predict_seconds([region], desc, _pick_bk(desc, bm, bn, machine),
                             machine)
        if t < best_t:
            best, best_t = (bm, bn), t
    assert best is not None
    return best


def _strip_block(extent_major: int, shapes, major_axis: int) -> Tuple[int, int]:
    """Palette block for an edge strip: the smallest edge covering the
    strip's thickness and the largest perpendicular edge."""
    thick_opts = sorted({s[major_axis] for s in shapes})
    cover = [t for t in thick_opts if t >= extent_major]
    thickness = cover[0] if cover else thick_opts[-1]
    span = max(s[1 - major_axis] for s in shapes if s[major_axis] == thickness)
    return (thickness, span) if major_axis == 0 else (span, thickness)


def _heterogeneous_cover(m, n, primary, shapes) -> List[Region]:
    bm0, bn0 = primary
    m_full, n_full = m // bm0, n // bn0
    mi, ni = m_full * bm0, n_full * bn0
    regions: List[Region] = []
    if m_full and n_full:
        regions.append(Region(0, 0, mi, ni, bm0, bn0))
    rem_m, rem_n = m - mi, n - ni
    if rem_m and ni:
        regions.append(Region(mi, 0, rem_m, ni,
                              *_strip_block(rem_m, shapes, major_axis=0)))
    if rem_n and mi:
        regions.append(Region(0, ni, mi, rem_n,
                              *_strip_block(rem_n, shapes, major_axis=1)))
    if rem_m and rem_n:
        regions.append(Region(mi, ni, rem_m, rem_n,
                              *_corner_block(rem_m, rem_n, shapes)))
    if not regions:  # matrix smaller than every block
        regions.append(Region(0, 0, m, n, *_corner_block(m, n, shapes)))
    return regions


def _corner_block(rows, cols, shapes) -> Tuple[int, int]:
    """Smallest palette block covering the (masked) corner."""
    return min(shapes, key=lambda s: (ceil_div(rows, s[0]) * ceil_div(cols, s[1]),
                                      s[0] * s[1]))


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

def _tile_candidates(extent: int, align: int, lo: int = 64,
                     hi: int = 1024) -> List[int]:
    """Aligned power-of-two tile edges covering [lo, hi], clipped to extent."""
    cands = set()
    t = lo
    while t <= hi:
        cands.add(min(t, round_up(extent, align)) if t >= extent else t)
        t *= 2
    return sorted(c for c in cands if c % align == 0 or c >= extent)


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """Planned (block_q, block_k) tiling of one flash descriptor; ``fused``
    selects the scheduled single-launch lowering over the causal-aware
    tile table, else the dense-grid kernel."""

    desc: FlashDescriptor
    block_q: int
    block_k: int
    fused: bool = False

    def tile_schedule(self) -> FlashTileSchedule:
        d = self.desc
        return flash_tile_schedule(d.sq, d.sk, self.block_q, self.block_k,
                                   d.causal)

    def predicted_seconds(self, machine: MachineModel = DEFAULT_MACHINE) -> float:
        return _predict_flash_seconds(self.desc, self.block_q, self.block_k,
                                      machine, fused=self.fused)


def flash_fused_legal(desc: FlashDescriptor,
                      machine: MachineModel = DEFAULT_MACHINE) -> bool:
    """Can this flash attention run as one scheduled launch?  A kernel that
    stages whole batch-head slices on chip needs them to fit half of it; a
    streaming kernel takes every problem."""
    if not machine.stages_whole_operands:
        return True
    need = (2 * desc.sq + 2 * desc.sk) * desc.d * itemsize(desc.dtype)
    return need <= machine.vmem_bytes // 2


def _predict_flash_seconds(desc: FlashDescriptor, bq: int, bk: int,
                           machine: MachineModel,
                           fused: bool = False) -> float:
    """Napkin-math time of one flash tiling (both lowerings)."""
    cq, ck = ceil_div(desc.sq, bq), ceil_div(desc.sk, bk)
    if desc.causal:
        active = sum(min(ck, ceil_div((qi + 1) * bq, bk)) for qi in range(cq))
    else:
        active = cq * ck
    steps = desc.batch_heads * (active if fused else cq * ck)
    issued = 4 * desc.batch_heads * active * bq * bk * desc.d
    compute_s = issued / machine.peak(desc.dtype)
    isz = itemsize(desc.dtype)
    if fused:
        traffic = desc.in_bytes + desc.out_bytes
    else:
        traffic = desc.batch_heads * active * 2 * bk * desc.d * isz
        traffic += desc.batch_heads * cq * bq * desc.d * isz
        traffic += desc.out_bytes
    memory_s = traffic / machine.hbm_bw
    return (max(compute_s, memory_s) + steps * machine.step_overhead_s
            + machine.launch_overhead_s)


def _flash_legal(desc: FlashDescriptor,
                 machine: MachineModel) -> List[Tuple[int, int]]:
    """All legal (block_q, block_k) pairs for one flash descriptor: the
    kernel's own shapes where it lists them, else every VMEM fit."""
    if machine.flash_blocks is not None:
        return list(machine.flash_blocks)
    sub, lane = machine.reg_tile(desc.dtype)
    isz = itemsize(desc.dtype)
    legal = []
    for bq in _tile_candidates(desc.sq, sub):
        for bk in _tile_candidates(desc.sk, lane):
            vmem = (bq * desc.d + 2 * 2 * bk * desc.d) * isz
            vmem += (bq * bk + 2 * bq + bq * desc.d) * 4
            if vmem <= machine.vmem_bytes // 2:
                legal.append((bq, bk))
    if not legal:
        legal.append((sub, lane))
    return legal


def plan_flash(desc: FlashDescriptor,
               machine: MachineModel = DEFAULT_MACHINE) -> FlashPlan:
    """Pick (block_q, block_k) from the legal set by the cost model;
    fused whenever :func:`flash_fused_legal` allows."""
    fused = flash_fused_legal(desc, machine)
    best = min(_flash_legal(desc, machine),
               key=lambda s: _predict_flash_seconds(desc, *s, machine=machine,
                                                    fused=fused))
    return FlashPlan(desc, *best, fused=fused)


def flash_bwd_fused_legal(desc: FlashBwdDescriptor,
                          machine: MachineModel = DEFAULT_MACHINE) -> bool:
    """Can this flash backward run as one scheduled launch?  A kernel that
    stages whole batch-head slices needs q/k/v/o/do, dq, the fp32 dk/dv
    and the LSE row to fit half of its fast memory; a streaming kernel
    takes every problem."""
    if not machine.stages_whole_operands:
        return True
    isz = itemsize(desc.dtype)
    need = (3 * desc.sq + 2 * desc.sk) * desc.d * isz  # q/o/do + k/v
    need += desc.sq * desc.d * isz                     # dq
    need += 2 * desc.sk * desc.d * 4                   # dk/dv, fp32
    need += desc.sq * 4                                # lse row
    return need <= machine.vmem_bytes // 2


def plan_flash_bwd(desc: FlashBwdDescriptor,
                   machine: MachineModel = DEFAULT_MACHINE) -> FlashPlan:
    """Plan the flash backward walk: the forward's (block_q, block_k)
    search -- the backward walks the same causal-pruned table -- gated by
    :func:`flash_bwd_fused_legal`."""
    fused = flash_bwd_fused_legal(desc, machine)
    best = min(_flash_legal(desc, machine),
               key=lambda s: _predict_flash_seconds(desc, *s, machine=machine,
                                                    fused=fused))
    return FlashPlan(desc, *best, fused=fused)
