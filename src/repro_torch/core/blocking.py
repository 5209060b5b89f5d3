"""Blocking planners: GEMM region covers, flash tilings, the grouped-GEMM
tilings, the SSD scan plans and the transpose tile edge (paper §IV-B).

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

Every plan carries ``plan_source``: ``"model"`` from a planner here,
``"autotuned"`` for a timed winner (fresh or replayed from a tuning
cache).  :func:`candidate_plans` ranks every plan the machine allows by the
same cost model, for the autotuner to time.

A descriptor with a :class:`~repro_torch.core.descriptor.MeshSpec` is the
global problem with its weight sharded over a mesh axis.  It is planned
once per strategy of :data:`MESH_STRATEGIES` on that strategy's per-shard
local descriptor, and the communication it issues is charged through
``MachineModel.collective_seconds``; the cheaper total wins and is
recorded in the plan's ``comm``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from .descriptor import (BIAS_EPILOGUES, FlashBwdDescriptor,
                         FlashDecodeDescriptor, FlashDescriptor,
                         GemmDescriptor, GroupedGemmBwdDescriptor,
                         GroupedGemmDescriptor, SsdChunkBwdDescriptor,
                         SsdChunkDescriptor, TransposeDescriptor)
from .machine import DEFAULT_MACHINE, MachineModel, itemsize
from .schedule import (DecodeTileSchedule, FlashTileSchedule,
                       GroupedTileSchedule, TileSchedule, ceil_div,
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
    # "model" (a planner's) or "autotuned" (a timed winner).
    plan_source: str = "model"
    # Mesh strategy, set only when desc.mesh is: "gathered" (all-gather the
    # sharded weight, compute the whole problem on each shard) or
    # "distributed" (keep the weight shards, move activations / outputs).
    # The regions and bk then describe the per-shard local problem
    # (``mesh_local_desc``), not the global descriptor.
    comm: Optional[str] = None

    def predicted_seconds(self, machine: MachineModel = DEFAULT_MACHINE) -> float:
        local, comm_s = self.desc, 0.0
        if self.desc.mesh is not None and self.comm is not None:
            local = mesh_local_desc(self.desc, self.comm)
            comm_s = mesh_comm_seconds(self.desc, machine, self.comm)
        return _predict_seconds(self.regions, local, self.bk, machine,
                                fused=self.fused) + comm_s

    def tile_schedule(self) -> TileSchedule:
        """Flatten the region cover into the fused kernel's tile table
        (for a mesh plan, the per-shard local problem's)."""
        d = self.desc
        if d.mesh is not None and self.comm is not None:
            d = mesh_local_desc(d, self.comm)
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


# ---------------------------------------------------------------------------
# Mesh communication model
# ---------------------------------------------------------------------------

MESH_STRATEGIES = ("gathered", "distributed")


def mesh_local_desc(desc, comm: str):
    """The per-shard local problem one strategy executes.

    grouped_gemm, activations token-sharded over the axis:
      * gathered: all-gather the expert weights, run the full expert set
        over the local token shard (t/s tokens, all E experts);
      * distributed: keep the weight shards, all_to_all the tokens to their
        expert's owner (t/s tokens, E/s local experts: capacity-uniform
        routing moves exactly the local rows).
    gemm, B column-sharded over the axis:
      * gathered: all-gather B, compute the whole (m, n) locally;
      * distributed: keep the B shard, compute (m, n/s), all-gather the
        output columns.
    """
    if desc.mesh is None:
        return desc
    if comm not in MESH_STRATEGIES:
        raise ValueError(f"unknown mesh strategy {comm!r}")
    s = desc.mesh.size
    if isinstance(desc, GroupedGemmDescriptor):
        if comm == "gathered":
            return dataclasses.replace(desc, t=desc.t // s, mesh=None)
        return dataclasses.replace(desc, t=desc.t // s,
                                   num_experts=desc.num_experts // s,
                                   mesh=None)
    if comm == "gathered":
        return dataclasses.replace(desc, mesh=None)
    return dataclasses.replace(desc, n=desc.n // s, mesh=None)


def mesh_comm_events(desc, comm: str) -> Tuple[Tuple[str, int], ...]:
    """``((collective, per-device payload bytes), ...)`` one strategy
    issues around the local kernel: the bytes each device sends or
    receives, the ring's (s-1)/s factor folded in (the accounting of the
    collective probes in ``core.microbench``)."""
    if desc.mesh is None or desc.mesh.size == 1:
        return ()
    s = desc.mesh.size
    frac = (s - 1) / s
    if isinstance(desc, GroupedGemmDescriptor):
        isz = itemsize(desc.dtype)
        if comm == "gathered":
            return (("all_gather", int(frac * desc.num_experts * desc.k
                                       * desc.n * desc.w_wire_itemsize)),)
        t_loc = desc.t // s
        return (("all_to_all", int(frac * t_loc * desc.k * isz)),
                ("all_to_all", int(frac * t_loc * desc.n * isz)))
    out_sz = itemsize(desc.out_dtype)
    if comm == "gathered":
        return (("all_gather", int(frac * desc.k * desc.n
                                   * desc.b_wire_itemsize)),)
    return (("all_gather", int(frac * desc.m * desc.n * out_sz)),)


def mesh_comm_seconds(desc, machine: MachineModel, comm: str) -> float:
    """Modelled communication time of one strategy under ``machine``
    (measured rates when network-calibrated, the link figures otherwise)."""
    return sum(machine.collective_seconds(nbytes, collective=c)
               for c, nbytes in mesh_comm_events(desc, comm))


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
    if desc.quant is not None:
        need += (desc.m + desc.n) * 4  # staged sa (m, 1) and sb (1, n), f32
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
    the whole matrix); ``force_block`` pins the primary blocking.  A mesh
    descriptor is planned once per strategy on its local problem, and the
    cheaper compute plus communication wins (``plan.comm``).
    """
    if desc.mesh is not None:
        best = None
        for comm in MESH_STRATEGIES:
            p = plan_gemm(mesh_local_desc(desc, comm), machine, budget,
                          heterogeneous, force_block)
            p = dataclasses.replace(p, desc=desc, comm=comm)
            if best is None or (p.predicted_seconds(machine)
                                < best.predicted_seconds(machine)):
                best = p
        return best
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
    # region's tiles: compare both lowerings under the model.  A quantized
    # plan on a machine whose kernels stream has no multi-launch kernel to
    # compare with (the region kernel has no quant form, and the
    # non-fused quant lowering is the kernel-free composition), so it
    # stays fused.
    streamed_quant = desc.quant is not None \
        and not machine.stages_whole_operands
    if plan.fused and len(plan.regions) > 1 and not streamed_quant:
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
    plan_source: str = "model"  # see BlockingPlan.plan_source

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


@dataclasses.dataclass(frozen=True)
class FlashDecodePlan:
    """Plan of one paged decode-attention step.

    The page size is the k-block (the pool fixed it when it was built), so
    the only planning freedom is the schedule itself; the plan is always
    ``fused``: the ragged page walk is ONE launch riding runtime tables."""

    desc: FlashDecodeDescriptor
    fused: bool = True
    plan_source: str = "model"  # see BlockingPlan.plan_source

    def tile_schedule(self) -> DecodeTileSchedule:
        """The runtime-table schedule this step walks (one row per live KV
        page, plus the per-slot dummy floor)."""
        d = self.desc
        return DecodeTileSchedule(num_seqs=d.num_seqs, pages=d.pages,
                                  page_size=d.page_size,
                                  max_blocks=d.max_blocks)

    def predicted_seconds(self, machine: MachineModel = DEFAULT_MACHINE
                          ) -> float:
        """Napkin-math step time: every walked tile issues a full
        (h, page_size, hd) product pair; traffic streams each live page
        once plus the q/out rows and the tables."""
        d = self.desc
        steps = self.tile_schedule().max_tiles
        compute_s = d.flops / machine.peak(d.dtype)
        memory_s = (d.in_bytes + d.out_bytes) / machine.hbm_bw
        return (max(compute_s, memory_s) + steps * machine.step_overhead_s
                + machine.launch_overhead_s)


def flash_decode_legal(desc: FlashDecodeDescriptor,
                       machine: MachineModel = DEFAULT_MACHINE) -> bool:
    """Does the machine's decode kernel take this pool geometry?"""
    limits = ((desc.page_size, machine.decode_max_page),
              (desc.head_dim, machine.decode_max_head_dim),
              (desc.num_heads // desc.num_kv_heads, machine.decode_max_group))
    return all(lim is None or v <= lim for v, lim in limits)


def plan_flash_decode(desc: FlashDecodeDescriptor,
                      machine: MachineModel = DEFAULT_MACHINE
                      ) -> FlashDecodePlan:
    """Single-lowering planner: the pool geometry fixed every knob when it
    was built, so the plan only packages the schedule.  A geometry the
    machine's kernel does not take raises."""
    if not flash_decode_legal(desc, machine):
        raise NotImplementedError(
            f"{machine.name} decode kernel limits: page size <= "
            f"{machine.decode_max_page}, head dim <= "
            f"{machine.decode_max_head_dim}, GQA group <= "
            f"{machine.decode_max_group}; got {desc}")
    return FlashDecodePlan(desc)


# ---------------------------------------------------------------------------
# SSD chunked scan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SsdChunkPlan:
    """The SSD ladder has no free tiling knobs; the plan carries the
    fit verdict, the ``fused`` lowering bit (scan form only: the whole
    scan in one carried-state launch instead of the intra-chunk kernel
    plus the inter-chunk recurrence in torch ops) and the cost estimate."""

    desc: SsdChunkDescriptor
    fits_vmem: bool
    fused: bool = False
    plan_source: str = "model"  # see BlockingPlan.plan_source

    def predicted_seconds(self, machine: MachineModel = DEFAULT_MACHINE
                          ) -> float:
        """Napkin-math time; the non-fused scan pays the inter-chunk stitch
        (per-chunk states written and read back between ops) that the
        carried state never materialises."""
        d = self.desc
        compute_s = d.flops / machine.peak(d.dtype)
        memory_s = (d.in_bytes + d.out_bytes) / machine.hbm_bw
        stitch_s = 0.0
        if d.chunks and not self.fused:
            stitch_bytes = 3 * d.groups * d.chunks * d.p * d.n * 4
            stitch_s = stitch_bytes / machine.hbm_bw
        return (max(compute_s, memory_s) + d.cells * machine.step_overhead_s
                + machine.launch_overhead_s + stitch_s)


def ssd_kernel_legal(desc: SsdChunkDescriptor,
                     machine: MachineModel = DEFAULT_MACHINE) -> bool:
    """Does the machine's SSD kernel take this cell geometry?  Only a
    machine whose kernels stream the cell (not one that stages it whole)
    states limits; there every limit must hold."""
    limits = ((desc.q, machine.ssd_max_q), (desc.n, machine.ssd_max_state),
              (desc.p, machine.ssd_max_head_dim))
    return all(lim is None or v <= lim for v, lim in limits)


def _ssd_refuse(desc: SsdChunkDescriptor, machine: MachineModel) -> None:
    if not machine.stages_whole_operands and not ssd_kernel_legal(desc,
                                                                  machine):
        raise NotImplementedError(
            f"{machine.name} SSD kernel limits: chunk <= {machine.ssd_max_q}, "
            f"state <= {machine.ssd_max_state}, head dim <= "
            f"{machine.ssd_max_head_dim}; got {desc}")


def ssd_fused_legal(desc: SsdChunkDescriptor,
                    machine: MachineModel = DEFAULT_MACHINE) -> bool:
    """Can this SSD scan run as one carried-state launch?  Only the scan
    form has one.  A machine that stages whole cells needs one chunk's
    operands (double-buffered), the fp32 state and the score tile to fit
    half its fast memory; a streaming kernel needs its limits."""
    if not desc.chunks:
        return False
    if not machine.stages_whole_operands:
        return ssd_kernel_legal(desc, machine)
    isz = itemsize(desc.dtype)
    per_step = (2 * desc.q * desc.n + desc.q * desc.q
                + 2 * desc.q * desc.p + 2 * desc.q) * isz
    need = 2 * per_step                                  # double-buffered
    need += (desc.q * desc.q + 2 * desc.p * desc.n) * 4  # score + state
    return need <= machine.vmem_bytes // 2


def plan_ssd(desc: SsdChunkDescriptor,
             machine: MachineModel = DEFAULT_MACHINE) -> SsdChunkPlan:
    """Plan one SSD dispatch: the fit verdict and, for the scan form, the
    one-launch lowering whenever it is legal.  A geometry outside a
    streaming machine's kernel limits raises: no lowering takes it."""
    _ssd_refuse(desc, machine)
    if machine.stages_whole_operands:
        isz = itemsize(desc.dtype)
        per_step = (2 * desc.q * desc.n + desc.q * desc.q
                    + 2 * desc.q * desc.p) * isz
        per_step += desc.q * desc.q * 4  # fp32 score scratch
        fits = per_step <= machine.vmem_bytes // 2
    else:
        fits = True
    return SsdChunkPlan(desc, fits_vmem=fits,
                        fused=ssd_fused_legal(desc, machine))


def ssd_bwd_fused_legal(desc: SsdChunkBwdDescriptor,
                        machine: MachineModel = DEFAULT_MACHINE) -> bool:
    """Can this SSD-scan backward run as one reverse-walk launch?  Staged
    whole: a chunk's forward cell, its dY and saved state
    (double-buffered), the cotangent cell and the fp32 dS carry and score
    scratch must fit half of fast memory.  Streamed: the kernel's limits."""
    if not desc.chunks:
        return False
    if not machine.stages_whole_operands:
        return ssd_kernel_legal(desc, machine)
    isz = itemsize(desc.dtype)
    q, n, p = desc.q, desc.n, desc.p
    per_step = (2 * q * n + q * q + 2 * q * p + 2 * q) * isz  # fwd cell
    per_step += q * p * isz                                   # dY cell
    per_step += p * n * 4                                     # saved state
    per_step += (2 * q * n + q * q + q * p) * isz + 2 * q * 4  # cotangents
    need = 2 * per_step + (q * q + 2 * p * n) * 4 + p * n * 4
    return need <= machine.vmem_bytes // 2


def plan_ssd_bwd(desc: SsdChunkBwdDescriptor,
                 machine: MachineModel = DEFAULT_MACHINE) -> SsdChunkPlan:
    """Plan the SSD backward: one reverse-walk launch, gated by
    :func:`ssd_bwd_fused_legal` (an illegal backward falls back to
    differentiating the reference before it reaches the engine)."""
    if machine.stages_whole_operands:
        isz = itemsize(desc.dtype)
        per_step = (2 * desc.q * desc.n + desc.q * desc.q
                    + 2 * desc.q * desc.p) * isz
        per_step += desc.q * desc.q * 4
        fits = per_step <= machine.vmem_bytes // 2
    else:
        fits = ssd_kernel_legal(desc, machine)
    return SsdChunkPlan(desc, fits_vmem=fits,
                        fused=ssd_bwd_fused_legal(desc, machine))


# ---------------------------------------------------------------------------
# Grouped (ragged) GEMM
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupedGemmPlan:
    """Planned (bm, bk, bn) tiling of one ragged grouped GEMM, plus the
    ``fused`` lowering bit (one launch over runtime tile tables, else the
    pad/scatter lowering)."""

    desc: GroupedGemmDescriptor
    bm: int
    bk: int
    bn: int
    fused: bool = False
    plan_source: str = "model"  # see BlockingPlan.plan_source
    comm: Optional[str] = None  # mesh strategy, see BlockingPlan.comm

    @property
    def local_desc(self) -> GroupedGemmDescriptor:
        """The per-shard problem this plan's knobs describe: the
        descriptor itself off-mesh, ``mesh_local_desc`` under a mesh
        strategy."""
        if self.desc.mesh is not None and self.comm is not None:
            return mesh_local_desc(self.desc, self.comm)
        return self.desc

    @property
    def t_padded(self) -> int:
        """Static row bound of the pad/scatter lowering: T rounded up plus
        room for every group's padding."""
        d = self.local_desc
        return round_up(d.t, self.bm) + d.num_experts * self.bm

    def tile_schedule(self) -> GroupedTileSchedule:
        """The static geometry of the fused lowering; the tables are
        runtime data built from ``group_sizes``.  For a mesh plan it is the
        per-shard schedule: the single launch holds per shard."""
        d = self.local_desc
        return GroupedTileSchedule(
            t=d.t, k=d.k, n=d.n, num_experts=d.num_experts,
            bm=min(self.bm, d.t), bk=min(self.bk, d.k), bn=min(self.bn, d.n))

    def predicted_seconds(self, machine: MachineModel = DEFAULT_MACHINE
                          ) -> float:
        comm_s = 0.0
        if self.desc.mesh is not None and self.comm is not None:
            comm_s = mesh_comm_seconds(self.desc, machine, self.comm)
        return _predict_grouped_seconds(self.local_desc, self.bm, self.bk,
                                        self.bn, machine,
                                        fused=self.fused) + comm_s


def grouped_fused_legal(desc: GroupedGemmDescriptor,
                        machine: MachineModel = DEFAULT_MACHINE) -> bool:
    """Can this grouped GEMM run as one scheduled launch?  A kernel that
    stages the whole token block and output on chip (clamped row windows
    need element-granular origins) plus a double-buffered expert panel
    needs them to fit; a kernel that streams tiles from device memory
    takes every problem."""
    if not machine.stages_whole_operands:
        return True
    isz = itemsize(desc.dtype)
    need = desc.t * desc.k * desc.x_wire_itemsize + desc.t * desc.n * isz
    need += 2 * desc.k * desc.n * desc.w_wire_itemsize
    if desc.quant is not None:
        need += (desc.t + desc.n) * 4  # sx (t, 1) and one sw row, f32
    need += machine.acc_budget_elems * 4
    return need <= machine.vmem_bytes


def _predict_grouped_seconds(desc: GroupedGemmDescriptor, bm: int, bk: int,
                             bn: int, machine: MachineModel,
                             fused: bool = False) -> float:
    """Napkin-math time of one grouped tiling: issued MACs against tile
    traffic, plus per-step and launch overheads; the pad/scatter lowering
    adds padded rows and its scatter-in / gather-back traffic."""
    isz = itemsize(desc.dtype)
    x_sz, w_sz = desc.x_wire_itemsize, desc.w_wire_itemsize
    gn = ceil_div(desc.n, bn)
    gk = ceil_div(desc.k, bk)
    if fused:
        # Ragged row blocks: each expert may add one partial block, plus
        # the zero-fill tail; no padded intermediate, no gather.
        gm = ceil_div(desc.t, bm) + desc.num_experts + 1
        stitch_s = 0.0
    else:
        t_padded = round_up(desc.t, bm) + desc.num_experts * bm
        gm = ceil_div(t_padded, bm)
        stitch_bytes = 2 * desc.t * desc.k * isz          # scatter x
        stitch_bytes += (gm * bm + desc.t) * desc.n * isz  # gather out
        stitch_s = stitch_bytes / machine.hbm_bw
    steps = gm * gn * gk
    issued = 2 * gm * bm * gn * bn * desc.k
    compute_s = issued / machine.peak(desc.compute_dtype)
    traffic = (steps * (bm * bk * x_sz + bk * bn * w_sz)
               + gm * bm * desc.n * isz)
    memory_s = traffic / machine.hbm_bw
    return (max(compute_s, memory_s) + steps * machine.step_overhead_s
            + machine.launch_overhead_s + stitch_s)


def grouped_smem_bytes(bm: int, bk: int, bn: int) -> int:
    """Shared memory one grouped tile stages: a (bm, bk) and a (bk, bn)
    panel in fp32 with 4 words of row padding each (the bf16 panels and the
    tensor-core scratch take less)."""
    return bk * (bm + bn + 8) * 4


def _grouped_legal(desc: GroupedGemmDescriptor,
                   machine: MachineModel) -> List[Tuple[int, int, int]]:
    """All legal (bm, bk, bn) triples for one grouped descriptor: the
    kernel's own tilings that fit its shared memory where the machine
    lists them, else every VMEM fit."""
    if machine.grouped_blocks is not None:
        return [b for b in machine.grouped_blocks
                if grouped_smem_bytes(*b) <= machine.grouped_smem_bytes]
    sub, lane = machine.reg_tile(desc.dtype)
    isz = itemsize(desc.dtype)
    legal = []
    for bm in _tile_candidates(desc.t, sub, lo=sub):
        for bn in _tile_candidates(desc.n, lane, lo=lane):
            for bk in _tile_candidates(desc.k, lane, lo=lane):
                vmem = bm * bn * 4 + 2 * (bm * bk + bk * bn) * isz
                if vmem > machine.vmem_bytes // 2:
                    continue
                legal.append((bm, bk, bn))
    if not legal:
        legal.append((sub, lane, lane))
    return legal


def plan_grouped(desc: GroupedGemmDescriptor,
                 machine: MachineModel = DEFAULT_MACHINE) -> GroupedGemmPlan:
    """Pick (bm, bk, bn) by the cost model (bm trades per-group padding
    against grid size); ``fused`` whenever :func:`grouped_fused_legal`
    allows.  A mesh descriptor is planned per strategy, gathered (the
    expert weights all-gathered, every expert over the local tokens) or
    distributed (tokens moved by all_to_all to the local expert shard);
    the cheaper compute plus communication wins (``plan.comm``)."""
    if desc.mesh is not None:
        cands = [dataclasses.replace(
                     plan_grouped(mesh_local_desc(desc, comm), machine),
                     desc=desc, comm=comm)
                 for comm in MESH_STRATEGIES]
        return min(cands, key=lambda p: p.predicted_seconds(machine))
    fused = grouped_fused_legal(desc, machine)
    best = min(_grouped_legal(desc, machine),
               key=lambda s: _predict_grouped_seconds(desc, *s,
                                                      machine=machine,
                                                      fused=fused))
    return GroupedGemmPlan(desc, *best, fused=fused)


def grouped_bwd_fused_legal(desc: GroupedGemmBwdDescriptor,
                            machine: MachineModel = DEFAULT_MACHINE) -> bool:
    """Can this grouped-GEMM backward run as one scheduled launch?  Staged
    whole: x, dy and dx, the double-buffered expert panel, and the fp32 dW
    (and db) accumulated in place must fit.  Streamed (dW and dX tiles
    each reduced by one thread block): every problem."""
    if not machine.stages_whole_operands:
        return True
    isz = itemsize(desc.dtype)
    need = desc.t * (2 * desc.k + desc.n) * isz      # x, dx, dy
    need += 2 * desc.k * desc.n * isz                # double-buffered panel
    need += desc.num_experts * desc.k * desc.n * 4   # dW, fp32
    if desc.epilogue in BIAS_EPILOGUES:
        need += desc.num_experts * desc.n * 4        # db, fp32
    need += machine.acc_budget_elems * 4
    return need <= machine.vmem_bytes


def plan_grouped_bwd(desc: GroupedGemmBwdDescriptor,
                     machine: MachineModel = DEFAULT_MACHINE
                     ) -> GroupedGemmPlan:
    """Plan the grouped backward: the forward's (bm, bk, bn) search (both
    gradients walk the same runtime tile tables), gated by
    :func:`grouped_bwd_fused_legal`."""
    fused = grouped_bwd_fused_legal(desc, machine)
    best = min(_grouped_legal(desc, machine),
               key=lambda s: _predict_grouped_seconds(desc, *s,
                                                      machine=machine,
                                                      fused=fused))
    return GroupedGemmPlan(desc, *best, fused=fused)


# ---------------------------------------------------------------------------
# Tile transpose
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TransposePlan:
    """Planned square tile edge ``bt`` of one (batched) blocked
    transpose."""

    desc: TransposeDescriptor
    bt: int
    plan_source: str = "model"  # see BlockingPlan.plan_source

    def predicted_seconds(self, machine: MachineModel = DEFAULT_MACHINE
                          ) -> float:
        return _predict_transpose_seconds(self.desc, self.bt, machine)


def _predict_transpose_seconds(desc: TransposeDescriptor, bt: int,
                               machine: MachineModel) -> float:
    """Napkin-math time: every (bt, bt) tile read and written whole (the
    masked edge tiles charged as full ones), plus per-tile and launch
    overheads; the batch is a grid dimension of the one launch."""
    nb = max(1, desc.batch)
    steps = nb * ceil_div(desc.rows, bt) * ceil_div(desc.cols, bt)
    traffic = 2 * steps * bt * bt * itemsize(desc.dtype)
    return (traffic / machine.hbm_bw + steps * machine.step_overhead_s
            + machine.launch_overhead_s)


def _transpose_legal(desc: TransposeDescriptor,
                     machine: MachineModel) -> List[int]:
    """All legal square tile edges: the kernel's own where the machine
    lists them, else every aligned edge whose staged tile (and its
    transpose) fits half of VMEM."""
    if machine.transpose_tiles is not None:
        return list(machine.transpose_tiles)
    sub, lane = machine.reg_tile(desc.dtype)
    isz = itemsize(desc.dtype)
    extent = max(desc.rows, desc.cols)
    legal = [bt for bt in _tile_candidates(extent, max(sub, 8), lo=32)
             if 2 * bt * bt * isz <= machine.vmem_bytes // 2]
    return legal or [lane]


def plan_transpose(desc: TransposeDescriptor,
                   machine: MachineModel = DEFAULT_MACHINE) -> TransposePlan:
    """Pick the square tile edge: the largest legal tile wins on traffic,
    smaller tiles win on ragged edges (masked-tile waste)."""
    best = min(_transpose_legal(desc, machine),
               key=lambda bt: _predict_transpose_seconds(desc, bt, machine))
    return TransposePlan(desc, best)


# ---------------------------------------------------------------------------
# Candidate enumeration (the autotuner's search space)
# ---------------------------------------------------------------------------

def _executable(plan, machine: MachineModel) -> bool:
    """Does the machine's executor run ``plan`` on one of its kernels?  On a
    machine whose kernels stream (``H100_SXM``) a quantized plan runs a
    kernel only fused (the region and pad/scatter kernels are wide only,
    and the non-fused quant lowering is a kernel-free composition), and a
    GEMM's K panel is the kernel's own (``k_panel``).  A machine that
    stages whole operands takes every plan its planners build."""
    if machine.stages_whole_operands:
        return True
    if getattr(plan.desc, "quant", None) is not None and not plan.fused:
        return False
    if isinstance(plan, BlockingPlan) and machine.k_panel is not None:
        return plan.bk == machine.k_panel
    return True


def candidate_plans(desc, machine: MachineModel = DEFAULT_MACHINE,
                    top_k: int = 8) -> List:
    """Top-``top_k`` machine-legal candidate plans for one descriptor,
    cheapest first by the planners' cost model, deduplicated by their
    knobs: the search space the autotuner times.  The fused and unfused
    lowerings of one tiling are separate candidates, so a search can pick
    a lowering the planner never selects.  Under ``TPU_V5E`` the list is
    the reference's; under a machine whose kernels stream it holds only
    plans its executors run on a kernel (:func:`_executable`).  A mesh
    descriptor's search space is its two strategies, each with its locally
    planned knobs, so the autotuner times gathered against distributed."""
    fam = desc.family
    cands: List = []
    seen = set()

    def add(plan, knob_key):
        if knob_key not in seen and _executable(plan, machine):
            seen.add(knob_key)
            cands.append(plan)

    if fam in ("gemm", "grouped_gemm") and desc.mesh is not None:
        planner = plan_gemm if fam == "gemm" else plan_grouped
        for comm in MESH_STRATEGIES:
            p = dataclasses.replace(planner(mesh_local_desc(desc, comm),
                                            machine),
                                    desc=desc, comm=comm)
            add(p, (comm,))
    elif fam == "gemm":
        fused_ok = fused_legal(desc, machine)
        for shape in palette(machine.acc_budget_elems, machine,
                             desc.in_dtype):
            for het in (True, False):
                p = plan_gemm(desc, machine, heterogeneous=het,
                              force_block=shape)
                for fused in ((True, False) if fused_ok else (False,)):
                    q = dataclasses.replace(p, fused=fused)
                    add(q, (q.regions, q.bk, fused))
    elif fam == "flash_attention":
        fused_ok = flash_fused_legal(desc, machine)
        for bq, bk in _flash_legal(desc, machine):
            for fused in ((True, False) if fused_ok else (False,)):
                add(FlashPlan(desc, bq, bk, fused=fused), (bq, bk, fused))
    elif fam == "grouped_gemm":
        fused_ok = grouped_fused_legal(desc, machine)
        for bm, bk, bn in _grouped_legal(desc, machine):
            for fused in ((True, False) if fused_ok else (False,)):
                add(GroupedGemmPlan(desc, bm, bk, bn, fused=fused),
                    (bm, bk, bn, fused))
    elif fam == "flash_attention_bwd":
        # One (scheduled) lowering: the unfused backward differentiates
        # the reference outside the engine.
        fused_ok = flash_bwd_fused_legal(desc, machine)
        for bq, bk in _flash_legal(desc, machine):
            add(FlashPlan(desc, bq, bk, fused=fused_ok), (bq, bk))
    elif fam == "grouped_gemm_bwd":
        fused_ok = grouped_bwd_fused_legal(desc, machine)
        for bm, bk, bn in _grouped_legal(desc, machine):
            add(GroupedGemmPlan(desc, bm, bk, bn, fused=fused_ok),
                (bm, bk, bn))
    elif fam == "ssd_chunk_bwd":
        add(plan_ssd_bwd(desc, machine), ())
    elif fam == "flash_decode":
        # No free knobs: the pool fixed the page size.
        add(plan_flash_decode(desc, machine), ())
    elif fam == "transpose":
        for bt in _transpose_legal(desc, machine):
            add(TransposePlan(desc, bt), (bt,))
    elif fam == "ssd_chunk":
        # No tiling knobs; the scan form still has two lowerings (the
        # carried-state launch, or the diag kernel plus the recurrence).
        p = plan_ssd(desc, machine)
        if ssd_fused_legal(desc, machine):
            for fused in (True, False):
                add(dataclasses.replace(p, fused=fused), (fused,))
        else:
            add(dataclasses.replace(p, fused=False), ())
    else:
        raise KeyError(f"no candidate enumerator for family {fam!r}")

    cands.sort(key=lambda p: p.predicted_seconds(machine))
    return cands[:max(1, top_k)]
