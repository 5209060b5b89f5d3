"""Ragged grouped GEMM family (MoE expert compute): engine-planned dispatch,
forward and backward.

Takes rows sorted by group plus the group sizes and runs one of two
lowerings, resolved by ``engine.resolve_fused`` as for the dense GEMM:

  * **fused** (``plan.fused``): the plan's
    :class:`~repro_torch.core.schedule.GroupedTileSchedule` turns
    ``group_sizes`` into a runtime tile table on the device and ONE
    ``grouped_fused`` launch walks the ragged expert row blocks: no padded
    intermediate, no gather-back;
  * **pad/scatter**: pad each group to a ``bm`` multiple, build the
    block -> expert map, ONE ``grouped_padded`` launch over the static
    grid, gather the rows back out (the scatter and the gather are device
    torch ops, as they are jnp ops outside the kernel in the reference).

Either counts one launch.  A quantized descriptor (``desc.quant``, from
``grouped_gemm(quant=)`` or the ambient ``config.quant``) runs ONE
``grouped_quant`` launch over the same table when the plan is fused, and
otherwise the reference's ``_xla_quant_grouped`` in torch
(:func:`~repro_torch.kernels.grouped_gemm.ref.ref_quant_grouped`, no
kernel of the engine); the quant path is inference only.  The backward
family ``grouped_gemm_bwd`` is ONE
``grouped_bwd`` launch over the same tables.  Gradients flow through
:class:`_GroupedFn` (the reference's ``_grouped_vjp``): its forward is the
engine dispatch; its backward peels the activation off by recomputing the
pre-activation through the engine, then runs the backward kernel, or, where
:func:`~repro_torch.core.blocking.grouped_bwd_fused_legal` fails (or under
``fused="off"``), differentiates :func:`_ref_grouped` in torch.

A descriptor with a mesh runs :func:`_execute_mesh`: the plan's strategy
(gathered or distributed) over the mesh axis's process group, each rank
running the same local grouped call, so the single launch holds per rank.
:func:`expert_parallel_grouped_gemm` is its differentiable entry point
(the reference's, for the MoE layer under a mesh).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import engine
from repro_torch.core.blocking import (GroupedGemmPlan,
                                       grouped_bwd_fused_legal,
                                       mesh_comm_events, plan_grouped,
                                       plan_grouped_bwd)
from repro_torch.core.config import get_config, use
from repro_torch.core.descriptor import (GroupedGemmBwdDescriptor,
                                         GroupedGemmDescriptor, MeshSpec,
                                         check_bias, resolve_quant)
from repro_torch.core.schedule import plan_launches
from repro_torch.kernels import disable_tf32
from repro_torch.kernels.epilogue import apply_epilogue, needs_bias
from repro_torch.core.machine import canonical_dtype, torch_dtype
from repro_torch.kernels.grouped_gemm.kernel import (grouped_bwd,
                                                     grouped_fused,
                                                     grouped_padded,
                                                     grouped_quant)
from repro_torch.kernels.grouped_gemm.ref import (expert_offsets,
                                                  ref_quant_grouped,
                                                  row_experts)


def plan_groups(group_sizes: torch.Tensor, num_experts: int, bm: int,
                t_padded: int) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Row offsets per group after padding each group to a bm multiple.

    Returns int32 ``(padded_offsets (E+1,), block_expert (nb,), nrows
    (1,))``, device ops on group_sizes' device, no host sync.
    """
    sizes = group_sizes.long()
    padded = ((sizes + bm - 1) // bm) * bm
    offsets = expert_offsets(padded)
    block_row = torch.arange(t_padded // bm, device=sizes.device) * bm
    block_expert = torch.clamp(
        torch.searchsorted(offsets, block_row, right=True) - 1,
        0, num_experts - 1)
    return (offsets.to(torch.int32), block_expert.to(torch.int32),
            offsets[-1:].to(torch.int32))


def scatter_rows(x_sorted_by_group, group_sizes, offsets, bm, t_padded):
    """Place each group's rows at its padded offset (zeros between);
    returns ``(x_padded, dest)``."""
    t = x_sorted_by_group.shape[0]
    src_off = expert_offsets(group_sizes)
    grp, _ = row_experts(group_sizes, t)
    row = torch.arange(t, device=src_off.device)
    dest = offsets.long()[grp] + (row - src_off[grp])
    out = torch.zeros((t_padded, x_sorted_by_group.shape[1]),
                      dtype=x_sorted_by_group.dtype,
                      device=x_sorted_by_group.device)
    out[dest] = x_sorted_by_group
    return out, dest


def _execute_fused(desc, plan, x, w, group_sizes, bias):
    """Single scheduled launch: runtime tables, direct ragged stores."""
    table = plan.tile_schedule().tables(group_sizes)
    return grouped_fused(table, x, w, bias, bm=plan.bm, bn=plan.bn,
                         epilogue=desc.epilogue)


def _execute_padded(desc, plan, x, w, group_sizes, bias):
    """Pad/scatter lowering: pad groups to bm multiples, gather back."""
    bm, t_padded = plan.bm, plan.t_padded
    offsets, block_expert, nrows = plan_groups(group_sizes, desc.num_experts,
                                               bm, t_padded)
    x_padded, dest = scatter_rows(x, group_sizes, offsets, bm, t_padded)
    out_padded = grouped_padded(x_padded, w, block_expert, nrows, bias, bm=bm,
                                bn=plan.bn, epilogue=desc.epilogue)
    # back to the caller's (sorted, unpadded) row order; rows past
    # sum(group_sizes) belong to no group -> zero (matches the oracle)
    _, valid = row_experts(group_sizes, desc.t)
    return torch.where(valid[:, None], out_padded[dest], 0).to(x.dtype)


def _contiguous(*ts):
    return tuple(None if t is None else t.contiguous() for t in ts)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0, in rank order."""
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``j`` of dim 0 goes to rank ``j``; block ``i`` of the result
    came from rank ``i``."""
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _execute_mesh(desc: GroupedGemmDescriptor, plan: GroupedGemmPlan, x4, w,
                  group_sizes, bias):
    """Mesh execution of the plan's strategy over the descriptor's axis.

    Every rank holds the whole capacity-slot ``x4`` ``(n, e, cap, k)`` and
    the whole bank ``w`` ``(e, k, f)`` (the port keeps activations and
    masters replicated); its shard is its slice of ``n`` along the axis,
    and its expert shard the slice of ``e``.  Both strategies run the
    SAME local grouped call (``plan.local_desc`` with the plan's knobs):

      * **gathered**: the expert shards are all-gathered into the whole
        bank, and every expert runs over the rank's token slice;
      * **distributed**: the rank keeps its ``e / s`` experts, and two
        ``all_to_all``s move the capacity slots to their expert's owner
        and back (the reference's reshuffles).

    The result is all-gathered back to a replicated ``(n, e, cap, f)``.
    The counters record what the reference records: the distributed
    strategy's two all_to_alls and their ``mesh_comm_events`` bytes.  The
    all_gathers here (the weights when gathered, the output in both)
    stand where XLA reshards implicitly in the reference, which counts
    none of them, so they are not counted either.
    """
    if desc.quant is not None:
        raise NotImplementedError("mesh grouped GEMM is wide-only")
    if bias is not None:
        raise NotImplementedError("mesh grouped GEMM has no bias path")
    from repro_torch.runtime.shardlib import axis_sizes, current_mesh
    mesh = current_mesh()
    axis, s = desc.mesh.axis, desc.mesh.size
    if mesh is None or axis_sizes(mesh).get(axis, 0) != s:
        raise ValueError(f"descriptor mesh {desc.mesh} does not match the "
                         f"active mesh {mesh}")
    group, c = mesh.get_group(axis), mesh.get_local_rank(axis)
    comm = plan.comm or "gathered"
    local = plan.local_desc
    lplan = GroupedGemmPlan(local, plan.bm, plan.bk, plan.bn,
                            fused=plan.fused, plan_source=plan.plan_source)
    nt, e, cap, k = x4.shape
    f = desc.n
    nl, e_loc = nt // s, e // s

    def run_local(rows, w_loc, n_groups):
        sizes = torch.full((n_groups,), rows.shape[0] // n_groups,
                           dtype=torch.int32, device=rows.device)
        return execute(local, lplan, rows, w_loc, sizes)

    xl = x4[c * nl:(c + 1) * nl]
    w_own = w[c * e_loc:(c + 1) * e_loc]
    if comm == "gathered":
        w_full = _all_gather(w_own, group)
        rows = xl.transpose(0, 1).reshape(e * nl * cap, k)
        y = run_local(rows, w_full, e).reshape(e, nl, cap, f).transpose(0, 1)
    else:
        events = mesh_comm_events(desc, "distributed")
        engine.count_comm("grouped_gemm", sum(b for _, b in events),
                          launches=len(events))
        # Slots by owner rank: (s, nl, e_loc, cap, k), dim 0 the
        # destination; after the all_to_all dim 0 is the source rank.
        h = xl.reshape(nl, s, e_loc, cap, k).transpose(0, 1)
        h = _all_to_all(h, group)
        # Rows sorted by local expert, s * nl * cap rows each.
        rows = h.permute(2, 0, 1, 3, 4).reshape(e_loc * s * nl * cap, k)
        y = run_local(rows, w_own, e_loc)
        # Back to the source ranks, then to (nl, e, cap, f) token-major.
        y = y.reshape(e_loc, s, nl, cap, f).permute(1, 2, 0, 3, 4)
        y = _all_to_all(y, group)
        y = y.transpose(0, 1).reshape(nl, e, cap, f)
    return _all_gather(y, group)


def execute(desc: GroupedGemmDescriptor, plan: GroupedGemmPlan, x, w,
            group_sizes, *, bias=None, sx=None, sw=None) -> torch.Tensor:
    """Engine executor: run one planned grouped GEMM (either lowering).
    ``sx``/``sw`` are a quantized descriptor's dense f32 scales: per row
    ``(T,)`` for full quant, per expert column ``(E, N)`` for any spec.
    A mesh descriptor takes the capacity-slot operands of
    :func:`expert_parallel_grouped_gemm` (``group_sizes`` None)."""
    if desc.mesh is not None:
        return _execute_mesh(desc, plan, x, w, group_sizes, bias)
    check_bias(desc.epilogue, bias)
    fused = engine.resolve_fused(plan)
    if desc.quant is not None:
        x, w, sx, sw, bias = _contiguous(x, w, sx, sw, bias)
        out_dtype = torch_dtype(desc.dtype)
        if not fused:
            # The non-fused quant lowering: no kernel of the engine (the
            # pad/scatter kernel is wide only).
            engine.count_launches("grouped_gemm", 0)
            return ref_quant_grouped(x, w, group_sizes, sx, sw, bias,
                                     epilogue=desc.epilogue,
                                     out_dtype=out_dtype)
        engine.count_launches("grouped_gemm", plan_launches(plan, fused=True))
        table = plan.tile_schedule().tables(group_sizes)
        return grouped_quant(table, x, w, sx, sw, bias, bm=plan.bm,
                             bn=plan.bn, epilogue=desc.epilogue,
                             out_dtype=out_dtype)
    engine.count_launches("grouped_gemm", plan_launches(plan, fused=fused))
    x, w, bias = _contiguous(x, w, bias)
    run = _execute_fused if fused else _execute_padded
    return run(desc, plan, x, w, group_sizes, bias)


engine.register_family("grouped_gemm", planner=plan_grouped, execute=execute)


def execute_bwd(desc: GroupedGemmBwdDescriptor, plan: GroupedGemmPlan, x, dy,
                w, group_sizes):
    """Engine executor: one planned grouped-GEMM backward -> fp32 ``(dX,
    dW, db or None)``.  ``dy`` is the pre-epilogue cotangent.  Single
    lowering, the scheduled walk: an illegal backward never reaches the
    engine (:class:`_GroupedFn` differentiates the reference first)."""
    engine.count_launches("grouped_gemm_bwd", 1)
    table = plan.tile_schedule().tables(group_sizes)
    x, dy, w = _contiguous(x, dy.float(), w)
    return grouped_bwd(table, x, dy, w, group_sizes, bm=plan.bm,
                       with_db=needs_bias(desc.epilogue))


engine.register_family("grouped_gemm_bwd", planner=plan_grouped_bwd,
                       execute=execute_bwd)


def _act_name(epilogue: Optional[str]) -> Optional[str]:
    """The activation half of an epilogue name (None when linear)."""
    if epilogue is None or epilogue == "bias":
        return None
    return epilogue.split("_")[-1]


def _ref_grouped(epilogue, x, w, group_sizes, bias):
    """Epilogue-aware plain version, differentiable by autograd: the
    oracle the backward falls back to when the scheduled backward is not
    legal.  Expert by expert in fp32 (sizes read on the host), so any size
    fits; rows past ``sum(group_sizes)`` are zero whatever the epilogue."""
    if x.is_cuda:
        disable_tf32()
    offsets = expert_offsets(group_sizes).tolist()
    parts = []
    for e in range(w.shape[0]):
        r0, r1 = offsets[e], offsets[e + 1]
        if r1 > r0:
            acc = x[r0:r1].float() @ w[e].float()
            parts.append(apply_epilogue(acc, epilogue,
                                        None if bias is None else bias[e]))
    tail = x.shape[0] - offsets[-1]
    parts.append(x.new_zeros((tail, w.shape[2]), dtype=torch.float32))
    return torch.cat(parts).to(x.dtype)


def _grouped_dispatch(epilogue, x, w, group_sizes, bias):
    """The engine-dispatched forward (primal path)."""
    desc = GroupedGemmDescriptor.from_operands(x, w, epilogue=epilogue)
    return engine.dispatch(desc, x, w, group_sizes, bias=bias)


class _GroupedFn(torch.autograd.Function):
    """Differentiable grouped GEMM (the reference's ``_grouped_vjp``).  The
    backward branch is decided in the forward, under the configuration in
    force there, and kept for the backward."""

    @staticmethod
    def forward(ctx, epilogue, x, w, group_sizes, bias):
        cfg = get_config()
        desc = GroupedGemmDescriptor.from_operands(x, w, epilogue=epilogue)
        ctx.fused = (cfg.fused != "off" and grouped_bwd_fused_legal(
            GroupedGemmBwdDescriptor.from_forward(desc), cfg.machine))
        ctx.epilogue = epilogue
        ctx.save_for_backward(x, w, group_sizes, bias)
        return engine.dispatch(desc, x, w, group_sizes, bias=bias)

    @staticmethod
    def backward(ctx, g):
        x, w, group_sizes, bias = ctx.saved_tensors
        epilogue = ctx.epilogue
        if ctx.fused:
            dpre = g.float()
            act = _act_name(epilogue)
            if act is not None:
                # Peel the activation off: recompute the pre-activation
                # through the engine with the activation stripped, then
                # pull g through the activation alone (in fp32, the
                # cotangent back in the pre-activation's dtype).
                biased = needs_bias(epilogue)
                pre = _grouped_dispatch("bias" if biased else None, x, w,
                                        group_sizes, bias if biased else None)
                pre = pre.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = apply_epilogue(pre.float(), act)
                    dpre = torch.autograd.grad(y, pre, dpre)[0]
            bdesc = GroupedGemmBwdDescriptor.from_forward(
                GroupedGemmDescriptor.from_operands(x, w, epilogue=epilogue))
            dx, dw, db = engine.dispatch(bdesc, x, dpre, w, group_sizes)
            db = db.to(bias.dtype) if needs_bias(epilogue) else None
        else:
            leaves = [t.detach().requires_grad_(True) for t in (x, w)]
            if bias is not None:
                leaves.append(bias.detach().requires_grad_(True))
            with torch.enable_grad():
                out = _ref_grouped(epilogue, leaves[0], leaves[1],
                                   group_sizes,
                                   leaves[2] if bias is not None else None)
                grads = torch.autograd.grad(out, leaves, g.to(x.dtype))
            dx, dw = grads[0], grads[1]
            db = grads[2] if bias is not None else None
        return None, dx.to(x.dtype), dw.to(w.dtype), None, db


def _quantize_grouped_w(w, spec):
    """Per-expert quantization of the ``(E, K, N)`` bank along output
    columns: every expert's panel gets its own scales, expanded dense to
    one ``(E, N)`` f32 table the kernel indexes by the table's expert
    column."""
    from repro_torch.optim.compression import quantize_operand
    parts = [quantize_operand(w[e], spec, axis=1) for e in range(w.shape[0])]
    return (torch.stack([q for q, _ in parts]),
            torch.stack([s for _, s in parts]))


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                 *, epilogue: Optional[str] = None,
                 bias: Optional[torch.Tensor] = None,
                 bm: Optional[int] = None, bk: Optional[int] = None,
                 bn: Optional[int] = None, fused: Optional[bool] = None,
                 quant=None) -> torch.Tensor:
    """Ragged grouped GEMM via the engine.

    x: (T, K) rows sorted by group; w: (E, K, N); group_sizes: (E,) int
    (runtime data, sum <= T).  Returns (T, N): row i multiplied by its
    group's weight; rows beyond sum(group_sizes) are zero.  ``epilogue``
    fuses the GEMM tail (``bias`` is per expert, (E, N));
    ``bm``/``bk``/``bn`` pin the tiling and ``fused=True/False`` the
    lowering for this call (pinned calls are not differentiable, as in
    the reference).  With gradients on, the default call flows through
    :class:`_GroupedFn` onto the backward kernel.

    ``quant`` selects the low-precision axis (a spec or ``"int8"`` /
    ``"w8a16"`` / ``"fp8"``; ``None`` follows ``config.quant``, ``False``
    opts out): the bank is quantized here per expert along output
    columns, the rows per row for full quant, and the dequant runs in the
    epilogue.  The quant path is inference only (no backward).
    """
    check_bias(epilogue, bias)
    spec = resolve_quant(get_config().quant if quant is None else quant)
    sx = sw = None
    # The descriptor of the wide operands: desc.dtype stays the logical
    # compute and output dtype, the spec implies the wire dtypes.
    desc = GroupedGemmDescriptor.from_operands(x, w, epilogue=epilogue,
                                               quant=spec)
    if spec is not None:
        from repro_torch.optim.compression import quantize_operand
        w, sw = _quantize_grouped_w(w, spec)
        if not spec.weight_only:
            x, sx = quantize_operand(x, spec, axis=0)
    plan = None
    if bm is not None or bk is not None or bn is not None:
        # Fill unpinned knobs from the (cached) engine plan.
        auto = engine.plan_for(desc)
        plan = GroupedGemmPlan(desc, bm or auto.bm, bk or auto.bk,
                               bn or auto.bn, fused=auto.fused)
    if spec is not None:
        with use(fused=None if fused is None else ("on" if fused else "off")):
            return engine.dispatch(desc, x, w, group_sizes, plan=plan,
                                   bias=bias, sx=sx, sw=sw)
    if plan is None and fused is None:
        ops = (x, w) if bias is None else (x, w, bias)
        if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
            return _GroupedFn.apply(epilogue, x, w, group_sizes, bias)
        return engine.dispatch(desc, x, w, group_sizes, bias=bias)
    if fused is None:
        return engine.dispatch(desc, x, w, group_sizes, plan=plan, bias=bias)
    with use(fused="on" if fused else "off"):
        return engine.dispatch(desc, x, w, group_sizes, plan=plan, bias=bias)


# ---------------------------------------------------------------------------
# Expert-parallel entry point
# ---------------------------------------------------------------------------

def _ref_ep(epilogue, x4, w):
    """Plain capacity-slot expert GEMM in fp32, differentiable by autograd:
    the backward of :class:`_EpFn` and the oracle of the tests."""
    if x4.is_cuda:
        disable_tf32()
    out = torch.einsum("neck,ekf->necf", x4.float(), w.float())
    return apply_epilogue(out, epilogue).to(x4.dtype)


def _ep_dispatch(axis, epilogue, x4, w):
    from repro_torch.runtime.shardlib import axis_size, current_mesh
    s = axis_size(current_mesh(), axis)
    nt, e, cap, k = x4.shape
    desc = GroupedGemmDescriptor(
        t=nt * e * cap, k=k, n=int(w.shape[-1]), num_experts=e,
        dtype=canonical_dtype(x4.dtype), epilogue=epilogue,
        mesh=MeshSpec(axis, s))
    return engine.dispatch(desc, x4, w, None).reshape(nt, e, cap, -1)


class _EpFn(torch.autograd.Function):
    """The reference's ``_ep_vjp``: forward the engine's mesh dispatch,
    backward autograd of :func:`_ref_ep` (on replicated operands every rank
    computes the whole gradient)."""

    @staticmethod
    def forward(ctx, axis, epilogue, x4, w):
        ctx.epilogue = epilogue
        ctx.save_for_backward(x4, w)
        return _ep_dispatch(axis, epilogue, x4, w)

    @staticmethod
    def backward(ctx, g):
        x4, w = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(True) for t in (x4, w)]
        with torch.enable_grad():
            out = _ref_ep(ctx.epilogue, *leaves)
            dx, dw = torch.autograd.grad(out, leaves, g.to(x4.dtype))
        return None, None, dx.to(x4.dtype), dw.to(w.dtype)


def expert_parallel_grouped_gemm(x4: torch.Tensor, w: torch.Tensor, *,
                                 axis: str = "model",
                                 epilogue: Optional[str] = None
                                 ) -> torch.Tensor:
    """Expert-parallel capacity-slot grouped GEMM.

    ``x4``: ``(n, e, cap, k)`` dispatch slots (``n`` token groups, ``e``
    experts, ``cap`` capacity); ``w``: ``(e, k, f)`` expert bank.  Returns
    ``(n, e, cap, f)``.  Under a mesh (``use_mesh``) whose ``axis``
    divides both ``n`` and ``e``, the call enters the engine as a MESH
    descriptor: the comm-charged planner picks gathered or distributed,
    and the strategy runs over the axis's process group with one launch
    per rank.  Off-mesh, or on shapes the axis does not divide, it is the
    ordinary differentiable :func:`grouped_gemm`.
    """
    from repro_torch.runtime.shardlib import axis_size, current_mesh
    nt, e, cap, k = x4.shape
    mesh = current_mesh()
    s = axis_size(mesh, axis) if mesh is not None else 1
    if s <= 1 or e % s or nt % s:
        xt = x4.transpose(0, 1).reshape(e * nt * cap, k)
        sizes = torch.full((e,), nt * cap, dtype=torch.int32,
                           device=x4.device)
        out = grouped_gemm(xt, w, sizes, epilogue=epilogue)
        return out.reshape(e, nt, cap, -1).transpose(0, 1)
    if torch.is_grad_enabled() and (x4.requires_grad or w.requires_grad):
        return _EpFn.apply(axis, epilogue, x4, w)
    return _ep_dispatch(axis, epilogue, x4, w)
