"""Mixture-of-Experts with top-k routing (GShard/T5X-style grouped dispatch).

The reference's ``models/moe.py``, routing included: tokens are processed
in groups of ``cfg.moe_group`` (at least 32 groups, so decode shapes keep
a group dimension), routed in fp32 (softmax, top-k with ties to the lower
index, renormalised), given capacity slots in k-major priority (every
top-1 choice beats any top-2) and sent through the dispatch / combine
one-hot einsums.  Dropped tokens pass through the residual stream only.
Returns the GShard auxiliary load-balancing loss beside the output.

The expert FFNs are batches of small GEMMs over uniform capacity slots:
under the ``engine`` backend the three expert GEMMs run through the
grouped-GEMM family (the activation fused into the gate's epilogue), with
its backward kernel in training; under ``torch`` they are the reference's
``einsum``.  The dispatch and combine products stay ``torch.einsum``, as
they are dense einsums outside any kernel in the reference.

Under a mesh whose "model" axis divides the experts (expert parallelism)
and the token groups, the engine backend runs the expert GEMMs through
:func:`~repro_torch.kernels.grouped_gemm.expert_parallel_grouped_gemm`:
the comm-charged planner picks gathered or distributed, and the ranks
split the expert work between them.  The sharding annotations are the
reference's ``shard_activation`` calls, which check the axes and keep the
activations replicated.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.config import get_config
from repro_torch.core.machine import torch_dtype
from repro_torch.core.trace import span
from repro_torch.kernels.epilogue import apply_epilogue
from repro_torch.models.common import Init, Linear, cast_param
from repro_torch.runtime.shardlib import (axis_size, current_mesh,
                                          shard_activation)

_MAX_BATCH_SHARDS = 32  # the reference's pod x data on its largest mesh


class ExpertBank(nn.Module):
    """One stacked weight per expert, ``w: (E, d_in, d_out)``."""

    def __init__(self, shape, fan_in: int, init: Init):
        super().__init__()
        self.w = nn.Parameter(init.scaled(shape, fan_in))


class MoE(nn.Module):
    """Router ``(d, E)`` plus expert banks ``w_up``/``w_gate`` ``(E, d, f)``
    and ``w_down`` ``(E, f, d)`` (the reference's leaves and scales)."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.cfg = cfg
        self.router = Linear(d, e, init)
        if cfg.mlp_gated:
            self.w_gate = ExpertBank((e, d, f), d, init)
        self.w_up = ExpertBank((e, d, f), d, init)
        self.w_down = ExpertBank((e, f, d), f, init)

    def forward(self, x):
        """x: (b, s, d) -> (y, aux_loss)."""
        return moe_apply(self, self.cfg, x)


def _expert_gemm_grouped(x4, w, epilogue=None):
    """(n, e, cap, k) x (e, k, f) -> (n, e, cap, f) through the engine's
    grouped-GEMM family: the capacity slots are uniform, so the ragged
    split is E equal groups of n * cap rows, sorted by expert after a
    transpose.  Differentiable (the family's backward kernel)."""
    from repro_torch.kernels.grouped_gemm import grouped_gemm
    n, e, cap, k = x4.shape
    xt = x4.transpose(0, 1).reshape(e * n * cap, k)
    sizes = torch.full((e,), n * cap, dtype=torch.int32, device=x4.device)
    out = grouped_gemm(xt, w, sizes, epilogue=epilogue)
    return out.reshape(e, n, cap, -1).transpose(0, 1)


def _einsum_gemm(x4, w, epilogue=None):
    """The reference's XLA expert GEMM: an einsum, the activation after it
    in the output's dtype."""
    return apply_epilogue(torch.einsum("neck,ekf->necf", x4, w), epilogue)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties broken
    toward the lower index (a stable descending sort keeps equal values in
    index order; ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(ff: MoE, cfg, xg, cap: int, dt):
    """Routing and capacity assignment of ``xg`` (n, g, d): the dispatch
    and combine one-hots (n, g, e, cap) in ``dt`` and the aux loss."""
    n, g, _ = xg.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok

    # --- routing (fp32) ---------------------------------------------------
    logits = torch.einsum("ngd,de->nge", xg.float(), ff.router.w.float())
    probs = torch.softmax(logits, dim=-1)  # (n, g, e)
    gate_vals, gate_idx = top_k(probs, k)  # (n, g, k)
    if cfg.moe_renormalize:
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    # GShard aux loss.
    one_hot = torch.nn.functional.one_hot
    me = probs.mean(dim=(0, 1))
    ce = one_hot(gate_idx[..., 0], e).float().mean(dim=(0, 1))
    aux_loss = e * (me * ce).sum()

    # --- capacity assignment (k-major priority) ----------------------------
    mask = one_hot(gate_idx, e).float()  # (n, g, k, e)
    mask_flat = mask.transpose(1, 2).reshape(n, k * g, e)
    pos_flat = torch.cumsum(mask_flat, dim=1) - 1.0
    pos = pos_flat.reshape(n, k, g, e).transpose(1, 2)  # (n, g, k, e)
    keep = mask * (pos < cap)
    slot = (pos * keep).sum(-1).long()  # (n, g, k)
    slot_oh = one_hot(slot, cap).float() * keep.sum(-1, keepdim=True)

    dispatch = torch.einsum("ngke,ngkc->ngec", keep, slot_oh).to(dt)
    combine = torch.einsum("ngke,ngkc->ngec", keep * gate_vals[..., None],
                           slot_oh).to(dt)
    return dispatch, combine, aux_loss


def moe_apply(ff: MoE, cfg, x):
    """x: (b, s, d) -> (y (b, s, d), aux_loss fp32 scalar).  Under a
    profiler the call is a ``moe`` span that carries its tokens, groups,
    capacity rows (what the expert GEMMs run over) and routed rows."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    t = x.shape[0] * x.shape[1]
    g = min(cfg.moe_group, max(1, t // _MAX_BATCH_SHARDS))
    while t % g:
        g -= 1
    n = t // g
    cap = int(cfg.capacity_factor * g * k / e)
    cap = max(8, -(-cap // 8) * 8)
    with span("moe", tokens=t, groups=n, capacity_rows=n * e * cap,
              routed_rows=t * k):
        return _moe_grouped(ff, cfg, x, g, n, cap)


def _moe_grouped(ff: MoE, cfg, x, g: int, n: int, cap: int):
    """:func:`moe_apply` over ``n`` groups of ``g`` tokens with ``cap``
    capacity slots an expert a group."""
    dt = torch_dtype(cfg.dtype)
    b, s, d = x.shape
    e, t = cfg.num_experts, b * s

    mesh = current_mesh()
    msize = axis_size(mesh, "model") if mesh is not None else 1
    ep = msize > 1 and e % msize == 0  # expert parallelism when E divides

    xg = x.reshape(n, g, d).to(dt)
    xg = shard_activation(xg, (("pod", "data"), None, None))

    with span("moe.route"):
        dispatch, combine, aux_loss = _route(ff, cfg, xg, cap, dt)

    # The reference's two layouts: expert parallelism (E divides "model":
    # slots on their experts' ranks, weights never move), or the TP-f
    # fallback (tokens data-sharded, the expert FFN dim on "model").  Under
    # the engine, expert parallelism enters the engine as a mesh
    # descriptor when the token groups divide the axis too.
    bd = ("pod", "data")
    engine_backend = get_config().backend == "engine"
    ep_mesh = ep and engine_backend and n % msize == 0
    if ep:
        dispatch = shard_activation(dispatch, (bd, None, "model", None))
        combine = shard_activation(combine, (bd, None, "model", None))
        if ep_mesh:
            xin_spec = h_spec = ("model", None, None, None)
        else:
            xin_spec = h_spec = (bd, "model", None, None)
    elif t <= 2048:
        xin_spec = (None, None, None, None)
        h_spec = (None, None, None, "model")
    else:
        xin_spec = (bd, None, None, None)
        h_spec = (bd, None, None, "model")

    # --- expert compute (batched small GEMMs over the E dim) --------------
    if engine_backend:
        if ep_mesh:
            from repro_torch.kernels.grouped_gemm import \
                expert_parallel_grouped_gemm

            def mm(x4, w, epilogue=None):
                return expert_parallel_grouped_gemm(x4, w, axis="model",
                                                    epilogue=epilogue)
        else:
            mm = _expert_gemm_grouped
    else:
        mm = _einsum_gemm
    xin = torch.einsum("ngec,ngd->necd", dispatch, xg)  # (n, e, cap, d)
    xin = shard_activation(xin, xin_spec)
    w_up = cast_param(ff.w_up.w, dt)
    w_down = cast_param(ff.w_down.w, dt)
    if cfg.mlp_gated:
        up = shard_activation(mm(xin, w_up), h_spec)
        gate = shard_activation(
            mm(xin, cast_param(ff.w_gate.w, dt), epilogue=cfg.mlp_act),
            h_spec)
        h = gate * up
    else:
        h = shard_activation(mm(xin, w_up, epilogue=cfg.mlp_act), h_spec)
    y_slots = shard_activation(mm(h, w_down), xin_spec)
    y = torch.einsum("ngec,necd->ngd", combine, y_slots)
    return y.reshape(b, s, d), aux_loss
