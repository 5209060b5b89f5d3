"""SSD chunked-scan family: engine-planned dispatch of the intra-chunk
ladder and the whole scan, forward and backward.

Two public surfaces over one engine family:

  * :func:`ssd_chunk_diag` -- the intra-chunk ladder on a flat ``(G, Q,
    ·)`` group batch (``desc.chunks == 0``): ONE ``ssd_chunk_diag``
    launch;
  * :func:`ssd_chunk_scan` -- the whole chunked scan on a ``(G, chunks,
    Q, ·)`` layout, returning outputs *and* the final state.  Resolved by
    ``engine.resolve_fused``: the fused lowering is ONE ``ssd_scan_fused``
    launch with the ``(p, n)`` state carried across the chunk walk; the
    fallback is ONE ``ssd_chunk_diag`` launch plus the inter-chunk
    recurrence in torch ops (a chunk loop where the reference runs an
    associative scan).  Either counts one launch.

The backward family ``ssd_chunk_bwd`` is ONE ``ssd_scan_bwd`` launch.
Gradients flow through :class:`_SsdFn` (the reference's ``_ssd_vjp``):
when the reverse walk is legal its forward runs ``ssd_scan_fused`` with
the entering states and its backward dispatches the backward descriptor;
otherwise (``fused="off"`` or an illegal backward) the forward is the
ordinary dispatch and the backward differentiates
:func:`~repro_torch.kernels.ssd_chunk.ref.ref_ssd_chunk_scan` in torch.
"""
from __future__ import annotations

import torch

from repro_torch.core import engine
from repro_torch.core.blocking import (SsdChunkPlan, plan_ssd, plan_ssd_bwd,
                                       ssd_bwd_fused_legal)
from repro_torch.core.config import get_config
from repro_torch.core.descriptor import (SsdChunkBwdDescriptor,
                                         SsdChunkDescriptor)
from repro_torch.core.schedule import plan_launches
from repro_torch.kernels import disable_tf32
from repro_torch.kernels.ssd_chunk.kernel import (ssd_chunk_diag as
                                                  _diag_kernel,
                                                  ssd_scan_bwd,
                                                  ssd_scan_fused)
from repro_torch.kernels.ssd_chunk.ref import ref_ssd_chunk_scan


def _contiguous(*ts):
    return tuple(t.contiguous() for t in ts)


def _scan_fallback(c, b, l, x, decay_in, decay_out, s0):
    """Non-fused scan: the diag kernel for y_diag, torch ops for the
    inter-chunk recurrence (per-chunk states in fp32)."""
    if c.is_cuda:
        disable_tf32()
    g, nc, q, n = c.shape
    p = x.shape[-1]
    y_diag = _diag_kernel(c.reshape(g * nc, q, n), b.reshape(g * nc, q, n),
                          l.reshape(g * nc, q, q),
                          x.reshape(g * nc, q, p)).reshape(g, nc, q, p)
    # per-chunk state contributions bx[g, c] = Bᵀ · round_x(xdt ⊙ decay_out)
    xw = (x.float() * decay_out[..., None]).to(x.dtype)
    bx = torch.einsum("gcqn,gcqp->gcpn", b.float(), xw.float())
    dec = decay_in[..., -1].float()  # whole-chunk decay
    state = s0.float()
    s_prev = []
    for ci in range(nc):
        s_prev.append(state)
        state = state * dec[:, ci, None, None] + bx[:, ci]
    y_off = torch.einsum("gcqn,gcpn->gcqp", c.float(),
                         torch.stack(s_prev, dim=1)) * decay_in[..., None]
    return (y_diag.float() + y_off).to(x.dtype), state


def execute(desc: SsdChunkDescriptor, plan: SsdChunkPlan, c, b, l, x,
            *rest):
    """Engine executor: run one planned SSD dispatch (either form)."""
    if not desc.chunks:
        engine.count_launches("ssd_chunk", 1)
        return _diag_kernel(*_contiguous(c, b, l, x))
    decay_in, decay_out, s0 = rest
    fused = engine.resolve_fused(plan)
    engine.count_launches("ssd_chunk", plan_launches(plan, fused))
    ops = _contiguous(c, b, l, x, decay_in, decay_out, s0)
    return ssd_scan_fused(*ops) if fused else _scan_fallback(*ops)


engine.register_family("ssd_chunk", planner=plan_ssd, execute=execute)


def execute_bwd(desc: SsdChunkBwdDescriptor, plan: SsdChunkPlan, c, b, l, x,
                decay_in, decay_out, states, dy, dsf):
    """Engine executor: one planned SSD scan backward -> fp32 cotangents.
    Single lowering, the reverse walk: an illegal backward never reaches
    the engine (:class:`_SsdFn` differentiates the reference first)."""
    engine.count_launches("ssd_chunk_bwd", 1)
    return ssd_scan_bwd(*_contiguous(c, b, l, x, decay_in, decay_out, states,
                                     dy, dsf))


engine.register_family("ssd_chunk_bwd", planner=plan_ssd_bwd,
                       execute=execute_bwd)


def _scan_dispatch(c, b, l, x, decay_in, decay_out, s0):
    desc = SsdChunkDescriptor.from_scan_operands(c, x)
    return engine.dispatch(desc, c, b, l, x, decay_in, decay_out, s0)


class _SsdFn(torch.autograd.Function):
    """Differentiable chunked SSD scan (the reference's ``_ssd_vjp``).  The
    branch is decided in the forward, under the configuration in force
    there, and kept for the backward."""

    @staticmethod
    def forward(ctx, c, b, l, x, decay_in, decay_out, s0):
        cfg = get_config()
        desc = SsdChunkDescriptor.from_scan_operands(c, x)
        fused_ok = (cfg.fused != "off"
                    and ssd_bwd_fused_legal(
                        SsdChunkBwdDescriptor.from_forward(desc), cfg.machine)
                    and engine.resolve_fused(engine.plan_for(desc)))
        ctx.fused = fused_ok
        if not fused_ok:
            ctx.save_for_backward(c, b, l, x, decay_in, decay_out, s0)
            return _scan_dispatch(c, b, l, x, decay_in, decay_out, s0)
        # The forward with the entering states drained for the reverse
        # walk: the same carried-state math, one launch.
        ops = _contiguous(c, b, l, x, decay_in, decay_out, s0)
        if engine.traced_call(desc, ops):
            y, sf = desc.meta_output()
            states = torch.empty((desc.groups, desc.chunks, desc.p, desc.n),
                                 dtype=torch.float32, device="meta")
        else:
            engine.count_launches("ssd_chunk", 1)
            with engine.engine_work():
                y, sf, states = ssd_scan_fused(*ops, return_states=True)
        ctx.save_for_backward(*ops[:6], states)
        return y, sf

    @staticmethod
    def backward(ctx, dy, dsf):
        if ctx.fused:
            c, b, l, x, decay_in, decay_out, states = ctx.saved_tensors
            bdesc = SsdChunkBwdDescriptor.from_forward(
                SsdChunkDescriptor.from_scan_operands(c, x))
            grads = engine.dispatch(bdesc, c, b, l, x, decay_in, decay_out,
                                    states, dy.float(), dsf.float())
        else:
            ops = tuple(t.detach().requires_grad_()
                        for t in ctx.saved_tensors)
            c, b, l, x, decay_in, decay_out, _ = ops
            with torch.enable_grad():
                y, sf = ref_ssd_chunk_scan(*ops)
                grads = torch.autograd.grad((y, sf), ops,
                                            (dy.to(x.dtype), dsf.float()))
        dc, db, dl, dx, ddi, ddo, ds0 = grads
        return (dc.to(c.dtype), db.to(b.dtype), dl.to(l.dtype),
                dx.to(x.dtype), ddi.to(decay_in.dtype),
                ddo.to(decay_out.dtype), ds0.float())


def ssd_chunk_diag(c_mat, b_mat, l_mat, xdt):
    """Batched intra-chunk SSD: (G,Q,n) x2, (G,Q,Q), (G,Q,p) -> (G,Q,p)."""
    desc = SsdChunkDescriptor.from_operands(c_mat, xdt)
    return engine.dispatch(desc, c_mat, b_mat, l_mat, xdt)


def ssd_chunk_scan(c_mat, b_mat, l_mat, xdt, decay_in, decay_out, s0):
    """Whole chunked SSD scan via the engine.

    ``c_mat``/``b_mat``: (G, NC, Q, n); ``l_mat``: (G, NC, Q, Q); ``xdt``:
    (G, NC, Q, p); ``decay_in``/``decay_out``: (G, NC, Q) fp32
    (``exp(da_cs)`` and ``exp(da_tot - da_cs)``); ``s0``: (G, p, n) fp32.
    Returns ``(y: (G, NC, Q, p), s_final: (G, p, n))``.  Differentiable:
    with gradients on, training flows through :class:`_SsdFn` onto the
    reverse-walk kernel.
    """
    ops = (c_mat, b_mat, l_mat, xdt, decay_in, decay_out, s0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        return _SsdFn.apply(*ops)
    return _scan_dispatch(*ops)
