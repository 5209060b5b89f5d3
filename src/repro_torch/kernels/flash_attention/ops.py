"""Flash-attention family: engine-planned blocks, cached build, forward and
backward.

Executes a :class:`~repro_torch.core.blocking.FlashPlan` one of two ways,
chosen by ``engine.resolve_fused``:

  * **fused** -- ONE launch of ``flash_fwd_fused`` walks the plan's
    causal-aware :class:`~repro_torch.core.schedule.FlashTileSchedule`
    (kept on the device with the executor by the kernel cache);
  * **dense grid** -- ONE launch of ``flash_fwd_dense`` over the
    (q-block, batch-head) grid, skipping blocks past the diagonal.

Either counts one launch.  The backward family ``flash_attention_bwd``
is ONE launch of ``flash_bwd_fused`` over the same table.  The paged
decode family ``flash_decode`` is ONE launch of ``flash_decode`` per
decode step, over the runtime table of the step's block tables and
lengths (:func:`paged_decode_attention`); KV-int8 pools ride the same
launch with their per-token scales.  Gradients
flow through :class:`_FlashFn` (the reference's ``_flash_vjp``): when the
scheduled backward is legal its forward runs ``flash_fwd_fused`` with the
LSE rows and its backward dispatches the backward descriptor; otherwise
(``fused="off"`` or an illegal backward) the forward is the ordinary
dispatch and the backward differentiates :func:`ref_flat` in torch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import engine
from repro_torch.core.blocking import (FlashDecodePlan, FlashPlan,
                                       flash_bwd_fused_legal, plan_flash,
                                       plan_flash_bwd, plan_flash_decode)
from repro_torch.core.config import get_config, use
from repro_torch.core.descriptor import (FlashBwdDescriptor,
                                         FlashDecodeDescriptor,
                                         FlashDescriptor)
from repro_torch.core.machine import canonical_dtype
from repro_torch.core.schedule import plan_launches
from repro_torch.kernels.flash_attention.kernel import (FlashDecode,
                                                        FusedFlash,
                                                        flash_bwd_fused,
                                                        flash_decode,
                                                        flash_fwd_dense,
                                                        flash_fwd_fused)
from repro_torch.kernels.flash_attention.ref import ref_flat


def _fused_executor(desc: FlashDescriptor, plan: FlashPlan, device):
    """Build (and cache) one plan's fused kernel state on ``device``; the
    key starts with the descriptor's family, so forward and backward
    plans cache apart."""
    key = desc.cache_key() + ("fused", plan.block_q, plan.block_k, str(device))
    return engine.build_cached(key, lambda: FusedFlash(plan.tile_schedule(),
                                                       device))


def execute(desc: FlashDescriptor, plan: FlashPlan, qf, kf, vf) -> torch.Tensor:
    """Engine executor: one planned flash attention forward on (BH, s, d)."""
    fused = engine.resolve_fused(plan)
    engine.count_launches("flash_attention", plan_launches(plan, fused))
    qf, kf, vf = qf.contiguous(), kf.contiguous(), vf.contiguous()
    if fused:
        return flash_fwd_fused(_fused_executor(desc, plan, qf.device),
                               qf, kf, vf)
    return flash_fwd_dense(qf, kf, vf, block_q=plan.block_q,
                           block_k=plan.block_k, causal=desc.causal)


engine.register_family("flash_attention", planner=plan_flash, execute=execute)


def execute_bwd(desc: FlashBwdDescriptor, plan: FlashPlan, qf, kf, vf, o, do,
                lse):
    """Engine executor: one planned flash attention backward -> fp32
    ``(dq, dk, dv)``.  Single lowering, the scheduled walk: an illegal
    backward never reaches the engine (:class:`_FlashFn` falls back to
    differentiating the reference first)."""
    engine.count_launches("flash_attention_bwd", 1)
    exe = _fused_executor(desc, plan, qf.device)
    return flash_bwd_fused(exe, qf, kf, vf, o.contiguous(), do.contiguous(),
                           lse)


engine.register_family("flash_attention_bwd", planner=plan_flash_bwd,
                       execute=execute_bwd)


def execute_decode(desc: FlashDecodeDescriptor, plan: FlashDecodePlan, q,
                   k_pool, v_pool, block_tables, lengths, *, k_scale=None,
                   v_scale=None) -> torch.Tensor:
    """Engine executor: one planned paged decode-attention step.

    The kernel state is cached on the pool geometry alone; the batch
    composition (block tables and lengths) is rewritten into its device
    tile table each call, so a churning batch re-enters the same state.
    KV-int8 pools (``k_scale``/``v_scale``, ``(pages, page_size)`` f32)
    ride the same launch."""
    engine.count_launches("flash_decode", 1)
    kv_quant = k_scale is not None
    key = desc.cache_key() + ("decode", canonical_dtype(k_pool.dtype),
                              kv_quant, str(q.device))
    exe = engine.build_cached(key, lambda: FlashDecode(plan.tile_schedule(),
                                                       q.device))
    exe.update(block_tables, lengths)
    if kv_quant:
        k_scale, v_scale = k_scale.float(), v_scale.float()
    return flash_decode(exe, q.contiguous(), k_pool, v_pool, k_scale,
                        v_scale)


engine.register_family("flash_decode", planner=plan_flash_decode,
                       execute=execute_decode)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """One decode step against a paged KV pool.

    q: (S, h, hd), one query row per decode slot; k_pool/v_pool: (pages,
    page_size, hkv, hd); block_tables: (S, max_blocks) int32 page ids;
    lengths: (S,) live KV length per slot (0 = inactive: the output row is
    zeros).  Returns (S, h, hd).  With int8 pools, ``k_scale``/``v_scale``
    are the per-token dequant rows ``(pages, page_size)`` f32: the same
    launch count, the scales folded into the score and PV algebra."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    desc = FlashDecodeDescriptor.from_operands(q, k_pool, block_tables)
    return engine.dispatch(desc, q, k_pool, v_pool, block_tables, lengths,
                           k_scale=k_scale, v_scale=v_scale)


def _flat_desc(causal: bool, qf, kf) -> FlashDescriptor:
    return FlashDescriptor(batch_heads=qf.shape[0], sq=qf.shape[1],
                           sk=kf.shape[1], d=qf.shape[2], causal=causal,
                           dtype=canonical_dtype(qf.dtype))


class _FlashFn(torch.autograd.Function):
    """Differentiable flattened flash attention (the reference's
    ``_flash_vjp``).  The branch is decided in the forward, under the
    configuration in force there, and kept for the backward."""

    @staticmethod
    def forward(ctx, causal, plan, qf, kf, vf):
        desc = _flat_desc(causal, qf, kf)
        plan = plan or engine.plan_for(desc)
        fused_ok = (get_config().fused != "off"
                    and flash_bwd_fused_legal(FlashBwdDescriptor.from_forward(
                        desc), get_config().machine)
                    and engine.resolve_fused(plan))
        ctx.causal, ctx.fused = causal, fused_ok
        if not fused_ok:
            ctx.save_for_backward(qf, kf, vf)
            return engine.dispatch(desc, qf, kf, vf, plan=plan)
        # The forward with the LSE rows drained for the backward walk: the
        # same schedule and online-softmax math, one launch.
        qf, kf, vf = qf.contiguous(), kf.contiguous(), vf.contiguous()
        if engine.traced_call(desc, (qf, kf, vf)):
            o = desc.meta_output()
            lse = torch.empty(qf.shape[:2], dtype=torch.float32,
                              device="meta")
        else:
            engine.count_launches("flash_attention", 1)
            with engine.engine_work():
                o, lse = flash_fwd_fused(
                    _fused_executor(desc, plan, qf.device), qf, kf, vf,
                    return_lse=True)
        ctx.save_for_backward(qf, kf, vf, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        if ctx.fused:
            qf, kf, vf, o, lse = ctx.saved_tensors
            bdesc = FlashBwdDescriptor.from_forward(
                _flat_desc(ctx.causal, qf, kf))
            dq, dk, dv = engine.dispatch(bdesc, qf, kf, vf, o,
                                         g.to(qf.dtype), lse)
        else:
            qf, kf, vf = (t.detach().requires_grad_()
                          for t in ctx.saved_tensors)
            with torch.enable_grad():
                out = ref_flat(ctx.causal, qf, kf, vf)
                dq, dk, dv = torch.autograd.grad(out, (qf, kf, vf),
                                                 g.to(qf.dtype))
        return (None, None, dq.to(qf.dtype), dk.to(kf.dtype),
                dv.to(vf.dtype))


def flash_attention(q, k, v, *, causal: bool = True,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    fused: Optional[bool] = None) -> torch.Tensor:
    """q/k/v: (b, s, h, d) -> (b, s, h, d), differentiable.

    ``block_q``/``block_k`` pin the forward plan's blocks; ``fused=True/
    False`` pins the scheduled or dense-grid lowering for this call (and,
    with it, whether the backward is the scheduled walk).  Without
    gradients the forward is one ordinary dispatch, with no LSE.
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qf = q.transpose(1, 2).reshape(b * h, sq, d)
    kf = k.transpose(1, 2).reshape(b * h, sk, d)
    vf = v.transpose(1, 2).reshape(b * h, sk, d)
    desc = FlashDescriptor.from_operands(q, k, causal=causal)
    plan = None
    if block_q is not None or block_k is not None:
        auto = engine.plan_for(desc)
        plan = FlashPlan(desc, block_q or auto.block_q,
                         block_k or auto.block_k, fused=auto.fused)
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (qf, kf, vf))
    with use(fused=None if fused is None else ("on" if fused else "off")):
        if grad:
            out = _FlashFn.apply(causal, plan, qf, kf, vf)
        else:
            out = engine.dispatch(desc, qf, kf, vf, plan=plan)
    return out.reshape(b, h, sq, d).transpose(1, 2)
