"""Flash-attention family (forward): engine-planned blocks, cached build.

Executes a :class:`~repro_torch.core.blocking.FlashPlan` one of two ways,
chosen by ``engine.resolve_fused``:

  * **fused** -- ONE launch of ``flash_fwd_fused`` walks the plan's
    causal-aware :class:`~repro_torch.core.schedule.FlashTileSchedule`
    (kept on the device with the executor by the kernel cache);
  * **dense grid** -- ONE launch of ``flash_fwd_dense`` over the
    (q-block, batch-head) grid, skipping blocks past the diagonal.

Either counts one launch.  The backward kernels are not ported: calling
this with gradients enabled on inputs that require them raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import engine
from repro_torch.core.blocking import FlashPlan, plan_flash
from repro_torch.core.config import use
from repro_torch.core.descriptor import FlashDescriptor
from repro_torch.core.schedule import plan_launches
from repro_torch.kernels.flash_attention.kernel import (FusedFlash,
                                                        flash_fwd_dense,
                                                        flash_fwd_fused)


def _fused_executor(desc: FlashDescriptor, plan: FlashPlan, device):
    """Build (and cache) one plan's fused kernel state on ``device``."""
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


def flash_attention(q, k, v, *, causal: bool = True,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    fused: Optional[bool] = None) -> torch.Tensor:
    """q/k/v: (b, s, h, d) -> (b, s, h, d).

    ``block_q``/``block_k`` pin the plan's blocks; ``fused=True/False``
    pins the scheduled or dense-grid lowering for this call.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("the flash-attention backward is not "
                                  "ported; run under torch.no_grad()")
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
    if fused is None:
        out = engine.dispatch(desc, qf, kf, vf, plan=plan)
    else:
        with use(fused="on" if fused else "off"):
            out = engine.dispatch(desc, qf, kf, vf, plan=plan)
    return out.reshape(b, h, sq, d).transpose(1, 2)
