"""Blocked GEMM family: engine registration, lowering choice, public op.

Executes a :class:`~repro_torch.core.blocking.BlockingPlan` one of two
ways, chosen by ``engine.resolve_fused`` (``config.fused`` or the plan's
bit):

  * **fused** -- the whole plan (every region's tiles and the batch) in
    ONE launch of ``gemm_fused`` over the plan's tile table, which the
    kernel cache keeps on the device with the executor;
  * **multi-launch** -- one ``gemm_region`` launch per plan region, each
    writing its rectangle straight into the output.

Both report their launch counts through ``engine.count_launches``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import engine
from repro_torch.core.blocking import BlockingPlan, plan_gemm
from repro_torch.core.config import use
from repro_torch.core.descriptor import GemmDescriptor, check_bias
from repro_torch.core.machine import torch_dtype
from repro_torch.core.schedule import plan_launches
from repro_torch.kernels.gemm.kernel import (K_PANEL, FusedGemm, gemm_fused,
                                             gemm_region)


def _fused_executor(desc: GemmDescriptor, plan: BlockingPlan, device):
    """Build (and cache) one plan's fused kernel state on ``device``."""
    key = desc.cache_key() + ("fused", plan.regions, plan.bk, str(device))
    return engine.build_cached(key, lambda: FusedGemm(plan.tile_schedule(),
                                                      device))


def execute(desc: GemmDescriptor, plan: BlockingPlan, a, b, *, bias=None,
            c=None) -> torch.Tensor:
    """Engine executor: run one planned (possibly batched) GEMM."""
    check_bias(desc.epilogue, bias)
    if desc.edge != "mask":
        raise NotImplementedError(f"edge={desc.edge!r} is not ported; the "
                                  f"kernels mask edges")
    if a.is_cuda and plan.bk != K_PANEL:
        raise NotImplementedError(f"plan bk={plan.bk}, but the CUDA GEMM's "
                                  f"K panel is {K_PANEL}; plan with the "
                                  f"H100_SXM machine model")
    fused = engine.resolve_fused(plan)
    out_dtype = torch_dtype(desc.out_dtype)
    a3, b3 = (a, b) if desc.batch else (a[None], b[None])
    c3 = c if c is None or desc.batch else c[None]
    a3, b3 = a3.contiguous(), b3.contiguous()
    c3 = None if c3 is None else c3.contiguous()
    bias = None if bias is None else bias.contiguous()
    kw = dict(layout=desc.layout, epilogue=desc.epilogue, bias=bias, c=c3)
    engine.count_launches("gemm", plan_launches(plan, fused))
    if fused:
        out = gemm_fused(_fused_executor(desc, plan, a.device), a3, b3,
                         out_dtype=out_dtype, **kw)
    else:
        out = torch.empty((a3.shape[0], desc.m, desc.n), dtype=out_dtype,
                          device=a.device)
        for region in plan.regions:
            gemm_region(a3, b3, out, region, **kw)
    return out if desc.batch else out[0]


engine.register_family("gemm", planner=plan_gemm, execute=execute)


def gemm(a, b, c: Optional[torch.Tensor] = None, *, layout: str = "nn",
         epilogue: Optional[str] = None, bias: Optional[torch.Tensor] = None,
         out_dtype=None, fused: Optional[bool] = None) -> torch.Tensor:
    """Planned, shape-specialised (batched) GEMM via the engine.

    ``a``: (..., M, K); ``b``: (..., K, N) for layout "nn" or (..., N, K)
    for "nt"; optional ``c`` of shape (..., M, N).  ``fused=True/False``
    pins the single-launch or multi-launch lowering for this call.
    """
    desc = GemmDescriptor.from_operands(
        a, b, layout=layout, accumulate=c is not None, epilogue=epilogue,
        out_dtype=out_dtype or a.dtype)
    if fused is None:
        return engine.dispatch(desc, a, b, bias=bias, c=c)
    with use(fused="on" if fused else "off"):
        return engine.dispatch(desc, a, b, bias=bias, c=c)
