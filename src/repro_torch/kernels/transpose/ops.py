"""Tile-transpose family: engine-planned tile edge, one launch per call.

The paper's §IV-C "transposing B" path: a GEMM whose B stores its
contraction dim strided (``layout="nt"``) can instead run as two passes,
a blocked panel transpose and then an ``nn`` GEMM,
``gemm(a, transpose(b))``.  :func:`transpose` is the first pass; a batched
transpose walks its batch as a grid dimension of the ONE launch, so it
counts exactly one.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import engine
from repro_torch.core.blocking import TransposePlan, plan_transpose
from repro_torch.core.descriptor import TransposeDescriptor
from repro_torch.kernels.transpose.kernel import transpose_tiles


def execute(desc: TransposeDescriptor, plan: TransposePlan,
            x) -> torch.Tensor:
    """Engine executor: one planned (batched) transpose, one launch."""
    engine.count_launches("transpose", 1)
    out = transpose_tiles(x if desc.batch else x[None], bt=plan.bt)
    return out if desc.batch else out[0]


engine.register_family("transpose", planner=plan_transpose, execute=execute)


def transpose(x: torch.Tensor, *, bt: Optional[int] = None) -> torch.Tensor:
    """Blocked 2-D (or batched) transpose of the last two axes.

    A rank-3 input walks its batch as a grid dimension of ONE launch.
    ``bt=None`` takes the machine model's planned tile edge
    (:func:`~repro_torch.core.blocking.plan_transpose`)."""
    desc = TransposeDescriptor.from_operands(x)
    plan = TransposePlan(desc, bt) if bt is not None else None
    return engine.dispatch(desc, x, plan=plan)
