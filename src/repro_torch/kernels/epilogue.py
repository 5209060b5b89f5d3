"""Shared epilogue: bias, then activation, on the fp32 accumulator.

The CUDA kernels apply the same tail in ``epilogue()`` of
``kernels/gemm/csrc/gemm.cu``; this is its plain torch form, used by
every plain version and by the ``torch`` backend.  ``gelu`` is the tanh
approximation (the reference's ``jax.nn.gelu`` default), ``silu`` is
``x * sigmoid(x)``, ``relu`` is ``max(x, 0)``.  The quant axis's dequant
stage is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.descriptor import BIAS_EPILOGUES


def needs_bias(epilogue: Optional[str]) -> bool:
    """Does this epilogue consume a bias operand?"""
    return epilogue in BIAS_EPILOGUES


def apply_epilogue(x: torch.Tensor, epilogue: Optional[str],
                   bias_blk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Lower one epilogue onto an (fp32) accumulator block; ``bias_blk``
    broadcasts against its last dim."""
    if needs_bias(epilogue):
        x = x + bias_blk.to(x.dtype)
    if epilogue in ("gelu", "bias_gelu"):
        x = F.gelu(x, approximate="tanh")
    elif epilogue in ("silu", "bias_silu"):
        x = x * torch.sigmoid(x)
    elif epilogue == "relu":
        x = torch.clamp_min(x, 0)
    return x
