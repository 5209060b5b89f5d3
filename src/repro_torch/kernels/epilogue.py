"""Shared epilogue: dequant, then bias, then activation, on the
accumulator.

The CUDA kernels apply the same tail in ``epilogue()`` of
``kernels/gemm/csrc/gemm.cu`` (and the quantized kernels' epilogue in
``kernels/gemm/csrc/quant_sm90.cuh`` and ``quant_tile.cuh``); this is
its plain torch form, used by every plain version and by the ``torch``
backend.  ``dequant`` is the quant axis's f32 factor (``sa * sb`` for a
fully quantized product, the column scales alone for W8A16), applied to
the accumulator (int32 for int8 operands) in f32 before bias and
activation.  ``gelu`` is the tanh approximation (the reference's
``jax.nn.gelu`` default), ``silu`` is ``x * sigmoid(x)``, ``relu`` is
``max(x, 0)``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.descriptor import BIAS_EPILOGUES

# Epilogues with an activation, whose derivative needs the pre-activation.
ACTIVATIONS = ("gelu", "silu", "relu", "bias_gelu", "bias_silu")


def needs_bias(epilogue: Optional[str]) -> bool:
    """Does this epilogue consume a bias operand?"""
    return epilogue in BIAS_EPILOGUES


def apply_epilogue(x: torch.Tensor, epilogue: Optional[str],
                   bias_blk: Optional[torch.Tensor] = None,
                   dequant: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Lower one epilogue onto an accumulator block; ``bias_blk`` and
    ``dequant`` broadcast against it."""
    if dequant is not None:
        x = x.float() * dequant
    if needs_bias(epilogue):
        x = x + bias_blk.to(x.dtype)
    if epilogue in ("gelu", "bias_gelu"):
        x = F.gelu(x, approximate="tanh")
    elif epilogue in ("silu", "bias_silu"):
        x = x * torch.sigmoid(x)
    elif epilogue == "relu":
        x = torch.clamp_min(x, 0)
    return x

