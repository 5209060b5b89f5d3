"""Plain torch oracle for the GEMM family:

    out = epilogue( C? + A @ op(B) )

with fp32 products and accumulation whatever the input dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.epilogue import apply_epilogue


def ref_gemm(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None,
             *, layout: str = "nn", epilogue: Optional[str] = None,
             bias: Optional[torch.Tensor] = None,
             out_dtype=None) -> torch.Tensor:
    """Oracle: fp32-accumulated (batched) GEMM with optional epilogue."""
    assert layout in ("nn", "nt")
    b32 = b.float() if layout == "nn" else b.float().transpose(-1, -2)
    acc = torch.matmul(a.float(), b32)
    if c is not None:
        acc = acc + c.float()
    return apply_epilogue(acc, epilogue, bias).to(out_dtype or a.dtype)
