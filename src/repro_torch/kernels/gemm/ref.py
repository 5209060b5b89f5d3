"""Plain torch oracles for the GEMM family:

    out = epilogue( C? + A @ op(B) )

with fp32 products and accumulation whatever the input dtype, and its
quantized form (:func:`ref_quant_gemm`), the reference's ``_xla_quant_gemm``.
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


def quant_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of quantized operands in the reference's exact-wide
    accumulator: int32 when ``a`` is int8 (summed in float64, which holds
    every int8 x int8 sum of up to 2^38 terms exactly, then converted:
    integer matmuls are not on every device), else fp32 (an e4m3 or int8
    operand widens exactly to fp32)."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int32)
    return a.float() @ b.float()


def ref_quant_gemm(a: torch.Tensor, b: torch.Tensor,
                   sa: Optional[torch.Tensor], sb: torch.Tensor, *,
                   layout: str = "nn", epilogue: Optional[str] = None,
                   bias: Optional[torch.Tensor] = None,
                   out_dtype=torch.float32) -> torch.Tensor:
    """Quantized GEMM oracle: ``epilogue(dequant(A @ op(B)))``.

    ``a (m, k)`` is int8 or e4m3 with row scales ``sa (m,)`` (full quant),
    or bf16 / fp32 with ``sa=None`` (W8A16); ``b`` is int8 or e4m3 with
    column scales ``sb (n,)``.  The accumulator is :func:`quant_product`'s;
    the dequant factor ``sa * sb`` (``sb`` alone for W8A16) multiplies it
    in fp32 before bias and activation."""
    assert layout in ("nn", "nt")
    b2 = b if layout == "nn" else b.transpose(-1, -2)
    acc = quant_product(a, b2)
    factor = sb.float()[None, :]
    if sa is not None:
        factor = sa.float()[:, None] * factor
    return apply_epilogue(acc, epilogue, bias, factor).to(out_dtype)
