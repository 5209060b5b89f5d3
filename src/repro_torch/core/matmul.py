"""Public matmul dispatch -- the port's BLAS front door.

Every dense layer in ``repro_torch.models`` calls :func:`matmul`.  Under
``backend="engine"`` it routes through the engine (descriptor -> plan ->
hand-written Hopper GEMM); under ``backend="torch"`` through
``torch.matmul`` (cuBLAS on the card), the vendor baseline.  Both
accumulate in fp32 and apply the epilogue before the output cast.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import disable_tf32
from repro_torch.kernels.epilogue import apply_epilogue

from .config import get_config
from .descriptor import GemmDescriptor, check_bias


def matmul(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None,
           *, layout: str = "nn", epilogue: Optional[str] = None,
           bias: Optional[torch.Tensor] = None,
           out_dtype=None) -> torch.Tensor:
    """Planned (batched) GEMM: ``out = epilogue(c? + a @ op(b))``.

    ``a``: (..., M, K).  ``b``: (K, N) | (nb, K, N) for layout "nn",
    (N, K) | (nb, N, K) for "nt".  Leading dims of ``a`` are flattened
    into M when ``b`` is rank-2 (the dense-layer case).
    """
    be = get_config().backend
    out_dtype = out_dtype or a.dtype
    check_bias(epilogue, bias)
    if be == "torch":
        return _torch_gemm(a, b, c, layout, epilogue, bias, out_dtype)

    lead = None
    if b.ndim == 2 and a.ndim > 2:
        lead = a.shape[:-1]
        a = a.reshape(-1, a.shape[-1])
        if c is not None:
            c = c.reshape(-1, c.shape[-1])
    out = _EngineGemm.apply(a, b, c, bias, layout, epilogue, out_dtype)
    if lead is not None:
        out = out.reshape(*lead, out.shape[-1])
    return out


class _EngineGemm(torch.autograd.Function):
    """Engine GEMM with a differentiable front: the forward is the planned
    kernel dispatch, the backward differentiates the plain torch oracle
    (dense GEMM has no kernel of its own for the backward)."""

    @staticmethod
    def forward(ctx, a, b, c, bias, layout, epilogue, out_dtype):
        from repro_torch.core import engine
        desc = GemmDescriptor.from_operands(
            a, b, layout=layout, accumulate=c is not None, epilogue=epilogue,
            out_dtype=out_dtype)
        ctx.save_for_backward(a, b, c, bias)
        ctx.opts = (layout, epilogue, out_dtype)
        return engine.dispatch(desc, a, b, bias=bias, c=c)

    @staticmethod
    def backward(ctx, g):
        layout, epilogue, out_dtype = ctx.opts
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad[:4])]
        wanted = [t for t, need in zip(inputs, ctx.needs_input_grad[:4])
                  if t is not None and need]
        grads = iter(())
        if wanted:
            with torch.enable_grad():
                out = _torch_gemm(inputs[0], inputs[1], inputs[2], layout,
                                  epilogue, inputs[3], out_dtype)
                grads = iter(torch.autograd.grad(out, wanted, g))
        result = [next(grads) if t is not None and need else None
                  for t, need in zip(inputs, ctx.needs_input_grad[:4])]
        return (*result, None, None, None)


def _torch_gemm(a, b, c, layout, epilogue, bias, out_dtype):
    """Plain torch GEMM: fp32 products and accumulation (bf16 operands are
    upcast first, so the accumulator is never rounded to bf16 before the
    epilogue), then the epilogue and the output cast.  On the card TF32
    is switched off, so fp32 products stay fp32."""
    if a.is_cuda:
        disable_tf32()
    a32, b32 = a.float(), b.float()
    acc = torch.matmul(a32, b32 if layout == "nn" else b32.transpose(-1, -2))
    if c is not None:
        acc = acc + c.float()
    return apply_epilogue(acc, epilogue, bias).to(out_dtype)

