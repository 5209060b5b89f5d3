"""Public matmul dispatch -- the port's BLAS front door.

Every dense layer in ``repro_torch.models`` calls :func:`matmul`.  Under
``backend="engine"`` it routes through the engine (descriptor -> plan ->
hand-written Hopper GEMM); under ``backend="torch"`` through
``torch.matmul`` (cuBLAS on the card), the vendor baseline.  Both
accumulate in fp32 and apply the epilogue before the output cast.

Both backends share the reference's backward (``_dot_bwd``): the
cotangent is rounded to the operands' dtype and dA / dB come out in the
operands' dtypes, accumulated in fp32 -- bf16 gradients from bf16
operands, as the reference's XLA path gives them.

An activation epilogue's derivative needs the pre-activation, which the
backward recomputes (span ``matmul.recompute``, attribute ``route``), as
the reference's oracle does with XLA's dot of the bf16 operands and fp32
accumulation.  bf16 operands on the card take route "fused": the engine's
bf16 GEMM on the forward's plan, the derivative times the cotangent in its
epilogue (``kernels/gemm/ops.py::act_bwd``).  The rest take route
"plain" (``kernels/gemm/kernel.py::gemm_act_bwd_plain``): the fp32 product
of the upcast operands (every bf16 product is exact in fp32; TF32 off) and
autograd of the epilogue.

A :class:`~repro_torch.optim.compression.QuantizedTensor` ``b`` (W8A16
weights quantized at load) takes the inference path
:func:`_w8a16_matmul`: the engine's quantized GEMM, or under ``torch`` the
commuted contraction ``(a @ q) * s``.  Gradients reach ``a`` only through
the latter, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import disable_tf32
from repro_torch.kernels.epilogue import ACTIVATIONS, apply_epilogue

from .config import get_config
from .descriptor import GemmDescriptor, check_bias
from .trace import span


def matmul(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None,
           *, layout: str = "nn", epilogue: Optional[str] = None,
           bias: Optional[torch.Tensor] = None, out_dtype=None,
           plan=None, backend_override: Optional[str] = None
           ) -> torch.Tensor:
    """Planned (batched) GEMM: ``out = epilogue(c? + a @ op(b))``.

    ``a``: (..., M, K).  ``b``: (K, N) | (nb, K, N) for layout "nn",
    (N, K) | (nb, N, K) for "nt".  Leading dims of ``a`` are flattened
    into M when ``b`` is rank-2 (the dense-layer case).  ``plan`` (a
    :class:`~repro_torch.core.blocking.BlockingPlan` of the flattened
    problem) bypasses plan resolution on the engine backend;
    ``backend_override`` names the backend for this call.
    """
    be = backend_override or get_config().backend
    out_dtype = out_dtype or a.dtype
    check_bias(epilogue, bias)
    from repro_torch.optim.compression import QuantizedTensor
    if isinstance(b, QuantizedTensor):
        return _w8a16_matmul(a, b, be, layout, epilogue, bias, out_dtype)
    if be == "torch":
        return _torch_gemm(a, b, c, layout, epilogue, bias, out_dtype)

    lead = None
    if b.ndim == 2 and a.ndim > 2:
        lead = a.shape[:-1]
        a = a.reshape(-1, a.shape[-1])
        if c is not None:
            c = c.reshape(-1, c.shape[-1])
    out = _EngineGemm.apply(a, b, c, bias, layout, epilogue, out_dtype, plan)
    if lead is not None:
        out = out.reshape(*lead, out.shape[-1])
    return out


def _w8a16_matmul(a, bq, be, layout, epilogue, bias, out_dtype):
    """Weight-only quantized dense layer, ``epilogue(a @ deq(bq))``.  The
    column scales are separable, so the dequant commutes through the
    contraction: ``a @ (q * s) == (a @ q) * s``.  The engine backend runs
    the quantized GEMM family (one fused launch, dequant in the epilogue);
    the torch backend the commuted contraction in fp32.  Either way the
    narrow weight is what is read."""
    from repro_torch.optim.compression import expand_scale
    if layout != "nn":
        raise ValueError("QuantizedTensor weights support layout='nn' only")
    n = bq.shape[1]
    lead = None
    if a.ndim > 2:
        lead = a.shape[:-1]
        a = a.reshape(-1, a.shape[-1])
    if be == "engine":
        from repro_torch.kernels.gemm.ops import gemm
        out = gemm(a, bq, epilogue=epilogue, bias=bias, out_dtype=out_dtype)
    else:
        acc = _product32(a, bq.q, "nn")
        sb = expand_scale(bq.scale, bq.spec, n)[None, :]
        out = apply_epilogue(acc, epilogue, bias, sb).to(out_dtype)
    if lead is not None:
        out = out.reshape(*lead, n)
    return out


class _EngineGemm(torch.autograd.Function):
    """Engine GEMM with a differentiable front: the forward is the planned
    kernel dispatch, the backward is the reference's (``_engine_vjp_bwd``,
    the VJP of its XLA oracle): the output cotangent through the epilogue
    (:func:`_pre_activation_grad` for an activation), then
    :func:`_dot_bwd` for the operands."""

    @staticmethod
    def forward(ctx, a, b, c, bias, layout, epilogue, out_dtype, plan):
        from repro_torch.core import engine
        desc = GemmDescriptor.from_operands(
            a, b, layout=layout, accumulate=c is not None, epilogue=epilogue,
            out_dtype=out_dtype)
        if plan is None and not a.is_meta:
            # Resolved on the caller's thread, under its configuration, so
            # that the backward (on autograd's thread) runs the same plan.
            plan = engine.resolve(desc, a, b, bias=bias, c=c)
        ctx.save_for_backward(a, b, c, bias)
        ctx.opts = (desc, plan)
        return engine.dispatch(desc, a, b, plan=plan, bias=bias, c=c)

    @staticmethod
    def backward(ctx, g):
        a, b, c, bias = ctx.saved_tensors
        desc, plan = ctx.opts
        need_a, need_b, need_c, need_bias = ctx.needs_input_grad[:4]
        if desc.epilogue in ACTIVATIONS:
            # fp32 where the bias's row sum or an fp32 C's gradient reads it.
            wide = need_bias or (need_c and c.dtype == torch.float32)
            g = _pre_activation_grad(desc, plan, a, b, c, bias, g, wide)
        else:
            g = g.float()  # the output cast's transpose
        dc = g.to(c.dtype) if need_c else None
        dbias = g.reshape(-1, g.shape[-1]).sum(0).to(bias.dtype) \
            if need_bias else None
        da, db = _dot_bwd(a, b, g, desc.layout, need_a, need_b)
        return da, db, dc, dbias, None, None, None, None


def _pre_activation_grad(desc, plan, a, b, c, bias, g, wide):
    """The cotangent of the pre-activation ``c? + a @ op(b) (+ bias)``
    given the output's ``g``: the one case of the backward that recomputes
    the forward product.  Route "fused" (bf16 operands on the card) writes
    it once, in ``a.dtype`` -- the rounding :func:`_dot_bwd` applies -- or
    in fp32 where ``wide``; route "plain" gives fp32."""
    fused = _fused_recompute(a)
    with span("matmul.recompute", route="fused" if fused else "plain"):
        if fused:
            from repro_torch.kernels.gemm.ops import act_bwd
            return act_bwd(desc, plan, a, b, g, bias=bias, c=c,
                           out_dtype=torch.float32 if wide else a.dtype)
        from repro_torch.kernels.gemm.kernel import gemm_act_bwd_plain
        return gemm_act_bwd_plain(a, b, g, layout=desc.layout,
                                  epilogue=desc.epilogue, bias=bias, c=c)


def _fused_recompute(a) -> bool:
    """Route "fused" is for bf16 operands on the card."""
    return a.is_cuda and a.dtype == torch.bfloat16


def _product32(a, b, layout):
    """fp32 product ``a @ op(b)``: bf16 operands are upcast first, so the
    accumulator is never rounded to bf16; on the card TF32 is off."""
    if a.is_cuda:
        disable_tf32()
    b32 = b.float()
    return torch.matmul(a.float(), b32 if layout == "nn"
                        else b32.transpose(-1, -2))


def _mm(x, y, dtype):
    """``x @ y`` rounded once to ``dtype`` after fp32 accumulation: cuBLAS
    on the operands in ``dtype`` on the card, an fp32 product of the
    upcast operands on the CPU."""
    if x.is_cuda:
        disable_tf32()
        return torch.matmul(x.to(dtype), y.to(dtype))
    return torch.matmul(x.float(), y.float()).to(dtype)


def _dot_bwd(a, b, g, layout, need_a=True, need_b=True):
    """The reference's ``_dot_bwd``: the cotangent ``g`` of ``a @ op(b)``
    rounded to the operands' dtype, then dA in ``a.dtype`` and dB in
    ``b.dtype``, each accumulated in fp32.  ``b`` is rank 2 (``a``'s
    leading dims are contracted for dB) or batched like ``a``."""
    g16 = g.to(a.dtype)
    da = db = None
    if b.ndim == 2:
        a2, g2 = a.reshape(-1, a.shape[-1]), g16.reshape(-1, g16.shape[-1])
        if layout == "nn":  # b: (K, N)
            if need_a:
                da = _mm(g16, b.t(), a.dtype)
            if need_b:
                db = _mm(a2.t(), g2, b.dtype)
        else:               # b: (N, K)
            if need_a:
                da = _mm(g16, b, a.dtype)
            if need_b:
                db = _mm(g2.t(), a2, b.dtype)
    elif layout == "nn":    # b: (nb, K, N), g: (nb, M, N)
        if need_a:
            da = _mm(g16, b.transpose(-1, -2), a.dtype)
        if need_b:
            db = _mm(a.transpose(-1, -2), g16, b.dtype)
    else:                   # b: (nb, N, K)
        if need_a:
            da = _mm(g16, b, a.dtype)
        if need_b:
            db = _mm(g16.transpose(-1, -2), a, b.dtype)
    return da, db


class _Dot(torch.autograd.Function):
    """fp32 product ``a @ op(b)`` whose backward is :func:`_dot_bwd` (the
    reference's ``_dot_spmd``)."""

    @staticmethod
    def forward(ctx, a, b, layout):
        ctx.save_for_backward(a, b)
        ctx.layout = layout
        return _product32(a, b, layout)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da, db = _dot_bwd(a, b, g, ctx.layout, *ctx.needs_input_grad[:2])
        return da, db, None


def _torch_gemm(a, b, c, layout, epilogue, bias, out_dtype):
    """Plain torch GEMM, the reference's ``_xla_gemm``: the fp32 product
    (:class:`_Dot`), then ``c``, the epilogue and the output cast; autograd
    takes the gradients through the same :func:`_dot_bwd`."""
    acc = _Dot.apply(a, b, layout)
    if c is not None:
        acc = acc + c.float()
    return apply_epilogue(acc, epilogue, bias).to(out_dtype)
