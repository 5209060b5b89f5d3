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

:func:`act_bwd` is an activation GEMM's backward epilogue (the cotangent
of the pre-activation) on the forward's plan: one ``gemm_act_bwd``
launch over the plan's tile table, whatever its lowering, counted under
``gemm_bwd`` (``engine.stats()["gemm"]["launches_bwd"]``).

Edge strategies of the multi-launch lowering (``desc.edge``): ``"mask"``
runs each region at its exact shape, the kernel masking the ragged edges;
``"pad"`` zero-pads each region's operands to its block multiples (rows to
``bm``, columns to ``bn``, K to the plan's ``bk``) outside the kernel, runs
the same region kernel on the padded shape and slices the result back (the
copy-based strategy the paper's predication avoids).  The fused lowering
masks whatever the edge.

A quantized descriptor (``desc.quant``) runs ONE ``gemm_quant`` launch
over the same tile table when the plan is fused; the region kernel has no
quant form, so its non-fused lowering is the reference's ``_xla_quant_gemm``
in torch (one exact-wide contraction, then dequant and epilogue), which
launches no kernel of the engine.  On ``H100_SXM`` quantized plans are
fused (:func:`~repro_torch.core.blocking.plan_gemm`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import engine
from repro_torch.core.blocking import BlockingPlan, plan_gemm
from repro_torch.core.config import get_config, use
from repro_torch.core.descriptor import (GemmDescriptor, check_bias,
                                         resolve_quant)
from repro_torch.core.machine import torch_dtype
from repro_torch.core.schedule import plan_launches, round_up
from repro_torch.kernels.gemm.kernel import (K_PANEL, FusedGemm,
                                             gemm_act_bwd, gemm_fused,
                                             gemm_quant, gemm_region)
from repro_torch.kernels.gemm.ref import ref_quant_gemm


def _fused_executor(desc: GemmDescriptor, plan: BlockingPlan, device):
    """Build (and cache) one plan's fused kernel state on ``device``."""
    # The fused walk masks edges: both edge strategies share its state.
    key = dataclasses.replace(desc, edge="mask").cache_key() + (
        "fused", plan.regions, plan.bk, str(device))
    return engine.build_cached(key, lambda: FusedGemm(plan.tile_schedule(),
                                                      device))


def _contiguous(*ts):
    return tuple(None if t is None else t.contiguous() for t in ts)


def execute(desc: GemmDescriptor, plan: BlockingPlan, a, b, *, bias=None,
            c=None, sa=None, sb=None) -> torch.Tensor:
    """Engine executor: run one planned (possibly batched) GEMM.  ``sa`` /
    ``sb`` are a quantized descriptor's dense f32 dequant vectors (``(m,)``
    row scales for full quant, ``(n,)`` column scales for any spec)."""
    check_bias(desc.epilogue, bias)
    if a.is_cuda and plan.bk != K_PANEL:
        raise NotImplementedError(f"plan bk={plan.bk}, but the CUDA GEMM's "
                                  f"K panel is {K_PANEL}; plan with the "
                                  f"H100_SXM machine model")
    fused = engine.resolve_fused(plan)
    out_dtype = torch_dtype(desc.out_dtype)
    if desc.quant is not None:
        a, b, sa, sb, bias = _contiguous(a, b, sa, sb, bias)
        kw = dict(layout=desc.layout, epilogue=desc.epilogue, bias=bias,
                  out_dtype=out_dtype)
        if not fused:
            # The non-fused quant lowering: no kernel of the engine.
            engine.count_launches("gemm", 0)
            return ref_quant_gemm(a, b, sa, sb, **kw)
        engine.count_launches("gemm", plan_launches(plan, fused=True))
        return gemm_quant(_fused_executor(desc, plan, a.device), a, b, sa, sb,
                          **kw)
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
            if desc.edge == "pad":
                _padded_region(a3, b3, out, region, plan.bk, **kw)
            else:
                gemm_region(a3, b3, out, region, **kw)
    return out if desc.batch else out[0]


def act_bwd(desc: GemmDescriptor, plan: BlockingPlan, a, b, dy, *,
            bias=None, c=None, out_dtype=torch.float32) -> torch.Tensor:
    """The backward epilogue of the GEMM ``desc`` ran forward with
    ``plan``: ``dy * act'(c? + a @ op(b) + bias?)`` in ``out_dtype``, in
    one launch over the plan's tile table (the fused executor, which the
    forward built if its lowering was fused).  ``dy`` is the output's
    cotangent, shaped as the output."""
    batch = desc.batch
    a3, b3, dy3 = ((t if batch else t[None]).contiguous() for t in (a, b, dy))
    c3 = None if c is None else (c if batch else c[None]).contiguous()
    bias = None if bias is None else bias.contiguous()
    engine.count_launches("gemm_bwd", 1)
    out = gemm_act_bwd(_fused_executor(desc, plan, a.device), a3, b3, dy3,
                       layout=desc.layout, epilogue=desc.epilogue, bias=bias,
                       c=c3, out_dtype=out_dtype)
    return out if batch else out[0]


def _pad(t, *sizes):
    """``t`` zero-padded at the end of its trailing dims to ``sizes``."""
    pad = []
    for dim, size in zip(reversed(range(t.ndim)), reversed(sizes)):
        pad += [0, size - t.shape[dim]]
    return torch.nn.functional.pad(t, pad).contiguous()


def _padded_region(a3, b3, out, region, bk, *, layout, epilogue, bias, c):
    """One region under ``edge="pad"``: its operand slices zero-padded to
    whole blocks, the region kernel over the padded rectangle, the
    region's rows and columns copied into ``out``."""
    r0, c0, rows, cols = region.row0, region.col0, region.rows, region.cols
    rows_p, cols_p = round_up(rows, region.bm), round_up(cols, region.bn)
    k_p = round_up(a3.shape[-1], bk)
    a_r = _pad(a3[:, r0:r0 + rows], rows_p, k_p)
    b_r = _pad(b3[:, :, c0:c0 + cols], k_p, cols_p) if layout == "nn" \
        else _pad(b3[:, c0:c0 + cols], cols_p, k_p)
    bias_r = None if bias is None else _pad(bias[c0:c0 + cols], cols_p)
    c_r = None if c is None else _pad(c[:, r0:r0 + rows, c0:c0 + cols],
                                      rows_p, cols_p)
    out_r = torch.empty((a3.shape[0], rows_p, cols_p), dtype=out.dtype,
                        device=out.device)
    gemm_region(a_r, b_r, out_r, dataclasses.replace(
        region, row0=0, col0=0, rows=rows_p, cols=cols_p), layout=layout,
        epilogue=epilogue, bias=bias_r, c=c_r)
    out[:, r0:r0 + rows, c0:c0 + cols] = out_r[:, :rows, :cols]


engine.register_family("gemm", planner=plan_gemm, execute=execute)


def gemm(a, b, c: Optional[torch.Tensor] = None, *, layout: str = "nn",
         epilogue: Optional[str] = None, bias: Optional[torch.Tensor] = None,
         out_dtype=None, edge: str = "mask",
         plan: Optional[BlockingPlan] = None, fused: Optional[bool] = None,
         quant=None) -> torch.Tensor:
    """Planned, shape-specialised (batched) GEMM via the engine.

    ``a``: (..., M, K); ``b``: (..., K, N) for layout "nn" or (..., N, K)
    for "nt"; optional ``c`` of shape (..., M, N).  ``fused=True/False``
    pins the single-launch or multi-launch lowering for this call, ``plan``
    the plan itself; ``edge`` is the multi-launch lowering's edge strategy
    (``"mask"`` or ``"pad"``, see the module docstring).

    ``quant`` selects the low-precision axis: a
    :class:`~repro_torch.core.descriptor.QuantSpec`, a shorthand
    (``"int8"``/``"w8a16"``/``"fp8"``), ``False`` to opt out of an
    ambient ``config.quant``, or ``None`` to follow the config.  Wide
    operands are quantized here at dispatch: B per output column, A per
    row for full quant.  ``b`` may instead be a pre-quantized
    :class:`~repro_torch.optim.compression.QuantizedTensor` (quantized
    once at load, W8A16), whose spec then wins.
    """
    from repro_torch.optim.compression import (QuantizedTensor, expand_scale,
                                               quantize_operand)
    sa = sb = None
    if isinstance(b, QuantizedTensor):
        # Quantized-at-load weights: always weight-only, A stays wide.
        spec = dataclasses.replace(b.spec, weight_only=True)
        n_axis = 1 if layout == "nn" else 0
        if b.axis % b.ndim != n_axis:
            raise ValueError(
                f"QuantizedTensor b is quantized along axis {b.axis}, but "
                f"layout {layout!r} needs output-column (axis {n_axis}) "
                f"scales for the dequant to commute through the GEMM")
        sb = expand_scale(b.scale, b.spec, b.shape[n_axis])
        b = b.q
    else:
        spec = resolve_quant(get_config().quant if quant is None else quant)
        if spec is not None:
            if a.ndim != 2:
                raise ValueError("quantized GEMM is unbatched; flatten "
                                 "leading dims first")
            out_dtype = out_dtype or a.dtype
            b, sb = quantize_operand(b, spec, axis=1 if layout == "nn" else 0)
            if not spec.weight_only:
                a, sa = quantize_operand(a, spec, axis=0)
    desc = GemmDescriptor.from_operands(
        a, b, layout=layout, accumulate=c is not None, epilogue=epilogue,
        out_dtype=out_dtype or a.dtype, edge=edge, quant=spec)
    with use(fused=None if fused is None else ("on" if fused else "off")):
        return engine.dispatch(desc, a, b, plan=plan, bias=bias, c=c, sa=sa,
                               sb=sb)
