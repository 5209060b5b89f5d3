"""Quantization: the quant axis's codec, weight-only storage for serving,
and error-feedback gradient compression.

  * The codec -- :func:`quantize` / :func:`dequantize` /
    :class:`QuantizedTensor` implement the scale schemes of
    :class:`~repro_torch.core.descriptor.QuantSpec` (``per_tensor``,
    ``per_channel``, ``per_tile``), and :func:`expand_scale` /
    :func:`quantize_operand` build the dense f32 scale vectors the GEMM
    kernels' epilogues take.  Scales are symmetric, ``amax / qmax +
    1e-12`` with ``qmax`` 127 (int8) or 448 (e4m3); values are rounded
    half to even and clipped to +-127 before the int8 cast, clipped to
    +-448 before the e4m3 cast, as the reference does.
  * :func:`quantize_model` -- quantize once at load for W8A16 serving:
    every 2-D ``w`` projection becomes a :class:`QuantizedTensor`
    (per output column), and its wide copy is dropped.  Embedding tables,
    norm scales, biases and the 3-D expert banks stay wide.
  * :func:`error_feedback_compress` -- int8 block quantization of the
    gradients with the residual of each step carried into the next (the
    compressed wire format of a cross-host reduction, simulated on one
    device).
  * :func:`compressed_psum` -- that wire format on a real reduction: an
    int8-compressed all-reduce over one mesh axis's process group.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.descriptor import QuantSpec, resolve_quant
from repro_torch.core.machine import FP8_DTYPE
from repro_torch.core.schedule import QUANT_TILE

_BLOCK = 256

# Largest representable magnitude per wire dtype: symmetric int8 uses
# [-127, 127] (keeping -128 unused preserves negation symmetry); e4m3
# saturates at 448.
_QMAX = {"int8": 127.0, "float8_e4m3": 448.0}


def wire_dtype(spec: QuantSpec) -> torch.dtype:
    """The torch dtype of a spec's wire format."""
    return torch.int8 if spec.dtype == "int8" else FP8_DTYPE


class QuantizedTensor:
    """A quantized tensor plus the scales to reconstruct it.

    ``q`` holds the narrow wire values, ``scale`` the f32 scale(s), whose
    shape follows ``spec.scheme`` (a scalar, one per channel, or one per
    ``QUANT_TILE`` channel block along ``axis``).  ``dtype`` is the
    logical (pre-quantization) dtype.  It is not a parameter: a module
    holding one holds no wide copy and trains nothing through it."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, spec: QuantSpec,
                 axis: int = -1, orig_dtype=torch.float32):
        self.q = q
        self.scale = scale
        self.spec = spec
        self.axis = axis
        self.orig_dtype = orig_dtype

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def dtype(self):
        return self.orig_dtype

    def dequantize(self, dtype=None) -> torch.Tensor:
        return dequantize(self, dtype=dtype)

    def __repr__(self):
        return (f"QuantizedTensor(shape={tuple(self.q.shape)}, "
                f"spec={self.spec!r}, axis={self.axis})")


def _scale_for(x32: torch.Tensor, spec: QuantSpec, axis: int) -> torch.Tensor:
    """f32 scales of ``x32`` under ``spec.scheme`` along ``axis``:
    per_tensor -> (); per_channel -> (x.shape[axis],); per_tile ->
    (ceil(x.shape[axis] / QUANT_TILE),), 128-wide channel blocks with a
    short tail block."""
    qmax = _QMAX[spec.dtype]
    if spec.scheme == "per_tensor":
        amax = x32.abs().max() if x32.numel() else \
            torch.zeros((), device=x32.device)
        return amax / qmax + 1e-12
    axis = axis % max(x32.ndim, 1)
    n = x32.shape[axis]
    if spec.scheme == "per_channel":
        if x32.numel():
            reduce_axes = tuple(i for i in range(x32.ndim) if i != axis)
            amax = x32.abs().amax(dim=reduce_axes) if reduce_axes \
                else x32.abs()
        else:
            amax = torch.zeros((n,), device=x32.device)
        return amax / qmax + 1e-12
    # per_tile: pad the channel axis to a QUANT_TILE multiple with zeros
    # (which never win the max) and reduce per block.
    if n == 0:
        return torch.zeros((0,), device=x32.device)
    tiles = -(-n // QUANT_TILE)
    moved = torch.movedim(x32, axis, -1).reshape(-1, n)
    if moved.shape[0] == 0:  # as the reference: a max with no identity
        raise ValueError("per_tile scales of a tensor with no rows: a "
                         "zero-size reduction has no identity")
    moved = torch.nn.functional.pad(moved, (0, tiles * QUANT_TILE - n))
    amax = moved.reshape(moved.shape[0], tiles, QUANT_TILE).abs() \
        .amax(dim=(0, 2))
    return amax / qmax + 1e-12


def expand_scale(scale: torch.Tensor, spec: QuantSpec,
                 length: int) -> torch.Tensor:
    """A scheme-shaped scale as a dense ``(length,)`` f32 vector, the form
    the kernels take: per_tensor broadcasts the scalar, per_channel is
    dense already, per_tile repeats each block scale QUANT_TILE times and
    cuts the tail."""
    scale = torch.as_tensor(scale, dtype=torch.float32)
    if spec.scheme == "per_tensor":
        return scale.reshape(()).expand(length).contiguous()
    if spec.scheme == "per_channel":
        return scale.reshape(length)
    return torch.repeat_interleave(scale, QUANT_TILE)[:length]


def _broadcast(dense: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = dense.shape[0]
    return dense.reshape(shape)


def quantize(x: torch.Tensor, spec, *, axis: int = -1) -> QuantizedTensor:
    """Quantize ``x`` to ``spec``'s wire dtype along channel ``axis`` (a
    weight's output-feature axis, an activation's row axis):
    ``q = round(x / scale)`` clipped to the wire range."""
    spec = resolve_quant(spec)
    x32 = x.float()
    scale = _scale_for(x32, spec, axis)
    if spec.scheme == "per_tensor" or not x.numel():
        dense = scale
    else:
        ax = axis % x.ndim
        dense = _broadcast(expand_scale(scale, spec, x.shape[ax]), x.ndim, ax)
    scaled = x32 / dense if x.numel() else x32
    qmax = _QMAX[spec.dtype]
    if spec.dtype == "int8":
        scaled = torch.round(scaled)
    q = torch.clamp(scaled, -qmax, qmax).to(wire_dtype(spec))
    return QuantizedTensor(q, scale, spec, axis=axis, orig_dtype=x.dtype)


def dequantize(qt: QuantizedTensor, dtype=None) -> torch.Tensor:
    """The wide tensor back: ``q.float() * scale`` per group."""
    dtype = qt.orig_dtype if dtype is None else dtype
    x32 = qt.q.float()
    if qt.spec.scheme == "per_tensor" or x32.numel() == 0:
        return (x32 * qt.scale).to(dtype)
    ax = qt.axis % x32.ndim
    dense = expand_scale(qt.scale, qt.spec, x32.shape[ax])
    return (x32 * _broadcast(dense, x32.ndim, ax)).to(dtype)


def quantize_operand(x: torch.Tensor, spec: QuantSpec, *, axis: int):
    """Quantize a GEMM operand at dispatch: ``(q, dense_scale)``, the
    latter the full ``(x.shape[axis],)`` f32 dequant vector the fused
    epilogue takes."""
    qt = quantize(x, spec, axis=axis)
    n = x.shape[axis % max(x.ndim, 1)]
    return qt.q, expand_scale(qt.scale, spec, n)


def quantize_model(model, spec="w8a16", *, min_size: int = 0):
    """Quantize once at load for W8A16 serving.

    ``model`` is a module tree (a ``LanguageModel``): every 2-D parameter
    named ``w`` (the ``Linear`` projections, and an untied ``lm_head``)
    with at least ``min_size`` elements is replaced, in place, by a
    :class:`QuantizedTensor` quantized per output column (``axis=-1``),
    and the wide parameter is dropped.  Embedding tables (``table``),
    norm scales, biases and the 3-D expert banks stay wide.  Returns the
    model.  A flat dict of tensors keyed by dotted names (a state dict,
    or the converted reference parameters) is mapped the same way, by the
    last name component, and a new dict is returned.
    """
    spec = resolve_quant(spec)
    if spec is None:
        return model

    def wants(name, v):
        return (name == "w" and isinstance(v, torch.Tensor) and v.ndim == 2
                and v.numel() >= min_size)

    if isinstance(model, dict):
        return {k: quantize(v.detach(), spec, axis=-1)
                if wants(k.rsplit(".", 1)[-1], v) else v
                for k, v in model.items()}
    for module in list(model.modules()):
        w = module._parameters.get("w") if isinstance(module, nn.Module) \
            else None
        if w is not None and wants("w", w):
            qt = quantize(w.detach(), spec, axis=-1)
            del module._parameters["w"]
            module.w = qt
    return model


def _quantize_int8(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization in 256-element blocks of the flattened
    tensor (zero padded)."""
    flat = x32.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % _BLOCK))
    blocks = flat.reshape(-1, _BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q, scale, shape) -> torch.Tensor:
    deq = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= int(s)
    return deq[:n].reshape(shape)


def error_feedback_compress(grads: Dict[str, torch.Tensor],
                            residual: Optional[Dict[str, torch.Tensor]]):
    """Quantize gradients to int8 (the simulated wire format) with error
    feedback.  ``grads`` and ``residual`` are dicts of tensors by name
    (``residual`` None: zeros).  Returns ``(the dequantized f32 gradients
    a receiver would see, the new residual)``, the latter carrying this
    step's quantization error into the next."""
    if residual is None:
        residual = {k: torch.zeros_like(g, dtype=torch.float32)
                    for k, g in grads.items()}
    new_g, new_r = {}, {}
    for k, g in grads.items():
        g32 = g.float() + residual[k].float()
        q, scale = _quantize_int8(g32)
        deq = _dequantize_int8(q, scale, g32.shape)
        new_g[k], new_r[k] = deq, g32 - deq
    return new_g, new_r


def compressed_psum(x: torch.Tensor, axis_name: str, mesh=None
                    ) -> torch.Tensor:
    """int8-compressed all-reduce of ``x`` over the mesh axis
    ``axis_name`` (of ``mesh``, default the current mesh), every rank of
    the axis calling it together.  The reference's arithmetic: quantize
    the local partial in blocks, max-reduce the scales, re-quantize the
    local values to the shared scale, sum the int32 values (exact), and
    dequantize with the shared scale."""
    import torch.distributed as dist
    from repro_torch.runtime.shardlib import current_mesh
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        raise ValueError("compressed_psum needs a mesh (use_mesh or mesh=)")
    group = mesh.get_group(axis_name)
    q, scale = _quantize_int8(x.float())
    scale_max = scale.clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    total = torch.clamp(torch.round(q.float() * (scale / scale_max)),
                        -127, 127).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return _dequantize_int8(total, scale_max, x.shape).to(x.dtype)
