"""Shared layer primitives: linear, norms, embeddings, initialisers and the
dtype policy.

Parameters are fp32 masters, cast to the compute dtype (``cfg.dtype``) at
the point of use.  Linear weights keep the reference's ``(d_in, d_out)``
layout, so every projection is the same ``nn`` GEMM descriptor, and the
tied read-out the same ``nt`` one, as in the reference package.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import matmul
from repro_torch.core.config import get_config, pinned
from repro_torch.core.trace import span


class Init:
    """Seeded draws for a model's parameters, on the model's device, with
    the reference's distributions: N(0, 1) / sqrt(fan_in) for linear
    weights, N(0, 0.02^2) for embeddings, ones for norm scales, zeros for
    biases.  (The numbers differ from JAX's: tests convert JAX-initialised
    parameters instead, see ``repro_torch.convert``.)  On the meta device
    (the dry-run's shape-only builds) nothing is drawn: there is no
    generator there, and the tensors hold no values."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = None if self.device.type == "meta" else \
            torch.Generator(device=self.device).manual_seed(seed)

    def normal(self, shape, scale: float) -> torch.Tensor:
        return scale * torch.randn(shape, generator=self.gen,
                                   device=self.device)

    def scaled(self, shape, fan_in: int) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen,
                           device=self.device) / fan_in ** 0.5

    def uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(shape, generator=self.gen,
                                           device=self.device)


def cast_param(p, dtype):
    """``p`` in the compute dtype.  A quantized weight
    (:class:`~repro_torch.optim.compression.QuantizedTensor`) passes
    through untouched: its int8 values and f32 scales are its storage,
    and the kernel dequantizes in its epilogue.  A cast is a ``cast`` span
    that carries the bytes it reads and writes."""
    from repro_torch.optim.compression import QuantizedTensor
    if isinstance(p, QuantizedTensor) or p.dtype == dtype:
        return p
    with span("cast", bytes=p.numel() * (p.element_size() + dtype.itemsize)):
        return p.to(dtype)


def readout(x, w, dtype, out_dtype):
    """Logits ``x @ w`` of an untied read-out ``w`` (d, vocab), cast to
    ``dtype``.  Where a row of the cast weight is not a whole number of 16
    bytes (seamless-m4t's vocab of 256,206 bf16 elements), TMA cannot read
    it and the GEMM would take its register-fed route C: the cast then
    writes the weight into a buffer whose rows are zero-padded to the next
    16 bytes, the GEMM runs over that width, and the logits are a view of
    its first vocab columns.  The fp32 master keeps the reference's
    layout, and its gradient is the padded one's first vocab columns."""
    from repro_torch.optim.compression import QuantizedTensor
    n, unit = w.shape[-1], 16 // dtype.itemsize
    with span("readout"):
        if isinstance(w, QuantizedTensor) or n % unit == 0:
            return matmul(x, cast_param(w, dtype), out_dtype=out_dtype)
        wp = torch.empty((w.shape[0], -(-n // unit) * unit), dtype=dtype,
                         device=w.device)
        wp[:, n:] = 0
        wp[:, :n] = w
        return matmul(x, wp, out_dtype=out_dtype)[..., :n]


def tree_cast(params, dtype):
    """:func:`cast_param` over a dict of tensors (quantized ones pass)."""
    return {k: cast_param(p, dtype) for k, p in params.items()}


def checkpointed(fn, *args):
    """``fn(*args)`` under a non-reentrant ``torch.utils.checkpoint``: only
    the inputs are kept, and the forward runs again in the backward.  The
    recompute runs under the engine configuration of the first run
    (:func:`~repro_torch.core.config.pinned`): autograd runs a CUDA
    backward on its own device thread, where the caller's thread-local
    ``use`` overrides are not set."""
    cfg = get_config()
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          pinned(cfg)))


class Linear(nn.Module):
    """``y = x @ w (+ b)`` through :func:`repro_torch.core.matmul`, with an
    optional fused activation epilogue."""

    def __init__(self, d_in: int, d_out: int, init: Init, bias: bool = False):
        super().__init__()
        self.w = nn.Parameter(init.scaled((d_in, d_out), d_in))
        self.b = nn.Parameter(torch.zeros(d_out, device=init.device)) \
            if bias else None

    def forward(self, x, *, epilogue: Optional[str] = None,
                compute_dtype=None):
        w, b = self.w, self.b
        if compute_dtype is not None:
            w = cast_param(w, compute_dtype)
            x = x.to(compute_dtype)
            if b is not None:
                b = cast_param(b, compute_dtype)
        if b is not None:
            epi = {"gelu": "bias_gelu", "silu": "bias_silu",
                   None: "bias"}.get(epilogue, epilogue)
            return matmul(x, w, epilogue=epi, bias=b)
        return matmul(x, w, epilogue=epilogue)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm computed in fp32 whatever the activation dtype."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, init: Init):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=init.device))

    def forward(self, x, eps: float):
        return rmsnorm(self.scale, x, eps)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float) -> torch.Tensor:
    """Layer norm in fp32 whatever the activation dtype: mean, biased
    variance, ``rsqrt(var + eps)``, then scale and bias, in the
    reference's order."""
    x32 = x.float()
    xc = x32 - x32.mean(-1, keepdim=True)
    var = xc.square().mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, init: Init):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=init.device))
        self.bias = nn.Parameter(torch.zeros(d, device=init.device))

    def forward(self, x, eps: float):
        return layernorm(self.scale, self.bias, x, eps)


def make_norm(kind: str, d: int, init: Init) -> nn.Module:
    """The norm ``cfg.norm_type`` names: "rmsnorm" or "layernorm"."""
    if kind == "rmsnorm":
        return RMSNorm(d, init)
    if kind == "layernorm":
        return LayerNorm(d, init)
    raise NotImplementedError(f"norm_type={kind!r} is not ported")


class Embedding(nn.Module):
    """Token table; ``unembed`` is the tied read-out ``x @ table^T``, an
    ``nt`` GEMM."""

    def __init__(self, vocab: int, d: int, init: Init):
        super().__init__()
        self.table = nn.Parameter(init.normal((vocab, d), 0.02))

    def embed(self, ids, compute_dtype):
        # Gather first, then cast: the same values as casting the table.
        return self.table[ids].to(compute_dtype)

    def unembed(self, x, compute_dtype, out_dtype):
        with span("readout"):
            table = cast_param(self.table, compute_dtype)
            return matmul(x, table, layout="nt", out_dtype=out_dtype)
