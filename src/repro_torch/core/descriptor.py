"""Kernel descriptors: the hashable metadata that keys the engine's plan
and kernel caches and feeds the planners.

Field for field these are the reference package's descriptors, so
``cache_key()`` agrees between the two.  The ``quant`` and ``mesh``
fields are kept for that agreement but accept only ``None``: the
quantized and mesh axes are not ported yet.

Layouts: ``"nn"`` is ``C[M,N] = A[M,K] @ B[K,N]``; ``"nt"`` is
``A[M,K] @ B[N,K]^T`` (B stores N major, K minor -- the tied read-out).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .machine import canonical_dtype, itemsize

LAYOUTS = ("nn", "nt")
EPILOGUES = (None, "bias", "gelu", "silu", "relu", "bias_gelu", "bias_silu")
BIAS_EPILOGUES = tuple(e for e in EPILOGUES if e and e.startswith("bias"))


def check_bias(epilogue, bias) -> None:
    """Shared precondition: a bias-consuming epilogue needs a bias operand."""
    if epilogue in BIAS_EPILOGUES and bias is None:
        raise ValueError(
            f"epilogue {epilogue!r} requires a bias operand, got bias=None")


def _reject_unported(**fields) -> None:
    for name, value in fields.items():
        if value is not None:
            raise NotImplementedError(
                f"descriptor field {name}={value!r}: the {name} axis is not "
                f"ported yet")


@dataclasses.dataclass(frozen=True)
class KernelDescriptor:
    """Base of every per-family descriptor; ``family`` names the engine
    registry entry and prefixes ``cache_key()``."""

    family = "abstract"

    def cache_key(self) -> tuple:
        return (self.family,) + dataclasses.astuple(self)

    @property
    def flops(self) -> int:
        raise NotImplementedError

    @property
    def in_bytes(self) -> int:
        raise NotImplementedError

    @property
    def out_bytes(self) -> int:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class GemmDescriptor(KernelDescriptor):
    """Hashable metadata fully specifying one generated GEMM kernel."""

    family = "gemm"

    m: int
    n: int
    k: int
    layout: str = "nn"
    in_dtype: str = "float32"
    acc_dtype: str = "float32"
    out_dtype: str = "float32"
    accumulate: bool = False
    epilogue: Optional[str] = None
    edge: str = "mask"
    batch: int = 0
    quant: None = None
    mesh: None = None

    def __post_init__(self):
        _reject_unported(quant=self.quant, mesh=self.mesh)
        if self.layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got {self.layout}")
        if self.epilogue not in EPILOGUES:
            raise ValueError(f"epilogue must be one of {EPILOGUES}")
        if self.edge not in ("mask", "pad"):
            raise ValueError("edge must be 'mask' or 'pad'")
        for d in (self.m, self.n, self.k):
            if d <= 0:
                raise ValueError(f"GEMM dims must be positive, got {self}")

    @classmethod
    def from_operands(cls, a, b, layout="nn", accumulate=False, epilogue=None,
                      acc_dtype="float32", out_dtype=None):
        if a.ndim != b.ndim:
            raise ValueError(f"rank mismatch: A{tuple(a.shape)} vs B{tuple(b.shape)}")
        batch = 0
        if a.ndim == 3:
            if a.shape[0] != b.shape[0]:
                raise ValueError(f"batch mismatch: A{tuple(a.shape)} vs B{tuple(b.shape)}")
            batch = a.shape[0]
        elif a.ndim != 2:
            raise ValueError(f"GEMM operands must be rank 2 or 3, got {a.ndim}")
        m, k = a.shape[-2], a.shape[-1]
        if layout == "nn":
            kb, n = b.shape[-2], b.shape[-1]
        else:
            n, kb = b.shape[-2], b.shape[-1]
        if kb != k:
            raise ValueError(f"contraction mismatch: A{tuple(a.shape)} {layout} "
                             f"B{tuple(b.shape)}")
        in_dtype = canonical_dtype(a.dtype)
        if canonical_dtype(b.dtype) != in_dtype:
            raise ValueError(f"A/B dtype mismatch: {a.dtype} vs {b.dtype}")
        return cls(m=m, n=n, k=k, layout=layout, in_dtype=in_dtype,
                   acc_dtype=canonical_dtype(acc_dtype),
                   out_dtype=canonical_dtype(out_dtype or acc_dtype),
                   accumulate=accumulate, epilogue=epilogue, batch=batch)

    @property
    def flops(self) -> int:
        return 2 * max(1, self.batch) * self.m * self.n * self.k

    @property
    def a_wire_itemsize(self) -> int:
        return itemsize(self.in_dtype)

    @property
    def b_wire_itemsize(self) -> int:
        return itemsize(self.in_dtype)

    @property
    def compute_dtype(self) -> str:
        return self.in_dtype

    @property
    def in_bytes(self) -> int:
        nb = max(1, self.batch)
        return nb * (self.m * self.k * self.a_wire_itemsize
                     + self.k * self.n * self.b_wire_itemsize)

    @property
    def out_bytes(self) -> int:
        return max(1, self.batch) * self.m * self.n * itemsize(self.out_dtype)


@dataclasses.dataclass(frozen=True)
class FlashDescriptor(KernelDescriptor):
    """Flash-attention forward: (BH, sq, d) x (BH, sk, d)^2 -> (BH, sq, d)."""

    family = "flash_attention"

    batch_heads: int
    sq: int
    sk: int
    d: int
    causal: bool = True
    dtype: str = "float32"

    def __post_init__(self):
        for v in (self.batch_heads, self.sq, self.sk, self.d):
            if v <= 0:
                raise ValueError(f"flash dims must be positive, got {self}")

    @classmethod
    def from_operands(cls, q, k, *, causal=True):
        b, sq, h, d = q.shape
        return cls(batch_heads=b * h, sq=sq, sk=k.shape[1], d=d,
                   causal=causal, dtype=canonical_dtype(q.dtype))

    @property
    def flops(self) -> int:
        # QK^T and PV are each 2*sq*sk*d; causal masking halves the useful
        # score area.
        full = 4 * self.batch_heads * self.sq * self.sk * self.d
        return full // 2 if self.causal else full

    @property
    def in_bytes(self) -> int:
        return (self.batch_heads * (self.sq + 2 * self.sk) * self.d
                * itemsize(self.dtype))

    @property
    def out_bytes(self) -> int:
        return self.batch_heads * self.sq * self.d * itemsize(self.dtype)


@dataclasses.dataclass(frozen=True)
class FlashBwdDescriptor(FlashDescriptor):
    """Flash-attention backward: dO, O, LSE, Q, K, V -> dQ, dK, dV.

    The forward's geometry fields (the backward walks the forward's
    ``FlashTileSchedule``) under its own ``family``, so the engine caches
    and counts backward plans apart from forward ones.
    """

    family = "flash_attention_bwd"

    @classmethod
    def from_forward(cls, desc: FlashDescriptor) -> "FlashBwdDescriptor":
        """Backward descriptor sharing a forward descriptor's geometry."""
        return cls(**dataclasses.asdict(desc))

    @property
    def flops(self) -> int:
        # Five tile products per visited (q, k) tile (the recomputed P,
        # dV, dP, dK, dQ) against the forward's two: 5/2 of the forward.
        return (5 * super().flops) // 2

    @property
    def in_bytes(self) -> int:
        # q/k/v/o/do plus the fp32 LSE rows.
        return (self.batch_heads * (3 * self.sq + 2 * self.sk) * self.d
                * itemsize(self.dtype) + self.batch_heads * self.sq * 4)

    @property
    def out_bytes(self) -> int:
        # dQ in the operand dtype, dK/dV accumulated in fp32.
        return self.batch_heads * (self.sq * self.d * itemsize(self.dtype)
                                   + 2 * self.sk * self.d * 4)
