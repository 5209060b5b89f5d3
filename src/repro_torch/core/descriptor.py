"""Kernel descriptors: the hashable metadata that keys the engine's plan
and kernel caches and feeds the planners.

Field for field these are the reference package's descriptors, so
``cache_key()`` agrees between the two.  The GEMM and grouped
descriptors carry the quant axis (a :class:`QuantSpec`) and the mesh axis
(a :class:`MeshSpec`: the weight operand sharded over one named mesh
axis, the descriptor describing the global problem).

Layouts: ``"nn"`` is ``C[M,N] = A[M,K] @ B[K,N]``; ``"nt"`` is
``A[M,K] @ B[N,K]^T`` (B stores N major, K minor -- the tied read-out).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .machine import canonical_dtype, itemsize, torch_dtype

LAYOUTS = ("nn", "nt")
EPILOGUES = (None, "bias", "gelu", "silu", "relu", "bias_gelu", "bias_silu")
BIAS_EPILOGUES = tuple(e for e in EPILOGUES if e and e.startswith("bias"))

QUANT_DTYPES = ("int8", "float8_e4m3")
QUANT_SCHEMES = ("per_tensor", "per_channel", "per_tile")

# String shorthands accepted anywhere a quant spec is (config knob,
# REPRO_QUANT, gemm(quant=...)).
_QUANT_ALIASES = {
    "int8": ("int8", False),
    "w8a16": ("int8", True),
    "fp8": ("float8_e4m3", False),
    "float8_e4m3": ("float8_e4m3", False),
}


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Low-precision execution spec of the GEMM-family descriptors.

    ``dtype`` is the wire dtype the quantized operand(s) are stored and
    staged in; accumulation is wide (int32 for int8 operands, fp32
    otherwise) and the dequantization runs in the shared epilogue.
    ``scheme`` fixes how scales partition operand channels: one scale
    (``per_tensor``), one per A row / B output column (``per_channel``)
    or one per ``QUANT_TILE``-wide channel block (``per_tile``).  All
    three are row/column separable, so the dequant commutes through the
    contraction.  ``weight_only`` quantizes only B (W8A16): A stays in
    ``in_dtype``, B is widened in the kernel, and the column scales apply
    in the epilogue.
    """

    dtype: str = "int8"
    scheme: str = "per_channel"
    weight_only: bool = False

    def __post_init__(self):
        if self.dtype not in QUANT_DTYPES:
            raise ValueError(
                f"quant dtype must be one of {QUANT_DTYPES}, got {self.dtype}")
        if self.scheme not in QUANT_SCHEMES:
            raise ValueError(
                f"quant scheme must be one of {QUANT_SCHEMES}, "
                f"got {self.scheme}")

    @property
    def wire_itemsize(self) -> int:
        """Bytes per element of the quantized wire format (1 for both
        int8 and fp8)."""
        return 1


def resolve_quant(quant) -> Optional[QuantSpec]:
    """Normalize a quant argument: None/False -> None, a shorthand
    (``"int8"``/``"w8a16"``/``"fp8"``) -> its :class:`QuantSpec`, a spec
    -> itself."""
    if quant is None or quant is False:
        return None
    if isinstance(quant, QuantSpec):
        return quant
    if isinstance(quant, str):
        if quant not in _QUANT_ALIASES:
            raise ValueError(
                f"unknown quant shorthand {quant!r}; expected one of "
                f"{sorted(_QUANT_ALIASES)} or a QuantSpec")
        dtype, weight_only = _QUANT_ALIASES[quant]
        return QuantSpec(dtype=dtype, weight_only=weight_only)
    raise ValueError(f"quant must be None, a str or a QuantSpec, got "
                     f"{type(quant).__name__}")


def check_bias(epilogue, bias) -> None:
    """Shared precondition: a bias-consuming epilogue needs a bias operand."""
    if epilogue in BIAS_EPILOGUES and bias is None:
        raise ValueError(
            f"epilogue {epilogue!r} requires a bias operand, got bias=None")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Mesh placement carried by the GEMM-family descriptors.

    ``axis`` names the mesh axis the weight operand is sharded over (the
    expert dim of a grouped GEMM, the output-column dim of a dense GEMM)
    and ``size`` is that axis's extent.  A descriptor with ``mesh=None``
    is the single-device problem; with a ``MeshSpec`` it describes the
    *global* problem, and the planner charges communication (all-gather
    vs. all_to_all) to pick a *gathered* or a *distributed* execution.
    """

    axis: str = "model"
    size: int = 1

    def __post_init__(self):
        if not self.axis:
            raise ValueError("mesh axis name must be non-empty")
        if self.size < 1:
            raise ValueError(f"mesh size must be >= 1, got {self.size}")


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

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(1, self.in_bytes + self.out_bytes)

    def meta_output(self):
        """What the family's executor returns, as empty tensors on the meta
        device: the engine's answer to a dispatch on meta operands (the
        dry-run's shape-only trace)."""
        raise NotImplementedError


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=torch_dtype(dtype), device="meta")


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
    quant: Optional[QuantSpec] = None
    # B's output-column (n) dim sharded over mesh.axis.
    mesh: Optional[MeshSpec] = None

    def __post_init__(self):
        if self.mesh is not None:
            if not isinstance(self.mesh, MeshSpec):
                raise ValueError(f"mesh must be a MeshSpec, got {self.mesh!r}")
            if self.n % self.mesh.size:
                raise ValueError(f"mesh size {self.mesh.size} must divide "
                                 f"n={self.n}")
        if self.layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got {self.layout}")
        if self.epilogue not in EPILOGUES:
            raise ValueError(f"epilogue must be one of {EPILOGUES}")
        if self.edge not in ("mask", "pad"):
            raise ValueError("edge must be 'mask' or 'pad'")
        for d in (self.m, self.n, self.k):
            if d <= 0:
                raise ValueError(f"GEMM dims must be positive, got {self}")
        if self.quant is not None:
            if not isinstance(self.quant, QuantSpec):
                raise ValueError(f"quant must be a QuantSpec, got {self.quant!r}")
            if self.accumulate:
                raise ValueError("quantized GEMM does not support accumulate "
                                 "(C += A@B); dequant owns the epilogue")
            if self.batch:
                raise ValueError("quantized GEMM is unbatched (scale vectors "
                                 "are per-row/per-column of one problem)")
            if self.edge != "mask":
                raise ValueError("quantized GEMM requires edge='mask'")

    @classmethod
    def from_operands(cls, a, b, layout="nn", accumulate=False, epilogue=None,
                      acc_dtype="float32", out_dtype=None, edge="mask",
                      quant=None):
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
        quant = resolve_quant(quant)
        in_dtype = canonical_dtype(a.dtype)
        # W8A16: B arrives in (or will be quantized to) the wire dtype while
        # A stays wide, so only the wide path holds A and B to one dtype.
        if (quant is None or not quant.weight_only) \
                and canonical_dtype(b.dtype) != in_dtype:
            raise ValueError(f"A/B dtype mismatch: {a.dtype} vs {b.dtype}")
        return cls(m=m, n=n, k=k, layout=layout, in_dtype=in_dtype,
                   acc_dtype=canonical_dtype(acc_dtype),
                   out_dtype=canonical_dtype(out_dtype or acc_dtype),
                   accumulate=accumulate, epilogue=epilogue, edge=edge,
                   batch=batch, quant=quant)

    @property
    def flops(self) -> int:
        return 2 * max(1, self.batch) * self.m * self.n * self.k

    @property
    def a_wire_itemsize(self) -> int:
        """Bytes per staged A element: the wire format for a fully
        quantized GEMM, ``in_dtype`` otherwise (W8A16 keeps A wide)."""
        if self.quant is not None and not self.quant.weight_only:
            return self.quant.wire_itemsize
        return itemsize(self.in_dtype)

    @property
    def b_wire_itemsize(self) -> int:
        """Bytes per staged B element (any quant spec narrows B)."""
        if self.quant is not None:
            return self.quant.wire_itemsize
        return itemsize(self.in_dtype)

    @property
    def compute_dtype(self) -> str:
        """The dtype whose peak prices the products: the wire dtype for a
        fully quantized GEMM, ``in_dtype`` for wide and W8A16 GEMMs."""
        if self.quant is not None and not self.quant.weight_only:
            return self.quant.dtype
        return self.in_dtype

    @property
    def in_bytes(self) -> int:
        nb = max(1, self.batch)
        total = nb * (self.m * self.k * self.a_wire_itemsize
                      + self.k * self.n * self.b_wire_itemsize)
        if self.quant is not None:
            total += (self.m + self.n) * 4  # the f32 dequant scale vectors
        return total

    @property
    def out_bytes(self) -> int:
        return max(1, self.batch) * self.m * self.n * itemsize(self.out_dtype)

    def meta_output(self):
        lead = (self.batch,) if self.batch else ()
        return _meta(lead + (self.m, self.n), self.out_dtype)


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

    def meta_output(self):
        return _meta((self.batch_heads, self.sq, self.d), self.dtype)


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

    def meta_output(self):
        # fp32 (dq, dk, dv), as the backward kernel writes them.
        bh, d = self.batch_heads, self.d
        return (_meta((bh, self.sq, d), "float32"),
                _meta((bh, self.sk, d), "float32"),
                _meta((bh, self.sk, d), "float32"))


@dataclasses.dataclass(frozen=True)
class FlashDecodeDescriptor(KernelDescriptor):
    """Paged decode attention (continuous batching): one query row per slot
    against that slot's live KV pages.

    ``q: (S, h, hd)`` x ``k/v pool: (pages, page_size, hkv, hd)`` ->
    ``(S, h, hd)``, mapped by runtime ``(block_tables, lengths)``
    operands.  The ragged part is data: the descriptor carries only the
    static pool geometry, so the kernel state is built once per pool and
    the churning batch rides through as device tables.
    """

    family = "flash_decode"

    num_seqs: int     # decode slots
    pages: int        # pool size in pages
    page_size: int    # KV slots per page
    max_blocks: int   # block-table width
    num_heads: int
    num_kv_heads: int
    head_dim: int
    dtype: str = "float32"

    def __post_init__(self):
        for v in (self.num_seqs, self.pages, self.page_size,
                  self.max_blocks, self.num_heads, self.num_kv_heads,
                  self.head_dim):
            if v <= 0:
                raise ValueError(f"decode dims must be positive, got {self}")
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"GQA group must divide heads, got {self}")

    @classmethod
    def from_operands(cls, q, k_pool, block_tables):
        s, h, hd = q.shape
        pages, page_size, hkv, _ = k_pool.shape
        return cls(num_seqs=s, pages=pages, page_size=page_size,
                   max_blocks=block_tables.shape[1], num_heads=h,
                   num_kv_heads=hkv, head_dim=hd,
                   dtype=canonical_dtype(q.dtype))

    @property
    def flops(self) -> int:
        # QK^T and PV over every pool page (the worst case: all pages live).
        return 4 * self.num_heads * self.head_dim * self.pages \
            * self.page_size

    @property
    def in_bytes(self) -> int:
        isz = itemsize(self.dtype)
        q = self.num_seqs * self.num_heads * self.head_dim * isz
        kv = 2 * self.pages * self.page_size * self.num_kv_heads \
            * self.head_dim * isz
        tables = self.num_seqs * (self.max_blocks + 1) * 4
        return q + kv + tables

    @property
    def out_bytes(self) -> int:
        return self.num_seqs * self.num_heads * self.head_dim \
            * itemsize(self.dtype)

    def meta_output(self):
        return _meta((self.num_seqs, self.num_heads, self.head_dim),
                     self.dtype)


@dataclasses.dataclass(frozen=True)
class SsdChunkDescriptor(KernelDescriptor):
    """SSD (Mamba-2) chunked-scan family, two forms.

    ``chunks == 0`` -- the intra-chunk ladder only: ``(G,Q,n) x2, (G,Q,Q),
    (G,Q,p) -> (G,Q,p)`` where ``G`` flattens batch x chunk x head.

    ``chunks >= 1`` -- the whole chunked scan: per group (batch x head)
    the kernel walks ``chunks`` in order with the inter-chunk state
    ``(p, n)`` carried, consuming ``(G, C, Q, n) x2, (G, C, Q, Q),
    (G, C, Q, p), (G, C, Q) x2`` decay vectors and an initial state
    ``(G, p, n)``, and producing ``y: (G, C, Q, p)`` plus the final state
    ``(G, p, n)``.  ``dtype`` is xdt's, which is also y's.
    """

    family = "ssd_chunk"

    groups: int
    q: int
    n: int
    p: int
    dtype: str = "float32"
    # chunks walked per group with carried state; 0 selects the intra-chunk
    # (diagonal-block) form with no inter-chunk recurrence
    chunks: int = 0

    def __post_init__(self):
        for v in (self.groups, self.q, self.n, self.p):
            if v <= 0:
                raise ValueError(f"SSD dims must be positive, got {self}")
        if self.chunks < 0:
            raise ValueError(f"SSD chunks must be >= 0, got {self}")

    @classmethod
    def from_operands(cls, c_mat, xdt):
        """The intra-chunk form from ``(G,Q,n)``/``(G,Q,p)`` operands."""
        g, q, n = c_mat.shape
        return cls(groups=g, q=q, n=n, p=xdt.shape[-1],
                   dtype=canonical_dtype(xdt.dtype))

    @classmethod
    def from_scan_operands(cls, c_mat, xdt):
        """The carried-state scan form from ``(G,C,Q,n)``/``(G,C,Q,p)``
        operands."""
        g, chunks, q, n = c_mat.shape
        return cls(groups=g, q=q, n=n, p=xdt.shape[-1],
                   dtype=canonical_dtype(xdt.dtype), chunks=chunks)

    @property
    def cells(self) -> int:
        """(group, chunk) cells walked: ``G`` for the intra-chunk form,
        ``G * chunks`` for the scan form."""
        return self.groups * max(1, self.chunks)

    @property
    def flops(self) -> int:
        # Intra-chunk ladder per cell: (Q,n)x(n,Q) then (Q,Q)x(Q,p); the scan
        # form adds y_off (Q,n)x(n,p) and the state product (p,Q)x(Q,n).
        intra = 2 * self.q * self.q * (self.n + self.p)
        inter = 4 * self.q * self.n * self.p if self.chunks else 0
        return self.cells * (intra + inter)

    @property
    def in_bytes(self) -> int:
        # Every operand counted at xdt's width, as the reference counts.
        isz = itemsize(self.dtype)
        per_cell = 2 * self.q * self.n + self.q * self.q + self.q * self.p
        if self.chunks:
            per_cell += 2 * self.q  # decay_in / decay_out vectors
        total = self.cells * per_cell * isz
        if self.chunks:
            total += self.groups * self.p * self.n * 4  # initial state, fp32
        return total

    @property
    def out_bytes(self) -> int:
        total = self.cells * self.q * self.p * itemsize(self.dtype)
        if self.chunks:
            total += self.groups * self.p * self.n * 4  # final state, fp32
        return total

    def meta_output(self):
        if not self.chunks:
            return _meta((self.groups, self.q, self.p), self.dtype)
        return (_meta((self.groups, self.chunks, self.q, self.p), self.dtype),
                _meta((self.groups, self.p, self.n), "float32"))


@dataclasses.dataclass(frozen=True)
class SsdChunkBwdDescriptor(SsdChunkDescriptor):
    """SSD chunked-scan backward: the reverse walk with the ``(p, n)``
    state cotangent carried.  The forward's geometry (scan form) under its
    own ``family``, so backward plans cache and count apart."""

    family = "ssd_chunk_bwd"

    @classmethod
    def from_forward(cls, desc: SsdChunkDescriptor) -> "SsdChunkBwdDescriptor":
        """Backward descriptor sharing a forward descriptor's geometry."""
        return cls(**dataclasses.asdict(desc))

    @property
    def flops(self) -> int:
        # Each forward product spawns two cotangent products.
        return 2 * super().flops

    @property
    def in_bytes(self) -> int:
        # Forward operands + the dY / dSf cotangents + the saved fp32
        # per-chunk entering states the reverse walk reads.
        extra = (self.cells * self.q * self.p * itemsize(self.dtype)  # dY
                 + 2 * self.groups * self.p * self.n * 4             # dSf, s0
                 + self.cells * self.p * self.n * 4)                 # states
        return super().in_bytes + extra

    @property
    def out_bytes(self) -> int:
        isz = itemsize(self.dtype)
        per_cell = (2 * self.q * self.n + self.q * self.q  # dc, db, dl
                    + self.q * self.p)                     # dx
        return (self.cells * per_cell * isz
                + self.cells * 2 * self.q * 4              # ddi / ddo, fp32
                + self.groups * self.p * self.n * 4)       # ds0

    def meta_output(self):
        # fp32 (dc, db, dl, dx, ddi, ddo, ds0), as the kernel writes them.
        g, nc, q = self.groups, self.chunks, self.q
        f32 = "float32"
        return (_meta((g, nc, q, self.n), f32), _meta((g, nc, q, self.n), f32),
                _meta((g, nc, q, q), f32), _meta((g, nc, q, self.p), f32),
                _meta((g, nc, q), f32), _meta((g, nc, q), f32),
                _meta((g, self.p, self.n), f32))


@dataclasses.dataclass(frozen=True)
class GroupedGemmDescriptor(KernelDescriptor):
    """Ragged grouped GEMM (MoE expert compute): (T, K) x (E, K, N) -> (T, N).

    ``t`` is the static row count; the split of the rows into groups
    (``group_sizes``) is a runtime operand and not part of the descriptor:
    the kernel is shaped by the descriptor, the routing is data.  The
    ``bias`` operand of a bias epilogue is per expert, ``(E, N)``.
    """

    family = "grouped_gemm"

    t: int
    k: int
    n: int
    num_experts: int
    dtype: str = "float32"
    epilogue: Optional[str] = None
    quant: Optional[QuantSpec] = None
    # The expert dim sharded over mesh.axis; ``t`` and ``num_experts``
    # describe the GLOBAL problem, the planner derives the per-shard one.
    mesh: Optional[MeshSpec] = None

    def __post_init__(self):
        for v in (self.t, self.k, self.n, self.num_experts):
            if v <= 0:
                raise ValueError(
                    f"grouped-GEMM dims must be positive, got {self}")
        if self.epilogue not in EPILOGUES:
            raise ValueError(f"epilogue must be one of {EPILOGUES}")
        if self.quant is not None and not isinstance(self.quant, QuantSpec):
            raise ValueError(f"quant must be a QuantSpec, got {self.quant!r}")
        if self.mesh is not None:
            if not isinstance(self.mesh, MeshSpec):
                raise ValueError(f"mesh must be a MeshSpec, got {self.mesh!r}")
            if self.num_experts % self.mesh.size or self.t % self.mesh.size:
                raise ValueError(
                    f"mesh size {self.mesh.size} must divide both "
                    f"num_experts={self.num_experts} and t={self.t}")

    @classmethod
    def from_operands(cls, x, w, epilogue=None, quant=None, mesh=None):
        t, k = x.shape
        e, kw, n = w.shape
        if kw != k:
            raise ValueError(f"contraction mismatch: x{tuple(x.shape)} vs "
                             f"w{tuple(w.shape)}")
        return cls(t=t, k=k, n=n, num_experts=e,
                   dtype=canonical_dtype(x.dtype), epilogue=epilogue,
                   quant=resolve_quant(quant), mesh=mesh)

    @property
    def x_wire_itemsize(self) -> int:
        """Bytes per staged activation element (narrow only for a fully
        quantized grouped GEMM)."""
        if self.quant is not None and not self.quant.weight_only:
            return self.quant.wire_itemsize
        return itemsize(self.dtype)

    @property
    def w_wire_itemsize(self) -> int:
        """Bytes per staged expert-panel element (narrow under any spec)."""
        if self.quant is not None:
            return self.quant.wire_itemsize
        return itemsize(self.dtype)

    @property
    def compute_dtype(self) -> str:
        """Dtype pricing the products (see GemmDescriptor.compute_dtype)."""
        if self.quant is not None and not self.quant.weight_only:
            return self.quant.dtype
        return self.dtype

    @property
    def flops(self) -> int:
        # Each row contracts against exactly one expert's (K, N) panel.
        return 2 * self.t * self.k * self.n

    @property
    def in_bytes(self) -> int:
        total = (self.t * self.k * self.x_wire_itemsize
                 + self.num_experts * self.k * self.n * self.w_wire_itemsize)
        if self.quant is not None:
            # per-expert column scales (+ per-row activation scales)
            total += (self.num_experts * self.n + self.t) * 4
        return total

    @property
    def out_bytes(self) -> int:
        return self.t * self.n * itemsize(self.dtype)

    def meta_output(self):
        return _meta((self.t, self.n), self.dtype)


@dataclasses.dataclass(frozen=True)
class GroupedGemmBwdDescriptor(GroupedGemmDescriptor):
    """Grouped-GEMM backward: dY, X, W, group_sizes -> dX, dW, (db).  The
    forward's geometry under its own ``family``, so backward plans cache
    and count apart."""

    family = "grouped_gemm_bwd"

    @classmethod
    def from_forward(cls, desc: GroupedGemmDescriptor
                     ) -> "GroupedGemmBwdDescriptor":
        """Backward descriptor sharing a forward descriptor's geometry.
        The quant spec is dropped: quantization is an inference axis, and
        the backward runs in the wide dtype.  The mesh spec is dropped
        too: the distributed path runs the *local* grouped GEMM on each
        rank, so the backward geometry is the meshless per-shard problem."""
        fields = dataclasses.asdict(desc)
        fields["quant"] = None
        fields["mesh"] = None
        return cls(**fields)

    @property
    def flops(self) -> int:
        # dX = dY @ W^T and dW = X^T @ dY: twice the forward's products.
        return 2 * super().flops

    @property
    def in_bytes(self) -> int:
        return (self.t * (self.k + self.n)
                + self.num_experts * self.k * self.n) * itemsize(self.dtype)

    @property
    def out_bytes(self) -> int:
        # dX in the operand dtype; dW (and db when biased) in fp32.
        total = self.t * self.k * itemsize(self.dtype) \
            + self.num_experts * self.k * self.n * 4
        if self.epilogue in BIAS_EPILOGUES:
            total += self.num_experts * self.n * 4
        return total

    def meta_output(self):
        # fp32 (dX, dW, db or None), as the backward kernel writes them.
        e, f32 = self.num_experts, "float32"
        db = _meta((e, self.n), f32) if self.epilogue in BIAS_EPILOGUES \
            else None
        return (_meta((self.t, self.k), f32), _meta((e, self.k, self.n), f32),
                db)


@dataclasses.dataclass(frozen=True)
class TransposeDescriptor(KernelDescriptor):
    """Blocked (batched) 2-D transpose: (..., rows, cols) -> (..., cols,
    rows).  ``batch`` is a grid dimension of the one launch, so a batched
    transpose is ONE launch."""

    family = "transpose"

    rows: int
    cols: int
    dtype: str = "float32"
    # leading batch dim shared by in/out; 0 => unbatched 2-D transpose
    batch: int = 0

    def __post_init__(self):
        if self.rows <= 0 or self.cols <= 0:
            raise ValueError(f"transpose dims must be positive, got {self}")

    @classmethod
    def from_operands(cls, x):
        batch = 0
        if x.ndim == 3:
            batch = x.shape[0]
        elif x.ndim != 2:
            raise ValueError(f"transpose operand must be rank 2 or 3, "
                             f"got {x.ndim}")
        rows, cols = x.shape[-2], x.shape[-1]
        return cls(rows=rows, cols=cols, dtype=canonical_dtype(x.dtype),
                   batch=batch)

    @property
    def flops(self) -> int:
        return 0  # pure data movement

    @property
    def in_bytes(self) -> int:
        return max(1, self.batch) * self.rows * self.cols \
            * itemsize(self.dtype)

    @property
    def out_bytes(self) -> int:
        return self.in_bytes

    def meta_output(self):
        lead = (self.batch,) if self.batch else ()
        return _meta(lead + (self.cols, self.rows), self.dtype)


# ---------------------------------------------------------------------------
# Cache-key round trip
# ---------------------------------------------------------------------------

# Family name -> descriptor class, for rebuilding a descriptor from its
# engine cache key (tuning-cache entries and warm-start manifests).
_FAMILY_DESCRIPTORS = {
    cls.family: cls for cls in (
        GemmDescriptor, FlashDescriptor, FlashBwdDescriptor,
        FlashDecodeDescriptor, GroupedGemmDescriptor,
        GroupedGemmBwdDescriptor, SsdChunkDescriptor, SsdChunkBwdDescriptor,
        TransposeDescriptor)
}


def descriptor_from_cache_key(key) -> KernelDescriptor:
    """Rebuild the descriptor a ``cache_key()`` tuple names.

    ``cache_key()`` is ``(family,) + dataclasses.astuple(desc)``, the
    nested :class:`QuantSpec` / :class:`MeshSpec` recursed into plain
    tuples, so the key is invertible.  Raises ``ValueError`` on an
    unknown family or a field-count mismatch (a key written by another
    descriptor schema)."""
    key = tuple(key)
    if not key:
        raise ValueError("empty cache key")
    family, values = key[0], key[1:]
    cls = _FAMILY_DESCRIPTORS.get(family)
    if cls is None:
        raise ValueError(f"unknown descriptor family {family!r}; "
                         f"known: {sorted(_FAMILY_DESCRIPTORS)}")
    fields = dataclasses.fields(cls)
    if len(values) != len(fields):
        raise ValueError(
            f"{family} cache key carries {len(values)} fields, the "
            f"descriptor schema has {len(fields)}: written by another "
            f"version?")
    kwargs = {}
    for f, v in zip(fields, values):
        if v is not None:
            if f.name == "quant":
                v = QuantSpec(*v)
            elif f.name == "mesh":
                v = MeshSpec(*v)
            elif isinstance(v, list):
                v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)
