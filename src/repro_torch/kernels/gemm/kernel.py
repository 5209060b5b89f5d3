"""Wrappers around the Hopper GEMM kernels (``csrc/gemm.cu`` and
``csrc/gemm_quant.cu``), each beside its plain torch version.

  * :func:`gemm_fused` -- one launch over a whole plan's tile table (the
    counterpart of the reference's ``build_fused_gemm_kernel``);
  * :func:`gemm_region` -- one launch per plan region, writing into the
    full C (the counterpart of ``build_gemm_kernel``);
  * :func:`gemm_act_bwd` -- the backward epilogue of an activation GEMM
    over ``gemm_fused``'s tile table, ``dy * act'(C? + A @ op(B) + bias?)``
    (bf16 operands; no TPU kernel: the reference recomputes with XLA);
  * :func:`gemm_quant` -- the quantized form of ``gemm_fused``: int8 or
    e4m3 operands with their row and column scales, or a bf16 / fp32 A
    with an int8 / e4m3 B (W8A16), dequant fused into the epilogue (the
    counterpart of ``build_fused_gemm_kernel(quant=)``).  Each launch adds
    one to the route it took in :data:`QUANT_ROUTES`
    (:func:`choose_quant_route`), apart from the wide :data:`ROUTES`.

A wrapper runs its plain version only for tensors on the CPU.  For CUDA
tensors it launches the kernel or raises; nothing falls back.  Each
launch adds one to :data:`LAUNCHES`, and each wide launch one to the
route it took in :data:`ROUTES` (:func:`choose_route`): "A" (TMA ring and
wgmma, bm 64 / 128), "B" (the same ring computed swap-AB, decode's bm
16), "C" (bf16 operands TMA cannot take) or "fp32" (CUDA-core FMAs).
Routes A and B split K over a thread-block cluster of
:func:`split_factor` blocks where the plan has fewer tiles than the card
has SMs.
"""
from __future__ import annotations

import functools
import itertools
from typing import Optional

import torch

from repro_torch.core.machine import FP8_DTYPE, H100_SXM
from repro_torch.core.schedule import TileSchedule, pack_table
from repro_torch.kernels import _build, disable_tf32
from repro_torch.kernels.epilogue import (ACTIVATIONS, apply_epilogue,
                                          needs_bias)
from repro_torch.kernels.gemm.ref import ref_quant_gemm

# The H100_SXM palette owns the kernel's shapes: gemm.cu instantiates its
# (bm, bn) accumulator blockings in this order (its ``tile_by_shape``
# switch) and a K panel of ``k_panel`` (its ``BK``);
# tests/test_torch_kernel_sources.py holds the .cu files to these.
TEMPLATE_SHAPES = tuple(itertools.product(H100_SXM.bm_candidates,
                                          H100_SXM.bn_candidates))
K_PANEL = H100_SXM.k_panel
# The largest cluster gemm.cu splits one tile's K over (its MAX_CLUSTER).
MAX_CLUSTER = H100_SXM.gemm_max_cluster
# A split share sums at least this many K panels.
MIN_SPLIT_PANELS = 4
# Blocks take a region's tiles in bands of this many tile rows, a band
# column by column (gemm.cu's RASTER_ROWS), so the blocks in flight share
# B's column panels in L2.
RASTER_ROWS = 8

LAUNCHES = {"gemm_fused": 0, "gemm_region": 0, "gemm_quant": 0,
            "gemm_act_bwd": 0}
ROUTES = {"A": 0, "B": 0, "C": 0, "fp32": 0}
_ROUTE_CODE = {"A": 0, "B": 1, "C": 2, "fp32": 0}
# gemm_quant's routes (gemm_quant.cu's ROUTE_*), counted apart from the
# wide GEMM's so that those keep their meaning.
QUANT_ROUTES = {"A": 0, "B": 0, "C": 0, "fp32": 0}
QUANT_ROUTE_CODE = {"A": 0, "B": 1, "C": 2, "fp32": 3}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Operand codes of the quantized kernels (quant_tile.cuh's DT_*).
QUANT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
              FP8_DTYPE: 3}
WIRE_DTYPES = (torch.int8, FP8_DTYPE)
_EPILOGUE_CODE = {None: 0, "bias": 1, "gelu": 2, "silu": 3, "relu": 4,
                  "bias_gelu": 5, "bias_silu": 6}


def template_for(bm_e: int, bn_e: int) -> int:
    """Index of the smallest instantiated shape covering an effective
    (clamped) block."""
    fits = [i for i, (bm, bn) in enumerate(TEMPLATE_SHAPES)
            if bm >= bm_e and bn >= bn_e]
    if not fits:
        raise NotImplementedError(
            f"block ({bm_e}, {bn_e}) exceeds every GEMM kernel shape "
            f"{TEMPLATE_SHAPES}; plan with the H100_SXM machine model")
    return min(fits, key=lambda i: TEMPLATE_SHAPES[i][0] * TEMPLATE_SHAPES[i][1])


def choose_route(dtype, k: int, b_inner: int, max_bm: int,
                 ptrs=(0, 0)) -> str:
    """The kernel route of one call: "fp32" for fp32 operands; for bf16,
    "C" where TMA cannot read A or B (a base ``ptrs`` not 16-byte aligned,
    or a row -- ``k`` elements of A, ``b_inner`` of B -- that is not a
    multiple of 16 bytes), else "B" for a decode tile table (every
    template bm 16) and "A" otherwise."""
    if dtype == torch.float32:
        return "fp32"
    if any(p % 16 for p in ptrs) or (2 * k) % 16 or (2 * b_inner) % 16:
        return "C"
    return "B" if max_bm <= 16 else "A"


def choose_quant_route(a_dtype, b_dtype, k: int, n: int, layout: str,
                       max_bm: int, ptrs=(0, 0)) -> str:
    """The quantized kernel's route of one call: "fp32" for an fp32 A
    (W8A16); "C" where TMA cannot read A or B (a base ``ptrs`` not 16-byte
    aligned, or a row -- ``k`` elements of A, ``n`` bytes of an "nn" B,
    ``k`` of an "nt" B -- that is not a multiple of 16 bytes); else "B"
    for a decode tile table (every template bm 16) and "A" otherwise.
    ``b_dtype`` is the 8-bit weight's (one byte an element)."""
    if b_dtype not in WIRE_DTYPES:
        raise ValueError(f"B must be int8 or float8_e4m3, got {b_dtype}")
    if a_dtype == torch.float32:
        return "fp32"
    b_inner = n if layout == "nn" else k
    if any(p % 16 for p in ptrs) or (k * a_dtype.itemsize) % 16 \
            or b_inner % 16:
        return "C"
    return "B" if max_bm <= 16 else "A"


def _route(a, b, max_bm: int) -> str:
    return choose_route(a.dtype, a.shape[-1], b.shape[-1], max_bm,
                        (a.data_ptr(), b.data_ptr()))


def split_factor(tiles: int, k: int, sms: int, route: str) -> int:
    """Blocks one tile's K is split over (a cluster, whose leader reduces
    and stores): enough to bring ``tiles`` (table rows x batch) up to the
    card's ``sms``, at most :data:`MAX_CLUSTER`, each share at least
    :data:`MIN_SPLIT_PANELS` K panels.  Routes A and B only."""
    if route not in ("A", "B") or tiles >= sms:
        return 1
    panels = -(-k // K_PANEL)
    return max(1, min(MAX_CLUSTER, sms // tiles, panels // MIN_SPLIT_PANELS))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    device = torch.device(device)
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def raster_order(schedule: TileSchedule):
    """The tile table's rows in the order gemm_fused's blocks take them:
    each run of one block shape (a region) in bands of
    :data:`RASTER_ROWS` tile rows, a band column by column.  The rows are
    the schedule's own; only their order changes."""
    out = []
    for bid, rows in itertools.groupby(schedule.tiles, key=lambda t: t[6]):
        band = RASTER_ROWS * schedule.blocks[bid][0]
        out += sorted(rows, key=lambda t: (t[0] // band, t[1], t[0]))
    return out


def table_max_bm(schedule: TileSchedule) -> int:
    """The largest template bm a tile table walks: a table of bm 16 alone
    is a decode table (route B); a 128-row tile needs two warpgroups."""
    return max(TEMPLATE_SHAPES[template_for(bm, bn)][0]
               for bm, bn in schedule.blocks)


class FusedGemm:
    """One plan's fused kernel state: its tile schedule, and the tile
    table and block-shape array on the plan's device (uploaded once, when
    the engine's kernel cache builds this object)."""

    def __init__(self, schedule: TileSchedule, device):
        self.schedule = schedule
        self.device = torch.device(device)
        self.table = self.blocks = self.max_bm = None
        if self.device.type == "cuda":  # the plain walk reads the schedule
            self.max_bm = table_max_bm(schedule)
            blocks = [(template_for(bm, bn), bm, bn)
                      for bm, bn in schedule.blocks]
            self.table = torch.from_numpy(
                pack_table(raster_order(schedule))).to(self.device)
            self.blocks = torch.tensor(blocks, dtype=torch.int32,
                                       device=self.device)


_LIBS = {}


def _lib(name: str = "gemm"):
    """The built library ``gemm`` or ``gemm_quant``, with its C signatures
    declared (once)."""
    if name not in _LIBS:
        lib = _build.library(name)
        P, I = _build.P, _build.I
        if name == "gemm":
            lib.gemm_fused.argtypes = [P] * 7 + [I] * 14 + [P]
            lib.gemm_fused.restype = I
            lib.gemm_region.argtypes = [P] * 5 + [I] * 18 + [P]
            lib.gemm_region.restype = I
            lib.gemm_act_bwd.argtypes = [P] * 8 + [I] * 14 + [P]
            lib.gemm_act_bwd.restype = I
        else:
            lib.gemm_quant.argtypes = [P] * 8 + [I] * 13 + [P]
            lib.gemm_quant.restype = I
        _LIBS[name] = lib
    return _LIBS[name]


def _check_operands(a, b, bias, c, out_dtype, layout, epilogue):
    """Validate what the CUDA kernels take; returns (nb, m, n, k)."""
    if layout not in ("nn", "nt"):
        raise ValueError(f"layout must be nn or nt, got {layout!r}")
    if epilogue not in _EPILOGUE_CODE:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(f"expected rank-3 operands with a shared batch, got "
                         f"A{tuple(a.shape)} B{tuple(b.shape)}")
    nb, m, k = a.shape
    n = b.shape[2] if layout == "nn" else b.shape[1]
    if (b.shape[1] if layout == "nn" else b.shape[2]) != k:
        raise ValueError(f"contraction mismatch A{tuple(a.shape)} {layout} "
                         f"B{tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise ValueError(f"A/B dtype mismatch: {a.dtype} vs {b.dtype}")
    for name, t, shape in (("bias", bias, (n,)), ("c", c, (nb, m, n))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if needs_bias(epilogue) and bias is None:
        raise ValueError(f"epilogue {epilogue!r} requires a bias operand")
    if a.is_cuda:
        for name, t in (("a", a), ("b", b), ("bias", bias), ("c", c)):
            if t is None:
                continue
            if t.device != a.device or t.dtype not in _DTYPE_CODE:
                raise ValueError(f"{name}: the CUDA GEMM takes float32 or "
                                 f"bfloat16 tensors on {a.device}, got "
                                 f"{t.dtype} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if out_dtype not in _DTYPE_CODE:
            raise ValueError(f"unsupported output dtype {out_dtype}")
    elif a.device.type != "cpu":
        raise RuntimeError(f"no GEMM kernel for device {a.device}")
    return nb, m, n, k


def _codes(bias, c, out_dtype):
    return (0 if bias is None else _DTYPE_CODE[bias.dtype],
            0 if c is None else _DTYPE_CODE[c.dtype],
            _DTYPE_CODE[out_dtype])


def gemm_fused(exe: FusedGemm, a, b, *, layout: str = "nn",
               epilogue: Optional[str] = None, bias=None, c=None,
               out_dtype=torch.float32) -> torch.Tensor:
    """One launch over the whole tile table: ``a (nb,m,k)``, ``b (nb,k,n)``
    or ``(nb,n,k)``, optional ``c (nb,m,n)`` -> ``(nb,m,n)``."""
    nb, m, n, k = _check_operands(a, b, bias, c, out_dtype, layout, epilogue)
    s = exe.schedule
    if (s.m, s.n, s.k) != (m, n, k):
        raise ValueError(f"schedule is for {(s.m, s.n, s.k)}, operands "
                         f"are {(m, n, k)}")
    if not a.is_cuda:
        return gemm_fused_plain(s, a, b, layout=layout, epilogue=epilogue,
                                bias=bias, c=c, out_dtype=out_dtype)
    if exe.table is None or exe.table.device != a.device:
        raise ValueError(f"executor built for {exe.device}, operands on "
                         f"{a.device}")
    out = torch.empty((nb, m, n), dtype=out_dtype, device=a.device)
    bias_dt, c_dt, out_dt = _codes(bias, c, out_dtype)
    route = _route(a, b, exe.max_bm)
    split = split_factor(s.num_tiles * nb, k, sm_count(a.device), route)
    status = _lib().gemm_fused(
        _build.ptr(a), _build.ptr(b), _build.ptr(bias), _build.ptr(c),
        _build.ptr(out), _build.ptr(exe.table), _build.ptr(exe.blocks),
        s.num_tiles, nb, m, n, k, int(layout == "nt"), _DTYPE_CODE[a.dtype],
        bias_dt, c_dt, out_dt, _EPILOGUE_CODE[epilogue], _ROUTE_CODE[route],
        split, exe.max_bm, _build.stream_ptr(a))
    LAUNCHES["gemm_fused"] += 1
    ROUTES[route] += 1
    _build.check(status, "gemm_fused")
    return out


def gemm_act_bwd(exe: FusedGemm, a, b, dy, *, layout: str = "nn",
                 epilogue: str, bias=None, c=None,
                 out_dtype=torch.float32) -> torch.Tensor:
    """The backward epilogue in one launch over the tile table: ``dy *
    act'(C? + a @ op(b) + bias?)``, the cotangent of the pre-activation,
    for ``dy (nb,m,n)`` the output's cotangent; ``a`` and ``b`` bf16."""
    nb, m, n, k = _check_operands(a, b, bias, c, out_dtype, layout, epilogue)
    if epilogue not in ACTIVATIONS:
        raise ValueError(f"epilogue {epilogue!r} is not one of {ACTIVATIONS}")
    if tuple(dy.shape) != (nb, m, n):
        raise ValueError(f"dy has shape {tuple(dy.shape)}, expected "
                         f"{(nb, m, n)}")
    s = exe.schedule
    if (s.m, s.n, s.k) != (m, n, k):
        raise ValueError(f"schedule is for {(s.m, s.n, s.k)}, operands "
                         f"are {(m, n, k)}")
    if not a.is_cuda:
        return gemm_act_bwd_plain(a, b, dy, layout=layout, epilogue=epilogue,
                                  bias=bias, c=c, out_dtype=out_dtype)
    if a.dtype != torch.bfloat16:
        raise ValueError(f"gemm_act_bwd takes bfloat16 operands, got "
                         f"{a.dtype}")
    if dy.device != a.device or dy.dtype not in _DTYPE_CODE \
            or not dy.is_contiguous():
        raise ValueError(f"dy must be a contiguous float32 or bfloat16 "
                         f"tensor on {a.device}")
    if exe.table is None or exe.table.device != a.device:
        raise ValueError(f"executor built for {exe.device}, operands on "
                         f"{a.device}")
    out = torch.empty((nb, m, n), dtype=out_dtype, device=a.device)
    bias_dt, c_dt, out_dt = _codes(bias, c, out_dtype)
    route = _route(a, b, exe.max_bm)
    split = split_factor(s.num_tiles * nb, k, sm_count(a.device), route)
    status = _lib().gemm_act_bwd(
        _build.ptr(a), _build.ptr(b), _build.ptr(bias), _build.ptr(c),
        _build.ptr(dy), _build.ptr(out), _build.ptr(exe.table),
        _build.ptr(exe.blocks), s.num_tiles, nb, m, n, k,
        int(layout == "nt"), bias_dt, c_dt, _DTYPE_CODE[dy.dtype], out_dt,
        _EPILOGUE_CODE[epilogue], _ROUTE_CODE[route], split, exe.max_bm,
        _build.stream_ptr(a))
    LAUNCHES["gemm_act_bwd"] += 1
    ROUTES[route] += 1
    _build.check(status, "gemm_act_bwd")
    return out


def gemm_region(a, b, out, region, *, layout: str = "nn",
                epilogue: Optional[str] = None, bias=None, c=None) -> None:
    """One launch covering one plan region, written into ``out``
    (``(nb,m,n)``) in place."""
    nb, m, n, k = _check_operands(a, b, bias, c, out.dtype, layout, epilogue)
    if tuple(out.shape) != (nb, m, n):
        raise ValueError(f"out has shape {tuple(out.shape)}, expected {(nb, m, n)}")
    if not a.is_cuda:
        gemm_region_plain(a, b, out, region, layout=layout, epilogue=epilogue,
                          bias=bias, c=c)
        return
    if (region.bm, region.bn) not in TEMPLATE_SHAPES:
        raise NotImplementedError(
            f"region block ({region.bm}, {region.bn}) is not a GEMM kernel "
            f"shape {TEMPLATE_SHAPES}; plan with the H100_SXM machine model")
    if out.device != a.device or not out.is_contiguous():
        raise ValueError("out must be a contiguous tensor on the operands' device")
    bias_dt, c_dt, out_dt = _codes(bias, c, out.dtype)
    route = _route(a, b, region.bm)
    tiles = -(-region.rows // region.bm) * -(-region.cols // region.bn)
    split = split_factor(tiles * nb, k, sm_count(a.device), route)
    status = _lib().gemm_region(
        _build.ptr(a), _build.ptr(b), _build.ptr(bias), _build.ptr(c),
        _build.ptr(out), region.row0, region.col0, region.rows, region.cols,
        region.bm, region.bn, nb, m, n, k, int(layout == "nt"),
        _DTYPE_CODE[a.dtype], bias_dt, c_dt, out_dt, _EPILOGUE_CODE[epilogue],
        _ROUTE_CODE[route], split, _build.stream_ptr(a))
    LAUNCHES["gemm_region"] += 1
    ROUTES[route] += 1
    _build.check(status, "gemm_region")


def _check_quant(a, b, sa, sb, bias, out_dtype, layout, epilogue):
    """Validate what the quantized kernel takes; returns (m, n, k)."""
    if layout not in ("nn", "nt"):
        raise ValueError(f"layout must be nn or nt, got {layout!r}")
    if epilogue not in _EPILOGUE_CODE:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"the quantized GEMM is unbatched: A{tuple(a.shape)} "
                         f"B{tuple(b.shape)}")
    m, k = a.shape
    n, kb = (b.shape[1], b.shape[0]) if layout == "nn" else b.shape
    if kb != k:
        raise ValueError(f"contraction mismatch A{tuple(a.shape)} {layout} "
                         f"B{tuple(b.shape)}")
    if b.dtype not in WIRE_DTYPES:
        raise ValueError(f"B must be int8 or float8_e4m3, got {b.dtype}")
    if sa is not None:
        if a.dtype != b.dtype:
            raise ValueError(f"fully quantized A and B differ: {a.dtype}, "
                             f"{b.dtype}")
        if tuple(sa.shape) != (m,) or sa.dtype != torch.float32:
            raise ValueError(f"sa must be ({m},) float32")
    elif a.dtype not in _DTYPE_CODE:
        raise ValueError(f"a weight-only A is float32 or bfloat16, got "
                         f"{a.dtype}")
    if tuple(sb.shape) != (n,) or sb.dtype != torch.float32:
        raise ValueError(f"sb must be ({n},) float32")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias has shape {tuple(bias.shape)}, expected {(n,)}")
    if needs_bias(epilogue) and bias is None:
        raise ValueError(f"epilogue {epilogue!r} requires a bias operand")
    if a.is_cuda:
        for name, t in (("a", a), ("b", b), ("sa", sa), ("sb", sb),
                        ("bias", bias)):
            if t is not None and (t.device != a.device
                                  or not t.is_contiguous()):
                raise ValueError(f"{name} must be contiguous on {a.device}")
        if bias is not None and bias.dtype not in _DTYPE_CODE:
            raise ValueError(f"bias must be float32 or bfloat16")
        if out_dtype not in _DTYPE_CODE:
            raise ValueError(f"unsupported output dtype {out_dtype}")
    elif a.device.type != "cpu":
        raise RuntimeError(f"no GEMM kernel for device {a.device}")
    return m, n, k


def gemm_quant(exe: FusedGemm, a, b, sa, sb, *, layout: str = "nn",
               epilogue: Optional[str] = None, bias=None,
               out_dtype=torch.float32) -> torch.Tensor:
    """One launch over the whole tile table of a quantized GEMM: ``a (m,
    k)`` int8 / e4m3 with row scales ``sa (m,)`` (full quant), or bf16 /
    fp32 with ``sa=None`` (W8A16); ``b (k, n)`` or ``(n, k)`` int8 /
    e4m3 with column scales ``sb (n,)`` -> ``(m, n)`` in ``out_dtype``."""
    m, n, k = _check_quant(a, b, sa, sb, bias, out_dtype, layout, epilogue)
    s = exe.schedule
    if (s.m, s.n, s.k) != (m, n, k):
        raise ValueError(f"schedule is for {(s.m, s.n, s.k)}, operands "
                         f"are {(m, n, k)}")
    if not a.is_cuda:
        return gemm_quant_plain(a, b, sa, sb, layout=layout,
                                epilogue=epilogue, bias=bias,
                                out_dtype=out_dtype)
    if exe.table is None or exe.table.device != a.device:
        raise ValueError(f"executor built for {exe.device}, operands on "
                         f"{a.device}")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    route = choose_quant_route(a.dtype, b.dtype, k, n, layout, exe.max_bm,
                               (a.data_ptr(), b.data_ptr()))
    split = split_factor(s.num_tiles, k, sm_count(a.device), route)
    status = _lib("gemm_quant").gemm_quant(
        _build.ptr(a), _build.ptr(b), _build.ptr(sa), _build.ptr(sb),
        _build.ptr(bias), _build.ptr(out), _build.ptr(exe.table),
        _build.ptr(exe.blocks), s.num_tiles, m, n, k, int(layout == "nt"),
        QUANT_CODE[a.dtype], QUANT_CODE[b.dtype],
        0 if bias is None else _DTYPE_CODE[bias.dtype],
        _DTYPE_CODE[out_dtype], _EPILOGUE_CODE[epilogue],
        QUANT_ROUTE_CODE[route], split, exe.max_bm, _build.stream_ptr(a))
    LAUNCHES["gemm_quant"] += 1
    QUANT_ROUTES[route] += 1
    _build.check(status, "gemm_quant")
    return out


# ---------------------------------------------------------------------------
# Plain torch versions (the CPU path, and the card-side comparison)
# ---------------------------------------------------------------------------

def _b_window(b, layout, c0, c1):
    """Columns [c0, c1) of op(B) as an (nb, k, cols) fp32 view."""
    if layout == "nn":
        return b[:, :, c0:c1].float()
    return b[:, c0:c1, :].float().transpose(1, 2)


def gemm_fused_plain(schedule: TileSchedule, a, b, *, layout="nn",
                     epilogue=None, bias=None, c=None,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Walk the tile table tile by tile, as the kernel does: the window at
    the clamped origin, an fp32 product, the epilogue, and a store of the
    owned rectangle only."""
    if a.is_cuda:
        disable_tf32()
    nb, m, _ = a.shape
    out = torch.empty((nb, m, schedule.n), dtype=out_dtype, device=a.device)
    for row0, col0, row_end, col_end, rs, cs, bid, _ in schedule.tiles:
        bm, bn = schedule.blocks[bid]
        acc = a[:, rs:rs + bm].float() @ _b_window(b, layout, cs, cs + bn)
        if c is not None:
            acc = acc + c[:, rs:rs + bm, cs:cs + bn].float()
        acc = apply_epilogue(acc, epilogue,
                             None if bias is None else bias[cs:cs + bn])
        out[:, row0:row_end, col0:col_end] = \
            acc[:, row0 - rs:row_end - rs, col0 - cs:col_end - cs].to(out_dtype)
    return out


def gemm_region_plain(a, b, out, region, *, layout="nn", epilogue=None,
                      bias=None, c=None) -> None:
    """One region's rectangle of C in one fp32 product, written into out."""
    if a.is_cuda:
        disable_tf32()
    r0, r1 = region.row0, region.row0 + region.rows
    c0, c1 = region.col0, region.col0 + region.cols
    acc = a[:, r0:r1].float() @ _b_window(b, layout, c0, c1)
    if c is not None:
        acc = acc + c[:, r0:r1, c0:c1].float()
    acc = apply_epilogue(acc, epilogue, None if bias is None else bias[c0:c1])
    out[:, r0:r1, c0:c1] = acc.to(out.dtype)


def gemm_act_bwd_plain(a, b, dy, *, layout="nn", epilogue, bias=None, c=None,
                       out_dtype=torch.float32) -> torch.Tensor:
    """The backward epilogue's fp32 form: the pre-activation ``C? + a @
    op(b)`` as one fp32 product of the upcast operands (exact products;
    TF32 off), autograd of :func:`apply_epilogue` on it against ``dy``,
    cast once to ``out_dtype``.  ``a`` and ``b`` rank 2 or batched alike;
    the route of ``core.matmul``'s backward off the card's bf16 path."""
    if a.is_cuda:
        disable_tf32()
    b32 = b.float()
    pre = a.float() @ (b32 if layout == "nn" else b32.transpose(-1, -2))
    if c is not None:
        pre = pre + c.float()
    pre.requires_grad_(True)
    with torch.enable_grad():
        g, = torch.autograd.grad(apply_epilogue(pre, epilogue, bias), pre,
                                 dy.float())
    return g.to(out_dtype)


def gemm_quant_plain(a, b, sa, sb, *, layout="nn", epilogue=None, bias=None,
                     out_dtype=torch.float32) -> torch.Tensor:
    """The quantized kernel's arithmetic over the whole output at once
    (every element is owned by one tile, which sums its whole K): the
    exact-wide product (int32 for int8), the dequant factor, bias and
    activation (:func:`~repro_torch.kernels.gemm.ref.ref_quant_gemm`)."""
    if a.is_cuda:
        disable_tf32()
    return ref_quant_gemm(a, b, sa, sb, layout=layout, epilogue=epilogue,
                          bias=bias, out_dtype=out_dtype)


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES, QUANT_ROUTES):
        for name in counts:
            counts[name] = 0

