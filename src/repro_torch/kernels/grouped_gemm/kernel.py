"""Wrappers around the Hopper grouped-GEMM kernels (``csrc/grouped.cu``
and ``csrc/grouped_quant.cu``), each beside its plain torch version.

  * :func:`grouped_fused` -- one launch over the runtime tile table of a
    :class:`~repro_torch.core.schedule.GroupedTileSchedule`, one thread
    block per (table row, N block) (the counterpart of the reference's
    ``build_fused_grouped_kernel``); a bf16 block loads and multiplies only
    the 64-row boxes of its tile that hold owned rows;
  * :func:`grouped_padded` -- the pad/scatter lowering over groups padded
    to ``bm`` rows, one thread block per (row block, N block), the expert
    from ``block_expert`` (the counterpart of ``build_grouped_gemm_kernel``);
  * :func:`grouped_bwd` -- dX, dW and db in one deterministic launch over
    the same table (the counterpart of ``build_fused_grouped_bwd_kernel``);
    each launch adds one to the route it took in :data:`BWD_ROUTES`
    (:func:`choose_bwd_route`): "A" (TMA ring and wgmma, the fp32
    cotangent split into bf16 hi + lo in the kernel), "C" (bf16 operands
    TMA cannot read) or "fp32" (fp32 x and w), the last two on CUDA-core
    FMAs;
  * :func:`grouped_quant` -- the quantized form of ``grouped_fused``: int8
    or e4m3 x and w with per-row ``sx`` and per-expert column ``sw``
    scales, or a bf16 / fp32 x with an int8 / e4m3 w (W8A16), dequant in
    the epilogue (the counterpart of ``build_fused_grouped_kernel(quant=)``);
    each launch adds one to the route it took in :data:`QUANT_ROUTES`
    (:func:`choose_quant_route`), apart from the wide :data:`ROUTES`.

Operands are float32 or bfloat16 (x, w and bias in one dtype), outputs of
the forward kernels in x's dtype; the backward takes an fp32 cotangent and
returns fp32 gradients.  The kernels take the ``(bm, bn)`` tilings of
:data:`SHAPES` with a K panel of 32 (``H100_SXM.grouped_blocks``).  A
wrapper runs its plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.  Each launch adds one to :data:`LAUNCHES`,
and each forward launch of ``grouped_fused`` / ``grouped_padded`` one to
the route it took in :data:`ROUTES` (:func:`choose_route`): "A" (the TMA
ring and wgmma tile), "C" (bf16 operands TMA cannot take, loaded through
registers into the same tile) or "fp32" (CUDA-core FMAs).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.schedule import TILE_COMPUTE, TILE_ZERO
from repro_torch.kernels import _build, disable_tf32
from repro_torch.kernels.epilogue import apply_epilogue, needs_bias
from repro_torch.kernels.gemm.kernel import (QUANT_CODE, QUANT_ROUTE_CODE,
                                             WIRE_DTYPES,
                                             choose_quant_route as
                                             _gemm_quant_route)
from repro_torch.kernels.gemm.ref import quant_product
from repro_torch.kernels.grouped_gemm.ref import (expert_offsets,
                                                  ref_grouped_gemm_bwd)

LAUNCHES = {"grouped_fused": 0, "grouped_padded": 0, "grouped_bwd": 0,
            "grouped_quant": 0}
ROUTES = {"A": 0, "C": 0, "fp32": 0}
_ROUTE_CODE = {"A": 0, "C": 2, "fp32": 0}
# grouped_bwd's routes (grouped.cu's ROUTE_A, ROUTE_C, ROUTE_F32).
BWD_ROUTES = {"A": 0, "C": 0, "fp32": 0}
_BWD_ROUTE_CODE = {"A": 0, "C": 2, "fp32": 3}
# The backward's route A (grouped.cu's BWD_*): a dX tile is a table row's
# rows x BWD_TILE columns of K, a dW tile BWD_TILE x BWD_TILE of one
# expert; a ring stage is BWD_PANEL deep (N for dX, rows for dW), and
# BWD_STAGES of them are in flight.
BWD_TILE, BWD_PANEL, BWD_STAGES = 128, 32, 4
# grouped_quant's routes (grouped_quant.cu's ROUTE_*, gemm_quant's codes),
# counted apart from the wide forward's.
QUANT_ROUTES = {"A": 0, "B": 0, "C": 0, "fp32": 0}

# (bm, bn) tilings csrc/grouped.cu instantiates, in its shape order.
SHAPES = ((16, 64), (16, 128), (64, 64), (64, 128), (128, 64), (128, 128))

_DT = {torch.float32: 0, torch.bfloat16: 1}
_EPI = {None: 0, "bias": 1, "gelu": 2, "silu": 3, "relu": 4, "bias_gelu": 5,
        "bias_silu": 6}

_LIBS = {}


def _lib(name: str = "grouped"):
    """The built library ``grouped`` or ``grouped_quant``, with its C
    signatures declared."""
    if name not in _LIBS:
        lib = _build.library(name)
        P, I = _build.P, _build.I
        if name == "grouped":
            lib.grouped_fused.argtypes = [P] * 5 + [I] * 11 + [P]
            lib.grouped_fused.restype = I
            lib.grouped_padded.argtypes = [P] * 6 + [I] * 10 + [P]
            lib.grouped_padded.restype = I
            lib.grouped_bwd.argtypes = [P] * 8 + [I] * 8 + [P]
            lib.grouped_bwd.restype = I
        else:
            lib.grouped_quant.argtypes = [P] * 7 + [I] * 13 + [P]
            lib.grouped_quant.restype = I
        _LIBS[name] = lib
    return _LIBS[name]


def _check(x, w, bias, epilogue, extra=()):
    """Shapes, dtypes and, on the card, placement and contiguity.
    ``extra``: (name, tensor) of the int32 index operands."""
    if x.ndim != 2 or w.ndim != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"expected x (T, K) and w (E, K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.dtype != x.dtype:
        raise ValueError(f"x and w dtypes differ: {x.dtype}, {w.dtype}")
    if needs_bias(epilogue):
        if bias is None or tuple(bias.shape) != (w.shape[0], w.shape[2]):
            got = None if bias is None else tuple(bias.shape)
            raise ValueError(f"epilogue {epilogue!r} needs an (E, N) bias, "
                             f"got {got}")
    for name, t in extra:
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if x.is_cuda:
        operands = [("x", x), ("w", w), *extra]
        if needs_bias(epilogue):
            operands.append(("bias", bias))
        for name, t in operands:
            if t.device != x.device or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous on {x.device}")
        for name, t in (("x", x), ("bias", bias)):
            if t is not None and t.dtype not in _DT:
                raise ValueError(f"the CUDA grouped kernels take float32 or "
                                 f"bfloat16 {name}, got {t.dtype}")
    elif x.device.type != "cpu":
        raise RuntimeError(f"no grouped-GEMM kernel for device {x.device}")


def _check_tiles(bm: int, bn: int) -> None:
    if (bm, bn) not in SHAPES:
        raise NotImplementedError(f"the CUDA grouped kernels take (bm, bn) in "
                                  f"{SHAPES}, got {(bm, bn)}")


def _bias_code(bias) -> int:
    return _DT[bias.dtype] if bias is not None else 0


def choose_route(dtype, k: int, n: int, ptrs=(0, 0)) -> str:
    """The forward kernel's route for one call: "fp32" for fp32 operands;
    for bf16 "C" where TMA cannot read x or w (a base ``ptrs`` not 16-byte
    aligned, or a row -- ``k`` elements of x, ``n`` of w -- that is not a
    multiple of 16 bytes), else "A"."""
    if dtype == torch.float32:
        return "fp32"
    if any(p % 16 for p in ptrs) or (2 * k) % 16 or (2 * n) % 16:
        return "C"
    return "A"


def choose_quant_route(x_dtype, w_dtype, k: int, n: int, bm: int,
                       ptrs=(0, 0)) -> str:
    """grouped_quant's route for one call: "fp32" for an fp32 x (W8A16);
    "C" where TMA cannot read x or the bank (a base ``ptrs`` not 16-byte
    aligned, or a row -- ``k`` elements of x, ``n`` bytes of w -- that is
    not a multiple of 16 bytes); else "B" for bm 16 tiles (swap-AB) and
    "A" otherwise.  The bank is (E, K, N): the dense GEMM's "nn" rule."""
    return _gemm_quant_route(x_dtype, w_dtype, k, n, "nn", bm, ptrs)


def choose_bwd_route(dtype, k: int, n: int, ptrs=(0, 0, 0)) -> str:
    """The backward kernel's route for one call: "fp32" for fp32 x and w;
    for bf16 "C" where TMA cannot read x, w or the fp32 cotangent (a base
    ``ptrs`` not 16-byte aligned, or ``k`` or ``n`` not a multiple of 8:
    rows of x and w that are not a multiple of 16 bytes), else "A"."""
    if dtype == torch.float32:
        return "fp32"
    if any(p % 16 for p in ptrs) or k % 8 or n % 8:
        return "C"
    return "A"


def _route(x, w) -> str:
    return choose_route(x.dtype, x.shape[1], w.shape[2],
                        (x.data_ptr(), w.data_ptr()))


def grouped_fused(table, x, w, bias=None, *, bm: int, bn: int,
                  epilogue: Optional[str] = None) -> torch.Tensor:
    """One launch over the ``(max_tiles, 5)`` int32 tile table -> ``(T, N)``
    in x's dtype.  ``bm`` is the kernel's row tile (at least the table's
    block), ``bn`` its column tile."""
    _check(x, w, bias, epilogue, (("table", table),))
    if not x.is_cuda:
        return grouped_fused_plain(table, x, w, bias, epilogue=epilogue)
    _check_tiles(bm, bn)
    out = torch.empty((x.shape[0], w.shape[2]), dtype=x.dtype,
                      device=x.device)
    bias = bias if needs_bias(epilogue) else None
    route = _route(x, w)
    status = _lib().grouped_fused(
        _build.ptr(x), _build.ptr(w), _build.ptr(bias), _build.ptr(out),
        _build.ptr(table), table.shape[0], x.shape[0], x.shape[1],
        w.shape[2], w.shape[0], bm, bn, _DT[x.dtype], _bias_code(bias),
        _EPI[epilogue], _ROUTE_CODE[route], _build.stream_ptr(x))
    LAUNCHES["grouped_fused"] += 1
    ROUTES[route] += 1
    _build.check(status, "grouped_fused")
    return out


def grouped_padded(x_padded, w, block_expert, nrows, bias=None, *, bm: int,
                   bn: int, epilogue: Optional[str] = None) -> torch.Tensor:
    """One launch of the pad/scatter lowering: ``x_padded (T_pad, K)`` with
    every group padded to ``bm`` rows, ``block_expert (T_pad / bm,)`` and
    ``nrows (1,)`` int32 -> ``(T_pad, N)`` in x's dtype.  Blocks at or past
    ``nrows`` hold the epilogue of a zero accumulator."""
    _check(x_padded, w, bias, epilogue,
           (("block_expert", block_expert), ("nrows", nrows)))
    t_pad = x_padded.shape[0]
    if t_pad % bm or block_expert.shape != (t_pad // bm,):
        raise ValueError(f"x_padded rows {t_pad} must be block_expert "
                         f"{tuple(block_expert.shape)} blocks of {bm}")
    if not x_padded.is_cuda:
        return grouped_padded_plain(x_padded, w, block_expert, nrows, bias,
                                    bm=bm, epilogue=epilogue)
    _check_tiles(bm, bn)
    out = torch.empty((t_pad, w.shape[2]), dtype=x_padded.dtype,
                      device=x_padded.device)
    bias = bias if needs_bias(epilogue) else None
    route = _route(x_padded, w)
    status = _lib().grouped_padded(
        _build.ptr(x_padded), _build.ptr(w), _build.ptr(bias),
        _build.ptr(out), _build.ptr(block_expert), _build.ptr(nrows), t_pad,
        x_padded.shape[1], w.shape[2], w.shape[0], bm, bn,
        _DT[x_padded.dtype], _bias_code(bias), _EPI[epilogue],
        _ROUTE_CODE[route], _build.stream_ptr(x_padded))
    LAUNCHES["grouped_padded"] += 1
    ROUTES[route] += 1
    _build.check(status, "grouped_padded")
    return out


def grouped_bwd(table, x, dy, w, group_sizes, *, bm: int,
                with_db: bool = False):
    """One launch -> fp32 ``(dX (T, K), dW (E, K, N), db (E, N) or None)``
    from the fp32 pre-activation cotangent ``dy (T, N)``.  ``bm`` is the
    dX tile's rows (at least the table's block)."""
    _check(x, w, None, None, (("table", table),))
    if tuple(dy.shape) != (x.shape[0], w.shape[2]) \
            or dy.dtype != torch.float32:
        raise ValueError(f"dy must be {(x.shape[0], w.shape[2])} float32, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    if not x.is_cuda:
        return grouped_bwd_plain(table, x, dy, w, group_sizes,
                                 with_db=with_db)
    bms = sorted({s[0] for s in SHAPES})
    if bm not in bms:
        raise NotImplementedError(f"the CUDA grouped backward takes bm in "
                                  f"{bms}, got {bm}")
    if dy.device != x.device or not dy.is_contiguous():
        raise ValueError(f"dy must be contiguous on {x.device}")
    t, k = x.shape
    e, _, n = w.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, dw = torch.empty((t, k), **f32), torch.empty((e, k, n), **f32)
    db = torch.empty((e, n), **f32) if with_db else None
    offsets = expert_offsets(group_sizes).to(torch.int32)
    route = choose_bwd_route(x.dtype, k, n, (x.data_ptr(), w.data_ptr(),
                                             dy.data_ptr()))
    status = _lib().grouped_bwd(
        _build.ptr(x), _build.ptr(dy), _build.ptr(w), _build.ptr(table),
        _build.ptr(offsets), _build.ptr(dx), _build.ptr(dw), _build.ptr(db),
        table.shape[0], t, k, n, e, bm, _DT[x.dtype], _BWD_ROUTE_CODE[route],
        _build.stream_ptr(x))
    LAUNCHES["grouped_bwd"] += 1
    BWD_ROUTES[route] += 1
    _build.check(status, "grouped_bwd")
    return dx, dw, db


def _check_quant(table, x, w, sx, sw, bias, epilogue, out_dtype):
    if x.ndim != 2 or w.ndim != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"expected x (T, K) and w (E, K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    t, e, n = x.shape[0], w.shape[0], w.shape[2]
    if w.dtype not in WIRE_DTYPES:
        raise ValueError(f"w must be int8 or float8_e4m3, got {w.dtype}")
    if sx is not None:
        if x.dtype != w.dtype:
            raise ValueError(f"fully quantized x and w differ: {x.dtype}, "
                             f"{w.dtype}")
        if tuple(sx.shape) != (t,) or sx.dtype != torch.float32:
            raise ValueError(f"sx must be ({t},) float32")
    elif x.dtype not in _DT:
        raise ValueError(f"a weight-only x is float32 or bfloat16, got "
                         f"{x.dtype}")
    if tuple(sw.shape) != (e, n) or sw.dtype != torch.float32:
        raise ValueError(f"sw must be ({e}, {n}) float32")
    if needs_bias(epilogue) and (bias is None or
                                 tuple(bias.shape) != (e, n)):
        raise ValueError(f"epilogue {epilogue!r} needs an (E, N) bias")
    if table.dtype != torch.int32:
        raise ValueError(f"table must be int32, got {table.dtype}")
    if x.is_cuda:
        for name, t_ in (("x", x), ("w", w), ("sx", sx), ("sw", sw),
                         ("bias", bias), ("table", table)):
            if t_ is not None and (t_.device != x.device
                                   or not t_.is_contiguous()):
                raise ValueError(f"{name} must be contiguous on {x.device}")
        if out_dtype not in _DT or (bias is not None
                                    and bias.dtype not in _DT):
            raise ValueError("output and bias must be float32 or bfloat16")
    elif x.device.type != "cpu":
        raise RuntimeError(f"no grouped-GEMM kernel for device {x.device}")


def grouped_quant(table, x, w, sx, sw, bias=None, *, bm: int, bn: int,
                  epilogue: Optional[str] = None,
                  out_dtype=torch.float32) -> torch.Tensor:
    """One launch over the ``(max_tiles, 5)`` int32 tile table of a
    quantized grouped GEMM: x ``(T, K)`` int8 / e4m3 with ``sx (T,)``, or
    bf16 / fp32 with ``sx=None`` (W8A16); w ``(E, K, N)`` int8 / e4m3 with
    ``sw (E, N)`` -> ``(T, N)`` in ``out_dtype``."""
    bias = bias if needs_bias(epilogue) else None
    _check_quant(table, x, w, sx, sw, bias, epilogue, out_dtype)
    if not x.is_cuda:
        return grouped_quant_plain(table, x, w, sx, sw, bias,
                                   epilogue=epilogue, out_dtype=out_dtype)
    _check_tiles(bm, bn)
    out = torch.empty((x.shape[0], w.shape[2]), dtype=out_dtype,
                      device=x.device)
    route = choose_quant_route(x.dtype, w.dtype, x.shape[1], w.shape[2], bm,
                               (x.data_ptr(), w.data_ptr()))
    status = _lib("grouped_quant").grouped_quant(
        _build.ptr(x), _build.ptr(w), _build.ptr(sx), _build.ptr(sw),
        _build.ptr(bias), _build.ptr(out), _build.ptr(table), table.shape[0],
        x.shape[0], x.shape[1], w.shape[2], w.shape[0], bm, bn,
        QUANT_CODE[x.dtype], QUANT_CODE[w.dtype], _bias_code(bias),
        _DT[out_dtype], _EPI[epilogue], QUANT_ROUTE_CODE[route],
        _build.stream_ptr(x))
    LAUNCHES["grouped_quant"] += 1
    QUANT_ROUTES[route] += 1
    _build.check(status, "grouped_quant")
    return out


# ---------------------------------------------------------------------------
# Plain torch versions (the CPU path, and the card-side comparison)
# ---------------------------------------------------------------------------

def grouped_fused_plain(table, x, w, bias=None, *,
                        epilogue: Optional[str] = None) -> torch.Tensor:
    """The fused kernel's arithmetic, walking the table on the host: each
    COMPUTE row's x rows times its expert's panel in fp32, the epilogue
    with that expert's bias row, stored in x's dtype; ZERO rows zeros."""
    if x.is_cuda:
        disable_tf32()
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=x.dtype,
                      device=x.device)
    for row0, row_end, _, e, state in table.tolist():
        if state == TILE_COMPUTE:
            acc = x[row0:row_end].float() @ w[e].float()
            out[row0:row_end] = apply_epilogue(
                acc, epilogue, bias[e] if needs_bias(epilogue) else None
            ).to(x.dtype)
        elif state == TILE_ZERO:
            out[row0:row_end] = 0
    return out


def grouped_quant_plain(table, x, w, sx, sw, bias=None, *,
                        epilogue: Optional[str] = None,
                        out_dtype=torch.float32) -> torch.Tensor:
    """The quantized kernel's arithmetic, walking the table on the host:
    each COMPUTE row's x rows times its expert's panel in the exact-wide
    accumulator (int32 for int8), times ``sx * sw[e]`` in fp32, the
    epilogue with the expert's bias row; ZERO rows zeros."""
    if x.is_cuda:
        disable_tf32()
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=out_dtype,
                      device=x.device)
    for row0, row_end, _, e, state in table.tolist():
        if state == TILE_COMPUTE:
            factor = sw[e][None, :]
            if sx is not None:
                factor = sx[row0:row_end, None] * factor
            out[row0:row_end] = apply_epilogue(
                quant_product(x[row0:row_end], w[e]), epilogue,
                bias[e] if needs_bias(epilogue) else None, factor
            ).to(out_dtype)
        elif state == TILE_ZERO:
            out[row0:row_end] = 0
    return out


def grouped_padded_plain(x_padded, w, block_expert, nrows, bias=None, *,
                         bm: int, epilogue: Optional[str] = None
                         ) -> torch.Tensor:
    """The pad/scatter kernel's arithmetic, row block by row block; blocks
    at or past ``nrows`` hold the epilogue of a zero accumulator."""
    if x_padded.is_cuda:
        disable_tf32()
    t_pad = x_padded.shape[0]
    out = torch.empty((t_pad, w.shape[2]), dtype=x_padded.dtype,
                      device=x_padded.device)
    limit = int(nrows[0])
    for i, e in enumerate(block_expert.tolist()):
        rows = slice(i * bm, (i + 1) * bm)
        if i * bm < limit:
            acc = x_padded[rows].float() @ w[e].float()
        else:
            acc = torch.zeros((bm, w.shape[2]), dtype=torch.float32,
                              device=x_padded.device)
        out[rows] = apply_epilogue(
            acc, epilogue, bias[e] if needs_bias(epilogue) else None
        ).to(x_padded.dtype)
    return out


def grouped_bwd_plain(table, x, dy, w, group_sizes, *,
                      with_db: bool = False):
    """The backward kernel's arithmetic: the expert-by-expert fp32 oracle
    (the table's COMPUTE rows of expert e are exactly its rows)."""
    if x.is_cuda:
        disable_tf32()
    return ref_grouped_gemm_bwd(x, dy, w, group_sizes, with_db=with_db)


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES, BWD_ROUTES, QUANT_ROUTES):
        for name in counts:
            counts[name] = 0
