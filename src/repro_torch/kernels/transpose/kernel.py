"""Wrapper around the Hopper tile-transpose kernel (``csrc/transpose.cu``)
beside its plain torch version.

:func:`transpose_tiles` -- ``(nb, rows, cols) -> (nb, cols, rows)`` in one
launch over the grid ``(ceil(cols / bt), ceil(rows / bt), nb)``, one
thread block per ``(bt, bt)`` tile staged through padded shared memory
(the counterpart of the reference's ``build_transpose_kernel``).  The
source may be a view with a row stride larger than its width (a padded
buffer): nothing past its logical extent is read.  Any dtype: the copy
moves bits, so the output is bit-exact.  A wrapper runs its plain version
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
Each launch adds one to :data:`LAUNCHES`.
"""
from __future__ import annotations

import torch

from repro_torch.core.machine import H100_SXM
from repro_torch.kernels import _build

LAUNCHES = {"transpose": 0}

# The tile edges csrc/transpose.cu instantiates (its BT_SMALL, BT_LARGE).
TILE_EDGES = H100_SXM.transpose_tiles

_LIB = None


def _lib():
    """The built ``transpose`` library, with its C signature declared."""
    global _LIB
    if _LIB is None:
        lib = _build.library("transpose")
        P, I, L = _build.P, _build.I, _build.L
        lib.transpose.argtypes = [P, P, I, I, I, L, L, I, I, P]
        lib.transpose.restype = I
        _LIB = lib
    return _LIB


def _source(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernel reads it: unit column stride (else a
    contiguous copy), rows and batches at any larger stride."""
    return x if x.stride(-1) == 1 else x.contiguous()


def transpose_tiles(x: torch.Tensor, *, bt: int) -> torch.Tensor:
    """One launch: ``x (nb, rows, cols)`` -> contiguous ``(nb, cols,
    rows)``."""
    if x.ndim != 3:
        raise ValueError(f"expected (nb, rows, cols), got {tuple(x.shape)}")
    if bt < 1:
        raise ValueError(f"tile edge must be positive, got {bt}")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise RuntimeError(f"no transpose kernel for device {x.device}")
        return transpose_plain(x, bt=bt)
    if bt not in TILE_EDGES:
        raise NotImplementedError(f"the CUDA transpose takes tile edges "
                                  f"{TILE_EDGES}, got {bt}; plan with the "
                                  f"H100_SXM machine model")
    nb, rows, cols = x.shape
    src = _source(x)
    out = torch.empty((nb, cols, rows), dtype=x.dtype, device=x.device)
    status = _lib().transpose(
        _build.ptr(src), _build.ptr(out), nb, rows, cols, src.stride(1),
        src.stride(0), bt, x.element_size(), _build.stream_ptr(x))
    LAUNCHES["transpose"] += 1
    _build.check(status, "transpose")
    return out


def transpose_plain(x: torch.Tensor, *, bt: int) -> torch.Tensor:
    """The kernel's blocked copy in torch, one strip of ``bt`` source rows
    at a time (every tile of the strip at once), reading only the logical
    extent."""
    nb, rows, cols = x.shape
    out = torch.empty((nb, cols, rows), dtype=x.dtype, device=x.device)
    for r0 in range(0, rows, bt):
        out[:, :, r0:r0 + bt] = x[:, r0:r0 + bt, :].transpose(1, 2)
    return out


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
