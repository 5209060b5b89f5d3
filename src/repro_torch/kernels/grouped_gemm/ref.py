"""Oracles for the ragged grouped GEMM (MoE expert compute).

Rows of ``x`` are sorted by group; ``group_sizes[e]`` rows belong to group
``e`` and are multiplied by ``w[e]``; rows past ``sum(group_sizes)``
belong to no group.

  * :func:`ref_grouped_gemm` -- a transliteration of the reference's
    ``grouped_gemm/ref.py``: it gathers each row's weight panel into a
    ``(T, K, N)`` tensor, so it is for small test sizes only;
  * :func:`ref_grouped_gemm_bwd` -- dX, dW and db from the pre-activation
    cotangent, expert by expert in fp32 (the plain version of the fused
    backward kernel; its sizes on the host, so any size fits);
  * :func:`ref_quant_grouped` -- the quantized form (the reference's
    ``_xla_quant_grouped``), expert by expert rather than through a
    ``(T, K, N)`` gather, so any size fits.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.epilogue import apply_epilogue
from repro_torch.kernels.gemm.ref import quant_product


def expert_offsets(group_sizes: torch.Tensor) -> torch.Tensor:
    """``(E + 1,)`` int64 row offsets of the groups, on their device."""
    sizes = group_sizes.long()
    return torch.cat([torch.zeros(1, dtype=torch.long, device=sizes.device),
                      torch.cumsum(sizes, 0)])


def row_experts(group_sizes: torch.Tensor, t: int):
    """``(expert of each row, row is in a group)`` for ``t`` rows (the
    reference's ``searchsorted(side="right")`` over the offsets)."""
    offsets = expert_offsets(group_sizes)
    row = torch.arange(t, device=offsets.device)
    expert = torch.clamp(torch.searchsorted(offsets, row, right=True) - 1,
                         0, group_sizes.shape[0] - 1)
    return expert, row < offsets[-1]


def ref_grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                     group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (T, K); w: (E, K, N); group_sizes: (E,) summing to <= T.

    Rows past ``sum(group_sizes)`` produce zeros.
    """
    expert, valid = row_experts(group_sizes, x.shape[0])
    w_rows = w[expert]  # (T, K, N) gather
    out = torch.einsum("tk,tkn->tn", x.float(), w_rows.float())
    return torch.where(valid[:, None], out, 0.0).to(x.dtype)


def ref_grouped_gemm_bwd(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor,
                         group_sizes: torch.Tensor, with_db: bool = False):
    """fp32 ``(dX (T, K), dW (E, K, N), db (E, N) or None)`` of
    ``out = x @ w[expert] (+ bias[expert])`` from the pre-activation
    cotangent ``dy (T, N)``: rows past ``sum(group_sizes)`` get zero dX,
    and an expert with no rows zero dW and db."""
    t, k = x.shape
    e, _, n = w.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.zeros((t, k), **f32)
    dw = torch.zeros((e, k, n), **f32)
    db = torch.zeros((e, n), **f32) if with_db else None
    offsets = expert_offsets(group_sizes).tolist()
    for i in range(e):
        r0, r1 = offsets[i], offsets[i + 1]
        if r1 == r0:
            continue
        xe, dye, we = x[r0:r1].float(), dy[r0:r1].float(), w[i].float()
        dx[r0:r1] = dye @ we.T
        dw[i] = xe.T @ dye
        if with_db:
            db[i] = dye.sum(0)
    return dx, dw, db


def ref_quant_grouped(x: torch.Tensor, w: torch.Tensor,
                      group_sizes: torch.Tensor, sx: Optional[torch.Tensor],
                      sw: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      *, epilogue: Optional[str] = None,
                      out_dtype=torch.float32) -> torch.Tensor:
    """Quantized grouped GEMM: row r of group e gives ``epilogue(dequant(
    x[r] @ w[e]))`` with the factor ``sx[r] * sw[e]`` (``sw[e]`` alone for
    W8A16, ``sx=None``) applied in fp32 to the exact-wide accumulator
    (int32 for int8); rows past ``sum(group_sizes)`` are zero."""
    offsets = expert_offsets(group_sizes).tolist()
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=out_dtype,
                      device=x.device)
    for e in range(w.shape[0]):
        r0, r1 = offsets[e], offsets[e + 1]
        if r1 == r0:
            continue
        factor = sw[e].float()[None, :]
        if sx is not None:
            factor = sx[r0:r1].float()[:, None] * factor
        out[r0:r1] = apply_epilogue(quant_product(x[r0:r1], w[e]), epilogue,
                                    None if bias is None else bias[e],
                                    factor).to(out_dtype)
    return out
