"""Wrappers around the Hopper SSD chunked-scan kernels (``csrc/ssd_scan.cu``
and ``csrc/ssd_scan_bwd.cu``), each beside its plain torch version.

  * :func:`ssd_scan_fused` -- the whole carried-state scan in one launch,
    optionally with the fp32 state entering each chunk (the counterpart of
    the reference's ``build_ssd_scan_kernel``, ``return_states``);
  * :func:`ssd_chunk_diag` -- the intra-chunk ladder alone over flat
    groups (the counterpart of ``build_ssd_chunk_kernel``).  Each call of
    either adds one to the route it took in :data:`SSD_FWD_ROUTES`
    (:func:`choose_fwd_route`): "A" (``H100_SXM``'s route-A limits and,
    for the scan, at most :data:`SSD_MAX_CLUSTER` chunks: a cluster of a
    block a chunk for each group, the carried state folded over the
    cluster; for the diag form a block a cell; every product on
    ``wgmma``) or "B" (one block a group or cell, CUDA-core FMAs);
  * :func:`ssd_scan_bwd` -- the reverse walk producing all seven fp32
    cotangents (the counterpart of ``build_ssd_scan_bwd_kernel``).  Each
    call adds one to the route it took in :data:`SSD_BWD_ROUTES`
    (:func:`choose_bwd_route`): "A" (bf16 C/B with fp32 L and xdt within
    ``H100_SXM``'s route-A limits: a cluster of :func:`bwd_cluster` blocks
    a group, each rank its :func:`bwd_chunks`, every product on
    ``wgmma``) or "B" (one block a group, CUDA-core FMAs).

Operands: C and B ``(G, NC, Q, n)`` (or ``(G, Q, n)`` for the diag form)
in one dtype, L ``(.., Q, Q)`` and xdt ``(.., Q, p)`` each float32 or
bfloat16, the decays ``(G, NC, Q)`` and states fp32.  A wrapper runs its
plain version only for CPU tensors; for CUDA tensors it launches the
kernel or raises.  Each launch adds one to :data:`LAUNCHES`.
"""
from __future__ import annotations

import torch

from repro_torch.core.machine import H100_SXM
from repro_torch.kernels import _build, disable_tf32
from repro_torch.kernels.ssd_chunk.ref import (ref_ssd_chunk_diag,
                                               ref_ssd_chunk_scan_bwd)

LAUNCHES = {"ssd_scan_fused": 0, "ssd_chunk_diag": 0, "ssd_scan_bwd": 0}
SSD_FWD_ROUTES = {"A": 0, "B": 0}
SSD_BWD_ROUTES = {"A": 0, "B": 0}
# ssd_scan.cu's and ssd_scan_bwd.cu's ROUTE_A / ROUTE_B, and their
# MAX_CLUSTER (the portable thread-block cluster size).
_ROUTE_CODE = {"A": 0, "B": 1}
SSD_MAX_CLUSTER = 8

_BF16 = {torch.float32: 0, torch.bfloat16: 1}

_LIBS = {}


def _lib(name: str):
    """The built library ``ssd_scan`` or ``ssd_scan_bwd``, with its C
    signatures declared (once)."""
    if name not in _LIBS:
        lib = _build.library(name)
        P, I = _build.P, _build.I
        if name == "ssd_scan":
            lib.ssd_scan_fused.argtypes = [P] * 10 + [I] * 9 + [P]
            lib.ssd_scan_fused.restype = I
            lib.ssd_chunk_diag.argtypes = [P] * 5 + [I] * 8 + [P]
            lib.ssd_chunk_diag.restype = I
        else:
            lib.ssd_scan_bwd.argtypes = [P] * 16 + [I] * 10 + [P]
            lib.ssd_scan_bwd.restype = I
        _LIBS[name] = lib
    return _LIBS[name]


def _check(c, b, l, x, extra=()):
    """Shapes, dtypes and, on the card, placement.  The kernels' limits
    are ``H100_SXM.ssd_max_*``, which the planner checks; the .cu entries
    refuse geometry outside them.  ``extra``: (name, tensor, shape) of the
    fp32 operands."""
    lead = c.shape[:-2]
    q, p = c.shape[-2], x.shape[-1]
    want = {"b": (b, c.shape), "l": (l, (*lead, q, q)),
            "x": (x, (*lead, q, p))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)} beside c "
                             f"{tuple(c.shape)}, got {tuple(t.shape)}")
    for name, t, shape in extra:
        if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {tuple(shape)} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if b.dtype != c.dtype:
        raise ValueError(f"c and b dtypes differ: {c.dtype}, {b.dtype}")
    if c.is_cuda:
        for name, t in (("c", c), ("b", b), ("l", l), ("x", x),
                        *((e[0], e[1]) for e in extra)):
            if t.device != c.device or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous on {c.device}")
        for name, t in (("c", c), ("l", l), ("x", x)):
            if t.dtype not in _BF16:
                raise ValueError(f"the CUDA SSD kernels take float32 or "
                                 f"bfloat16 {name}, got {t.dtype}")
        if c.shape[0] > 2 ** 31 - 1:
            raise NotImplementedError("more than 2^31 - 1 groups")
    elif c.device.type != "cpu":
        raise RuntimeError(f"no SSD kernel for device {c.device}")


def _codes(c, l, x):
    return _BF16[c.dtype], _BF16[l.dtype], _BF16[x.dtype]


def _route_a_fits(c_dtype, l_dtype, x_dtype, q: int, n: int, p: int,
                  ptrs) -> bool:
    """Route A's limits, the forward's and the backward's alike: bf16 C
    and B with fp32 L and xdt, a chunk of a multiple of ``ssd_a_block``
    rows, a state of ``ssd_a_state`` and a head dim of ``ssd_a_head_dim``
    (``H100_SXM``), every base in ``ptrs`` 16-byte aligned (the kernels'
    vector loads)."""
    m = H100_SXM
    return (c_dtype == torch.bfloat16 and l_dtype == torch.float32
            and x_dtype == torch.float32 and q % m.ssd_a_block == 0
            and n == m.ssd_a_state and p == m.ssd_a_head_dim
            and not any(t % 16 for t in ptrs))


def choose_bwd_route(c_dtype, l_dtype, x_dtype, q: int, n: int, p: int,
                     ptrs=()) -> str:
    """The route of one :func:`ssd_scan_bwd` call: "A" within route A's
    limits (:func:`_route_a_fits`), else "B"."""
    return "A" if _route_a_fits(c_dtype, l_dtype, x_dtype, q, n, p,
                                ptrs) else "B"


def choose_fwd_route(c_dtype, l_dtype, x_dtype, q: int, n: int, p: int,
                     chunks: int = 1, ptrs=()) -> str:
    """The route of one :func:`ssd_scan_fused` call of ``chunks`` chunks a
    group, or of one :func:`ssd_chunk_diag` call (one chunk a cell): "A"
    within route A's limits (:func:`_route_a_fits`) and at most
    :data:`SSD_MAX_CLUSTER` chunks (a cluster holds a block a chunk), else
    "B"."""
    return "A" if chunks <= SSD_MAX_CLUSTER and _route_a_fits(
        c_dtype, l_dtype, x_dtype, q, n, p, ptrs) else "B"


def bwd_cluster(chunks: int) -> int:
    """Blocks of one group on the backward's route A, a thread-block
    cluster: one a chunk, at most :data:`SSD_MAX_CLUSTER`."""
    return min(chunks, SSD_MAX_CLUSTER)


def bwd_chunks(chunks: int, cluster: int, rank: int):
    """Chunks ``[lo, hi)`` that rank ``rank`` of a group's cluster walks on
    the backward's route A (as ``ssd_scan_bwd.cu`` splits them):
    contiguous runs whose lengths differ by at most one, none empty."""
    return rank * chunks // cluster, (rank + 1) * chunks // cluster


def ssd_scan_fused(c, b, l, x, decay_in, decay_out, s0, *,
                   return_states: bool = False):
    """One launch over the whole scan -> ``(y (G, NC, Q, p) in x's dtype,
    s_final (G, p, n) fp32)``, plus the fp32 ``(G, NC, p, n)`` state
    entering each chunk when ``return_states``."""
    if c.ndim != 4:
        raise ValueError(f"expected c (G, NC, Q, n), got {tuple(c.shape)}")
    g, nc, q, n = c.shape
    p = x.shape[-1]
    _check(c, b, l, x, (("decay_in", decay_in, (g, nc, q)),
                        ("decay_out", decay_out, (g, nc, q)),
                        ("s0", s0, (g, p, n))))
    if not c.is_cuda:
        return ssd_scan_fused_plain(c, b, l, x, decay_in, decay_out, s0,
                                    return_states=return_states)
    y = torch.empty_like(x)
    sf = torch.empty((g, p, n), dtype=torch.float32, device=c.device)
    states = torch.empty((g, nc, p, n), dtype=torch.float32,
                         device=c.device) if return_states else None
    ins = (c, b, l, x, decay_in, decay_out, s0, y, sf, states)
    route = choose_fwd_route(c.dtype, l.dtype, x.dtype, q, n, p, nc,
                             tuple(t.data_ptr() for t in ins
                                   if t is not None))
    status = _lib("ssd_scan").ssd_scan_fused(
        *(_build.ptr(t) for t in ins), g, nc, q, n, p, *_codes(c, l, x),
        _ROUTE_CODE[route], _build.stream_ptr(c))
    LAUNCHES["ssd_scan_fused"] += 1
    SSD_FWD_ROUTES[route] += 1
    _build.check(status, "ssd_scan_fused")
    return (y, sf, states) if return_states else (y, sf)


def ssd_chunk_diag(c, b, l, x) -> torch.Tensor:
    """One launch of the intra-chunk ladder over ``(G, Q, ·)`` groups ->
    ``(G, Q, p)`` in x's dtype."""
    if c.ndim != 3:
        raise ValueError(f"expected c (G, Q, n), got {tuple(c.shape)}")
    _check(c, b, l, x)
    if not c.is_cuda:
        return ssd_chunk_diag_plain(c, b, l, x)
    g, q, n = c.shape
    p = x.shape[-1]
    y = torch.empty_like(x)
    ins = (c, b, l, x, y)
    route = choose_fwd_route(c.dtype, l.dtype, x.dtype, q, n, p, 1,
                             tuple(t.data_ptr() for t in ins))
    status = _lib("ssd_scan").ssd_chunk_diag(
        *(_build.ptr(t) for t in ins), g, q, n, p, *_codes(c, l, x),
        _ROUTE_CODE[route], _build.stream_ptr(c))
    LAUNCHES["ssd_chunk_diag"] += 1
    SSD_FWD_ROUTES[route] += 1
    _build.check(status, "ssd_chunk_diag")
    return y


def ssd_scan_bwd(c, b, l, x, decay_in, decay_out, states, dy, dsf):
    """One reverse-walk launch -> fp32 ``(dC, dB, dL, dxdt, d_decay_in,
    d_decay_out, ds0)``.  ``states`` is the forward's fp32 ``(G, NC, p,
    n)`` entering states; ``dy`` ``(G, NC, Q, p)`` and ``dsf`` ``(G, p,
    n)`` are fp32 cotangents."""
    if c.ndim != 4:
        raise ValueError(f"expected c (G, NC, Q, n), got {tuple(c.shape)}")
    g, nc, q, n = c.shape
    p = x.shape[-1]
    _check(c, b, l, x, (("decay_in", decay_in, (g, nc, q)),
                        ("decay_out", decay_out, (g, nc, q)),
                        ("states", states, (g, nc, p, n)),
                        ("dy", dy, (g, nc, q, p)), ("dsf", dsf, (g, p, n))))
    if not c.is_cuda:
        return ssd_scan_bwd_plain(c, b, l, x, decay_in, decay_out, states,
                                  dy, dsf)
    ins = (c, b, l, x, decay_in, decay_out, states, dy, dsf)
    route = choose_bwd_route(c.dtype, l.dtype, x.dtype, q, n, p,
                             tuple(t.data_ptr() for t in ins))
    f32 = dict(dtype=torch.float32, device=c.device)
    dc, db = torch.empty(c.shape, **f32), torch.empty(c.shape, **f32)
    dl, dx = torch.empty(l.shape, **f32), torch.empty(x.shape, **f32)
    ddi, ddo = torch.empty((g, nc, q), **f32), torch.empty((g, nc, q), **f32)
    ds0 = torch.empty((g, p, n), **f32)
    status = _lib("ssd_scan_bwd").ssd_scan_bwd(
        *(_build.ptr(t) for t in (*ins, dc, db, dl, dx, ddi, ddo, ds0)),
        g, nc, q, n, p, *_codes(c, l, x), _ROUTE_CODE[route],
        bwd_cluster(nc), _build.stream_ptr(c))
    LAUNCHES["ssd_scan_bwd"] += 1
    SSD_BWD_ROUTES[route] += 1
    _build.check(status, "ssd_scan_bwd")
    return dc, db, dl, dx, ddi, ddo, ds0


# ---------------------------------------------------------------------------
# Plain torch versions (the CPU path, and the card-side comparison)
# ---------------------------------------------------------------------------

def ssd_scan_fused_plain(c, b, l, x, decay_in, decay_out, s0, *,
                         return_states: bool = False):
    """The fused kernel's arithmetic, all groups at once, chunk by chunk:
    W = round_x((C·Bᵀ) ⊙ L), y = W·xdt + (C·Sᵀ) ⊙ decay_in in fp32 then
    rounded once to xdt's dtype, S ← S·decay_in[Q-1] +
    round_x(xdt ⊙ decay_out)ᵀ·B."""
    if c.is_cuda:
        disable_tf32()
    nc = c.shape[1]
    state = s0.float()
    ys, states = [], []
    for ci in range(nc):
        states.append(state)
        cc, bc, xc = c[:, ci].float(), b[:, ci].float(), x[:, ci]
        di, do = decay_in[:, ci], decay_out[:, ci]
        w = (torch.einsum("gqn,gkn->gqk", cc, bc) * l[:, ci].float()) \
            .to(x.dtype)
        y = torch.einsum("gqk,gkp->gqp", w.float(), xc.float()) \
            + torch.einsum("gqn,gpn->gqp", cc, state) * di[..., None]
        ys.append(y.to(x.dtype))
        xw = (xc.float() * do[..., None]).to(x.dtype)
        state = state * di[:, -1, None, None] \
            + torch.einsum("gqp,gqn->gpn", xw.float(), bc)
    out = (torch.stack(ys, dim=1), state)
    return (*out, torch.stack(states, dim=1)) if return_states else out


def ssd_chunk_diag_plain(c, b, l, x) -> torch.Tensor:
    """The diag kernel's arithmetic: the reference's intra-chunk oracle
    (scores in fp32, W rounded to xdt's dtype, the product in fp32)."""
    if c.is_cuda:
        disable_tf32()
    return ref_ssd_chunk_diag(c, b, l, x)


def ssd_scan_bwd_plain(c, b, l, x, decay_in, decay_out, states, dy, dsf):
    """The backward kernel's arithmetic: the reverse-walk oracle."""
    if c.is_cuda:
        disable_tf32()
    return ref_ssd_chunk_scan_bwd(c, b, l, x, decay_in, decay_out, states,
                                  dy, dsf)


def reset_launches() -> None:
    for counts in (LAUNCHES, SSD_FWD_ROUTES, SSD_BWD_ROUTES):
        for name in counts:
            counts[name] = 0
