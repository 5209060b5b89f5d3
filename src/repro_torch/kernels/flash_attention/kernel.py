"""Wrappers around the Hopper flash-attention kernels (``csrc/flash_fwd.cu``
and ``csrc/flash_bwd.cu``), each beside its plain torch version.

  * :func:`flash_fwd_fused` -- one launch walking a plan's causal-aware
    tile table, one thread block per (q-block, batch-head), optionally
    with the ``(BH, sq)`` fp32 log-sum-exp rows (the counterpart of the
    reference's ``build_fused_flash_kernel``, ``return_lse``);
  * :func:`flash_fwd_dense` -- one launch over the dense (q-block,
    batch-head) grid, skipping k-blocks past the causal diagonal (the
    counterpart of ``build_flash_kernel``);
  * :func:`flash_bwd_fused` -- one launch producing fp32 dQ, dK and dV
    over the same table, one thread block per (k-block, batch-head) (the
    counterpart of ``build_fused_flash_bwd_kernel``).

Operands are ``(BH, s, d)``.  A wrapper runs its plain version only for
CPU tensors; for CUDA tensors it launches the kernel or raises.  Each
launch adds one to :data:`LAUNCHES`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.schedule import FlashTileSchedule, ceil_div, pack_table
from repro_torch.kernels import _build, disable_tf32

NEG_INF = -1e30

# Limits of flash_fwd.cu and flash_bwd.cu (their BQ_MAX = BK_MAX and
# D_MAX): block edges up to 64 rows, head dim up to 128.
# tests/test_torch_kernel_sources.py holds the .cu files and
# H100_SXM.flash_blocks to these.
MAX_BLOCK = 64
MAX_HEAD_DIM = 128

LAUNCHES = {"flash_fwd_fused": 0, "flash_fwd_dense": 0, "flash_bwd_fused": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class FusedFlash:
    """One plan's fused kernel state: the tile schedule, and on the plan's
    device the tile table, the per-q-block ``(row_start, row_count)``
    index the forward walks and the per-k-block CSR index the backward
    walks (uploaded once, when the engine's kernel cache builds it)."""

    def __init__(self, schedule: FlashTileSchedule, device):
        self.schedule = schedule
        self.device = torch.device(device)
        self.table = torch.from_numpy(pack_table(schedule.tiles)).to(self.device)
        self.q_index = torch.from_numpy(schedule.q_block_index()).to(self.device)
        offsets, rows = schedule.k_block_index()
        self.k_offsets = torch.from_numpy(offsets).to(self.device)
        self.k_rows = torch.from_numpy(rows).to(self.device)


_LIBS = {}


def _lib(name: str):
    """The built library ``flash_fwd`` or ``flash_bwd``, with its C
    signatures declared (once)."""
    if name not in _LIBS:
        lib = _build.library(name)
        P, I, Fl = _build.P, _build.I, _build.F
        if name == "flash_fwd":
            lib.flash_fwd_fused.argtypes = [P] * 7 + [I] * 8 + [Fl, I, P]
            lib.flash_fwd_fused.restype = I
            lib.flash_fwd_dense.argtypes = [P] * 4 + [I] * 7 + [Fl, I, P]
            lib.flash_fwd_dense.restype = I
        else:
            lib.flash_bwd_fused.argtypes = [P] * 12 + [I] * 8 + [Fl, I, P]
            lib.flash_bwd_fused.restype = I
        _LIBS[name] = lib
    return _LIBS[name]


def _check(qf, kf, vf, bq, bk):
    if qf.ndim != 3 or kf.shape != vf.shape or kf.ndim != 3 \
            or qf.shape[0] != kf.shape[0] or qf.shape[2] != kf.shape[2]:
        raise ValueError(f"expected q (BH,sq,d), k/v (BH,sk,d), got "
                         f"{tuple(qf.shape)}, {tuple(kf.shape)}, "
                         f"{tuple(vf.shape)}")
    if not (qf.dtype == kf.dtype == vf.dtype):
        raise ValueError("q/k/v dtypes differ")
    if qf.is_cuda:
        for name, t in (("q", qf), ("k", kf), ("v", vf)):
            if t.device != qf.device or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous on {qf.device}")
        if qf.dtype not in _DTYPE_CODE:
            raise ValueError(f"the CUDA flash kernels take float32 or "
                             f"bfloat16, got {qf.dtype}")
        if qf.shape[2] > MAX_HEAD_DIM or bq > MAX_BLOCK or bk > MAX_BLOCK:
            raise NotImplementedError(
                f"flash kernel limits: head dim <= {MAX_HEAD_DIM}, blocks <= "
                f"{MAX_BLOCK}; got d={qf.shape[2]}, bq={bq}, bk={bk}")
        if qf.shape[0] > 65535:
            raise NotImplementedError("batch x heads above 65535")
    elif qf.device.type != "cpu":
        raise RuntimeError(f"no flash kernel for device {qf.device}")


def _check_schedule(exe: FusedFlash, qf, kf):
    s = exe.schedule
    if (qf.shape[1], kf.shape[1]) != (s.sq, s.sk):
        raise ValueError(f"schedule is for sq={s.sq}, sk={s.sk}")
    if qf.is_cuda and exe.table.device != qf.device:
        raise ValueError(f"tile table on {exe.table.device}, operands on "
                         f"{qf.device}")


def flash_fwd_fused(exe: FusedFlash, qf, kf, vf, *, return_lse: bool = False):
    """One launch over the plan's tile table -> ``(BH, sq, d)``, or
    ``(out, lse)`` with the ``(BH, sq)`` fp32 log-sum-exp rows when
    ``return_lse`` (the same launch; its drain also writes the LSE)."""
    s = exe.schedule
    _check(qf, kf, vf, s.bq, s.bk)
    _check_schedule(exe, qf, kf)
    if not qf.is_cuda:
        out, lse = flash_fwd_fused_plain(s, qf, kf, vf, return_lse=True)
        return (out, lse) if return_lse else out
    bh, sq, d = qf.shape
    out = torch.empty_like(qf)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=qf.device) \
        if return_lse else None
    status = _lib("flash_fwd").flash_fwd_fused(
        _build.ptr(qf), _build.ptr(kf), _build.ptr(vf), _build.ptr(out),
        _build.ptr(lse), _build.ptr(exe.table), _build.ptr(exe.q_index),
        s.num_q_blocks, bh, sq, s.sk, d, s.bq, s.bk, int(s.causal),
        d ** -0.5, _DTYPE_CODE[qf.dtype], _build.stream_ptr(qf))
    LAUNCHES["flash_fwd_fused"] += 1
    _build.check(status, "flash_fwd_fused")
    return (out, lse) if return_lse else out


def flash_bwd_fused(exe: FusedFlash, qf, kf, vf, o, do, lse):
    """One launch over the plan's tile table -> fp32 ``(dq, dk, dv)``.

    ``o``/``do`` are ``(BH, sq, d)`` in the operands' dtype, ``lse`` the
    forward's ``(BH, sq)`` fp32 rows."""
    s = exe.schedule
    _check(qf, kf, vf, s.bq, s.bk)
    _check_schedule(exe, qf, kf)
    for name, t in (("o", o), ("do", do)):
        if t.shape != qf.shape or t.dtype != qf.dtype:
            raise ValueError(f"{name} must match q: {tuple(qf.shape)} "
                             f"{qf.dtype}, got {tuple(t.shape)} {t.dtype}")
    if lse.shape != qf.shape[:2] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be {tuple(qf.shape[:2])} float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if not qf.is_cuda:
        return flash_bwd_fused_plain(s, qf, kf, vf, o, do, lse)
    for name, t in (("o", o), ("do", do), ("lse", lse)):
        if t.device != qf.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {qf.device}")
    bh, sq, d = qf.shape
    # dQ collects atomic adds from every k-block, so it starts at zero:
    # an allocation, not one of the engine's launches.
    dq = torch.zeros((bh, sq, d), dtype=torch.float32, device=qf.device)
    dk = torch.empty((bh, s.sk, d), dtype=torch.float32, device=qf.device)
    dv = torch.empty_like(dk)
    status = _lib("flash_bwd").flash_bwd_fused(
        _build.ptr(qf), _build.ptr(kf), _build.ptr(vf), _build.ptr(o),
        _build.ptr(do), _build.ptr(lse), _build.ptr(dq), _build.ptr(dk),
        _build.ptr(dv), _build.ptr(exe.table), _build.ptr(exe.k_offsets),
        _build.ptr(exe.k_rows), s.num_k_blocks, bh, sq, s.sk, d, s.bq, s.bk,
        int(s.causal), d ** -0.5, _DTYPE_CODE[qf.dtype],
        _build.stream_ptr(qf))
    LAUNCHES["flash_bwd_fused"] += 1
    _build.check(status, "flash_bwd_fused")
    return dq, dk, dv


def flash_fwd_dense(qf, kf, vf, *, block_q: int, block_k: int,
                    causal: bool) -> torch.Tensor:
    """One launch over the dense (q-block, batch-head) grid."""
    bh, sq, d = qf.shape
    sk = kf.shape[1]
    bq, bk = min(block_q, sq), min(block_k, sk)
    _check(qf, kf, vf, bq, bk)
    if not qf.is_cuda:
        return flash_fwd_dense_plain(qf, kf, vf, block_q=bq, block_k=bk,
                                     causal=causal)
    out = torch.empty_like(qf)
    status = _lib("flash_fwd").flash_fwd_dense(
        _build.ptr(qf), _build.ptr(kf), _build.ptr(vf), _build.ptr(out), bh,
        sq, sk, d, bq, bk, int(causal), d ** -0.5, _DTYPE_CODE[qf.dtype],
        _build.stream_ptr(qf))
    LAUNCHES["flash_fwd_dense"] += 1
    _build.check(status, "flash_fwd_dense")
    return out


# ---------------------------------------------------------------------------
# Plain torch versions (the CPU path, and the card-side comparison).  Both
# run every batch-head at once and walk tiles in the kernels' order.
# ---------------------------------------------------------------------------

class _Carry:
    """Online-softmax state of one q-block across all batch-heads."""

    def __init__(self, bh, bq, d, device):
        self.m = torch.full((bh, bq, 1), NEG_INF, device=device)
        self.l = torch.zeros((bh, bq, 1), device=device)
        self.acc = torch.zeros((bh, bq, d), device=device)

    def update(self, s, v):
        """One step on a masked fp32 score tile and its value tile; P is
        rounded to V's dtype before the PV product."""
        m_new = torch.maximum(self.m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(self.m - m_new)
        self.l = self.l * alpha + p.sum(-1, keepdim=True)
        self.acc = self.acc * alpha + p.to(v.dtype).float() @ v.float()
        self.m = m_new

    def drain(self, dtype):
        return (self.acc / torch.clamp_min(self.l, 1e-30)).to(dtype)

    def lse(self):
        return (self.m + torch.log(torch.clamp_min(self.l, 1e-30)))[..., 0]


def _valid(bq, bk, qs, ks, k_lo, k_hi, causal, device, q_lo=None, q_hi=None):
    """(bq, bk) mask of the window at (qs, ks): key columns in [k_lo, k_hi),
    query rows in [q_lo, q_hi) when given, and kpos <= qpos if causal."""
    qpos = qs + torch.arange(bq, device=device)[:, None]
    kpos = ks + torch.arange(bk, device=device)[None, :]
    valid = (kpos >= k_lo) & (kpos < k_hi)
    if q_lo is not None:
        valid = valid & (qpos >= q_lo) & (qpos < q_hi)
    if causal:
        valid = valid & (kpos <= qpos)
    return valid


def _scores(q, k, scale, qs, ks, k_lo, k_hi, causal):
    s = (q.float() @ k.float().transpose(1, 2)) * scale
    valid = _valid(q.shape[1], k.shape[1], qs, ks, k_lo, k_hi, causal,
                   q.device)
    return torch.where(valid, s, NEG_INF)


def flash_fwd_fused_plain(schedule: FlashTileSchedule, qf, kf, vf, *,
                          return_lse: bool = False):
    """Walk the tile table with the m/l/acc carry, -1e30 masking and the
    drain into owned rows, as the fused kernel does; with ``return_lse``
    also drain ``m + log(max(l, 1e-30))`` into ``(BH, sq)`` fp32 rows."""
    if qf.is_cuda:
        disable_tf32()
    bh, sq, d = qf.shape
    bq, bk, scale = schedule.bq, schedule.bk, d ** -0.5
    out = torch.empty_like(qf)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=qf.device)
    carry = None
    for q0, q_end, qs, k0, k_end, ks, first, last in schedule.tiles:
        if first:
            carry = _Carry(bh, bq, d, qf.device)
        s = _scores(qf[:, qs:qs + bq], kf[:, ks:ks + bk], scale, qs, ks,
                    k0, k_end, schedule.causal)
        carry.update(s, vf[:, ks:ks + bk])
        if last:
            out[:, q0:q_end] = carry.drain(qf.dtype)[:, q0 - qs:q_end - qs]
            lse[:, q0:q_end] = carry.lse()[:, q0 - qs:q_end - qs]
    return (out, lse) if return_lse else out


def flash_bwd_fused_plain(schedule: FlashTileSchedule, qf, kf, vf, o, do,
                          lse):
    """Walk the tile table as the backward kernel's arithmetic does: per
    tile, D = rowsum(dO . O), P recomputed from the LSE, both axes owned
    (masked entries are selected to zero, so window overlap adds zero),
    fp32 throughout -> fp32 ``(dq, dk, dv)``."""
    if qf.is_cuda:
        disable_tf32()
    bh, sq, d = qf.shape
    sk = kf.shape[1]
    bq, bk, scale = schedule.bq, schedule.bk, d ** -0.5
    dq = torch.zeros((bh, sq, d), dtype=torch.float32, device=qf.device)
    dk = torch.zeros((bh, sk, d), dtype=torch.float32, device=qf.device)
    dv = torch.zeros_like(dk)
    for q0, q_end, qs, k0, k_end, ks, _, _ in schedule.tiles:
        qw, ow, dow = (t[:, qs:qs + bq].float() for t in (qf, o, do))
        kw, vw = (t[:, ks:ks + bk].float() for t in (kf, vf))
        drow = (dow * ow).sum(-1, keepdim=True)
        valid = _valid(bq, bk, qs, ks, k0, k_end, schedule.causal, qf.device,
                       q0, q_end)
        s = (qw @ kw.transpose(1, 2)) * scale
        p = torch.where(valid, torch.exp(s - lse[:, qs:qs + bq, None]), 0.0)
        dv[:, ks:ks + bk] += p.transpose(1, 2) @ dow
        dp = dow @ vw.transpose(1, 2)
        ds = torch.where(valid, p * (dp - drow) * scale, 0.0)
        dk[:, ks:ks + bk] += ds.transpose(1, 2) @ qw
        dq[:, qs:qs + bq] += ds @ kw
    return dq, dk, dv


def flash_fwd_dense_plain(qf, kf, vf, *, block_q: int, block_k: int,
                          causal: bool):
    """Loop over the dense (q-block, k-block) grid, skipping blocks past
    the causal diagonal; rows past sq / sk are zero padding and the KV
    tail is masked."""
    if qf.is_cuda:
        disable_tf32()
    bh, sq, d = qf.shape
    sk = kf.shape[1]
    bq, bk, scale = block_q, block_k, d ** -0.5
    cq, ck = ceil_div(sq, bq), ceil_div(sk, bk)
    qp = F.pad(qf, (0, 0, 0, cq * bq - sq))
    kp = F.pad(kf, (0, 0, 0, ck * bk - sk))
    vp = F.pad(vf, (0, 0, 0, ck * bk - sk))
    out = torch.empty_like(qf)
    for qi in range(cq):
        q0 = qi * bq
        carry = _Carry(bh, bq, d, qf.device)
        for ki in range(ck):
            if causal and ki * bk > q0 + bq - 1:
                continue
            k0 = ki * bk
            s = _scores(qp[:, q0:q0 + bq], kp[:, k0:k0 + bk], scale, q0, k0,
                        k0, sk, causal)
            carry.update(s, vp[:, k0:k0 + bk])
        out[:, q0:min(q0 + bq, sq)] = carry.drain(qf.dtype)[:, :min(bq, sq - q0)]
    return out


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
