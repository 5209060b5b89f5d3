"""Wrappers around the Hopper flash-attention forward kernels
(``csrc/flash_fwd.cu``), each beside its plain torch version.

  * :func:`flash_fwd_fused` -- one launch walking a plan's causal-aware
    tile table, one thread block per (q-block, batch-head) (the
    counterpart of the reference's ``build_fused_flash_kernel``);
  * :func:`flash_fwd_dense` -- one launch over the dense (q-block,
    batch-head) grid, skipping k-blocks past the causal diagonal (the
    counterpart of ``build_flash_kernel``).

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

# Limits of flash_fwd.cu (its BQ_MAX = BK_MAX and D_MAX): block edges up
# to 64 rows, head dim up to 128.  tests/test_torch_kernel_sources.py
# holds the .cu file and H100_SXM.flash_blocks to these.
MAX_BLOCK = 64
MAX_HEAD_DIM = 128

LAUNCHES = {"flash_fwd_fused": 0, "flash_fwd_dense": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class FusedFlash:
    """One plan's fused kernel state: the tile schedule, and the tile table
    plus the per-q-block ``(row_start, row_count)`` index on the plan's
    device (uploaded once, when the engine's kernel cache builds it)."""

    def __init__(self, schedule: FlashTileSchedule, device):
        self.schedule = schedule
        self.device = torch.device(device)
        self.table = torch.from_numpy(pack_table(schedule.tiles)).to(self.device)
        self.q_index = torch.from_numpy(schedule.q_block_index()).to(self.device)


_LIB = None


def _lib():
    """The built library, with its C signatures declared (once)."""
    global _LIB
    if _LIB is None:
        lib = _build.library("flash_fwd")
        P, I, Fl = _build.P, _build.I, _build.F
        lib.flash_fwd_fused.argtypes = [P] * 6 + [I] * 8 + [Fl, I, P]
        lib.flash_fwd_fused.restype = I
        lib.flash_fwd_dense.argtypes = [P] * 4 + [I] * 7 + [Fl, I, P]
        lib.flash_fwd_dense.restype = I
        _LIB = lib
    return _LIB


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


def flash_fwd_fused(exe: FusedFlash, qf, kf, vf) -> torch.Tensor:
    """One launch over the plan's tile table -> ``(BH, sq, d)``."""
    s = exe.schedule
    _check(qf, kf, vf, s.bq, s.bk)
    if (qf.shape[1], kf.shape[1]) != (s.sq, s.sk):
        raise ValueError(f"schedule is for sq={s.sq}, sk={s.sk}")
    if not qf.is_cuda:
        return flash_fwd_fused_plain(s, qf, kf, vf)
    if exe.table.device != qf.device:
        raise ValueError(f"tile table on {exe.table.device}, operands on "
                         f"{qf.device}")
    bh, sq, d = qf.shape
    out = torch.empty_like(qf)
    status = _lib().flash_fwd_fused(
        _build.ptr(qf), _build.ptr(kf), _build.ptr(vf), _build.ptr(out),
        _build.ptr(exe.table), _build.ptr(exe.q_index), s.num_q_blocks, bh,
        sq, s.sk, d, s.bq, s.bk, int(s.causal), d ** -0.5,
        _DTYPE_CODE[qf.dtype], _build.stream_ptr(qf))
    LAUNCHES["flash_fwd_fused"] += 1
    _build.check(status, "flash_fwd_fused")
    return out


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
    status = _lib().flash_fwd_dense(
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


def _scores(q, k, scale, qs, ks, k_lo, k_hi, causal):
    s = (q.float() @ k.float().transpose(1, 2)) * scale
    qpos = qs + torch.arange(q.shape[1], device=q.device)[:, None]
    kpos = ks + torch.arange(k.shape[1], device=q.device)[None, :]
    valid = (kpos >= k_lo) & (kpos < k_hi)
    if causal:
        valid = valid & (kpos <= qpos)
    return torch.where(valid, s, NEG_INF)


def flash_fwd_fused_plain(schedule: FlashTileSchedule, qf, kf, vf):
    """Walk the tile table with the m/l/acc carry, -1e30 masking and the
    drain into owned rows, as the fused kernel does."""
    if qf.is_cuda:
        disable_tf32()
    bh, _, d = qf.shape
    bq, bk, scale = schedule.bq, schedule.bk, d ** -0.5
    out = torch.empty_like(qf)
    carry = None
    for q0, q_end, qs, k0, k_end, ks, first, last in schedule.tiles:
        if first:
            carry = _Carry(bh, bq, d, qf.device)
        s = _scores(qf[:, qs:qs + bq], kf[:, ks:ks + bk], scale, qs, ks,
                    k0, k_end, schedule.causal)
        carry.update(s, vf[:, ks:ks + bk])
        if last:
            out[:, q0:q_end] = carry.drain(qf.dtype)[:, q0 - qs:q_end - qs]
    return out


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
