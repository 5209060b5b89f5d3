"""Wrappers around the Hopper flash-attention kernels (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu`` and ``csrc/flash_decode.cu``), each beside its plain
torch version.

  * :func:`flash_fwd_fused` -- one launch walking a plan's causal-aware
    tile table, one thread block per (q-block, batch-head), optionally
    with the ``(BH, sq)`` fp32 log-sum-exp rows (the counterpart of the
    reference's ``build_fused_flash_kernel``, ``return_lse``);
  * :func:`flash_fwd_dense` -- one launch over the dense (q-block,
    batch-head) grid, skipping k-blocks past the causal diagonal (the
    counterpart of ``build_flash_kernel``);
  * :func:`flash_bwd_fused` -- one launch producing fp32 dQ, dK and dV
    over the same table, one thread block per (k-block, batch-head) (the
    counterpart of ``build_fused_flash_bwd_kernel``);
  * :func:`flash_decode` -- one paged decode step over a KV pool, walking
    each slot's rows of the runtime
    :class:`~repro_torch.core.schedule.DecodeTileSchedule` table (the
    counterpart of ``build_decode_flash_kernel``); with int8 pools and
    their per-token ``(pages, page_size)`` f32 scales it is the same
    kernel's KV-int8 branch (``kv_quant=True``), counted apart as
    ``flash_decode_int8``.  Each call adds one to the route it took in
    :data:`DECODE_ROUTES` (:func:`choose_decode_route`): "A" (bf16 q: a
    cluster of :func:`decode_cluster` blocks a (slot, KV head), each
    walking its :func:`decode_chunk` of the slot's rows with TMA page
    loads) or "B" (one block a (slot, KV head) walking all of them).

Operands are ``(BH, s, d)``, or for decode ``q (S, h, hd)`` against
``(pages, page_size, hkv, hd)`` pools.  A wrapper runs its plain version only for
CPU tensors; for CUDA tensors it launches the kernel or raises.  Each
launch adds one to :data:`LAUNCHES`, each forward launch one to the route
it took in :data:`ROUTES` and each backward launch one to its route in
:data:`BWD_ROUTES` (:func:`choose_route`): "A" (bf16 operands TMA can
read: windows fed by TMA on mbarriers into a ring, every tile product on
``wgmma``), "C" (bf16 operands TMA cannot read) or "fp32" (both CUDA-core
FMAs, never TF32).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.machine import H100_SXM
from repro_torch.core.schedule import (DecodeTileSchedule, FlashTileSchedule,
                                       ceil_div, pack_table)
from repro_torch.kernels import _build, disable_tf32
from repro_torch.kernels.gemm.kernel import sm_count

NEG_INF = -1e30

# Limits of flash_fwd.cu and flash_bwd.cu (their BQ_MAX = BK_MAX and
# D_MAX): block edges up to 64 rows, head dim up to 128.
# tests/test_torch_kernel_sources.py holds the .cu files and
# H100_SXM.flash_blocks to these.
MAX_BLOCK = 64
MAX_HEAD_DIM = 128

LAUNCHES = {"flash_fwd_fused": 0, "flash_fwd_dense": 0, "flash_bwd_fused": 0,
            "flash_decode": 0, "flash_decode_int8": 0}
ROUTES = {"A": 0, "C": 0, "fp32": 0}
BWD_ROUTES = {"A": 0, "C": 0, "fp32": 0}
DECODE_ROUTES = {"A": 0, "B": 0}
# flash_decode.cu's ROUTE_A / ROUTE_B, and its MAX_CLUSTER (the portable
# thread-block cluster size).
_DECODE_ROUTE_CODE = {"A": 0, "B": 1}
DECODE_MAX_CLUSTER = 8
# flash_fwd.cu's and flash_bwd.cu's ROUTE_A / ROUTE_C; fp32 ignores the code.
_ROUTE_CODE = {"A": 0, "C": 1, "fp32": 1}

# Route A's K/V ring (flash_fwd.cu's STAGES) and its block's dynamic shared
# memory (TC_SMEM): 1024 bytes of alignment slack, Q (MAX_HEAD_DIM / 32
# TMA boxes of 64 rows x 64 bytes), RING_STAGES stages of K and V, two
# 64 x 64 bf16 P buffers, and 8-byte mbarriers (Q, and a full and an empty
# one a stage).  tests/test_torch_kernel_sources.py holds the .cu to these.
RING_STAGES = 2
_Q_BYTES = MAX_HEAD_DIM // 32 * 64 * 64
RING_SMEM_BYTES = (1024 + _Q_BYTES + RING_STAGES * 2 * _Q_BYTES
                   + 2 * MAX_BLOCK * MAX_BLOCK * 2 + 8 * (1 + 2 * RING_STAGES))
# The backward's route A at the largest head dim (flash_bwd.cu's STAGES and
# TC_SMEM): 1024 bytes of slack, the K and V windows, BWD_RING_STAGES stages
# of Q, dO and O, the P and dS hi / lo panel pairs (four 64 x 64 bf16
# tiles), the LSE and D of a tile's q rows, and 8-byte mbarriers (K/V, and a
# full and an empty one a stage): one block an SM.
BWD_RING_STAGES = 2
BWD_RING_SMEM_BYTES = (1024 + 2 * _Q_BYTES + BWD_RING_STAGES * 3 * _Q_BYTES
                       + 4 * MAX_BLOCK * MAX_BLOCK * 2 + 2 * MAX_BLOCK * 4
                       + 8 * (1 + 2 * BWD_RING_STAGES))

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def choose_route(dtype, d: int, ptrs=(0, 0, 0)) -> str:
    """The route of one flash forward or backward call: "fp32" for fp32
    operands; for bf16 "C" where TMA cannot read an operand (one of the
    bases ``ptrs`` -- q, k and v, and for the backward also o and dO -- not
    16-byte aligned, or a row of ``2 d`` bytes that is not a multiple of
    16), else "A"."""
    if dtype == torch.float32:
        return "fp32"
    if any(p % 16 for p in ptrs) or (2 * d) % 16:
        return "C"
    return "A"


def _route(qf, *operands) -> str:
    return choose_route(qf.dtype, qf.shape[2],
                        tuple(t.data_ptr() for t in (qf, *operands)))


def choose_decode_route(q_dtype, pool_dtype, group: int, page_size: int,
                        head_dim: int, ptrs=()) -> str:
    """The route of one :func:`flash_decode` call: "A" for bf16 q over bf16
    or int8 pools within ``H100_SXM``'s route-A limits -- a GQA group of at
    most ``decode_a_max_group``, pages of at most ``decode_a_max_page``
    rows and a multiple of 4 (the int8 scales' 16-byte bulk copies), a head
    dim in ``decode_a_head_dims`` (so every row stride of the pools' tensor
    maps, a multiple of ``head_dim`` bytes, is a multiple of 16) -- with
    every base in ``ptrs`` 16-byte aligned; else "B"."""
    m = H100_SXM
    if (q_dtype == torch.bfloat16
            and pool_dtype in (torch.bfloat16, torch.int8)
            and group <= m.decode_a_max_group
            and page_size <= m.decode_a_max_page and page_size % 4 == 0
            and head_dim in m.decode_a_head_dims
            and not any(p % 16 for p in ptrs)):
        return "A"
    return "B"


def decode_cluster(num_seqs: int, num_kv_heads: int, max_blocks: int,
                   sms: int) -> int:
    """Blocks of one (slot, KV head) on route A, a thread-block cluster:
    enough to bring the ``num_seqs * num_kv_heads`` (slot, KV head) pairs
    up to the card's ``sms``, at most :data:`DECODE_MAX_CLUSTER` and at
    most ``max_blocks`` (a slot walks at most that many rows)."""
    return max(1, min(DECODE_MAX_CLUSTER, max_blocks,
                      sms // (num_seqs * num_kv_heads)))


def decode_chunk(start: int, end: int, clusters: int, rank: int):
    """Rows ``[lo, hi)`` of a slot's ``[start, end)`` that rank ``rank``
    of a ``clusters``-block cluster walks on route A (flash_decode.cu's
    rule): contiguous, in rank order, sizes differing by at most one; a
    rank may get none."""
    n = end - start
    return start + rank * n // clusters, start + (rank + 1) * n // clusters


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


class FlashDecode:
    """One pool geometry's decode state: the schedule, and on the device
    the ``(max_tiles, 5)`` tile table and the ``(num_seqs + 1,)`` row
    offsets, rewritten in place by :meth:`update` each step (device ops,
    no host sync), so one cached state serves every batch composition."""

    def __init__(self, schedule: DecodeTileSchedule, device):
        self.schedule = schedule
        self.device = torch.device(device)
        self.table = torch.zeros((schedule.max_tiles, 5), dtype=torch.int32,
                                 device=self.device)
        self.bstart = torch.zeros((schedule.num_seqs + 1,), dtype=torch.int32,
                                  device=self.device)
        self._stamp = self._inputs = None

    def update(self, block_tables, lengths) -> None:
        """Rebuild the table from this step's block tables and lengths.
        The same two tensors, unchanged since the last call, keep the
        table as it is: every layer of a decode step passes the step's
        shared ones, so the table is built once per step."""
        stamp = (id(block_tables), block_tables._version, id(lengths),
                 lengths._version)
        if stamp == self._stamp:
            return
        table, bstart = self.schedule.tables_and_offsets(block_tables,
                                                         lengths)
        self.table.copy_(table)
        self.bstart.copy_(bstart)
        # Held so that no other tensor can take their ids.
        self._stamp, self._inputs = stamp, (block_tables, lengths)


_LIBS = {}


def _lib(name: str):
    """The built library ``flash_fwd`` or ``flash_bwd``, with its C
    signatures declared (once)."""
    if name not in _LIBS:
        lib = _build.library(name)
        P, I, Fl = _build.P, _build.I, _build.F
        if name == "flash_fwd":
            lib.flash_fwd_fused.argtypes = [P] * 7 + [I] * 8 + [Fl, I, I, P]
            lib.flash_fwd_fused.restype = I
            lib.flash_fwd_dense.argtypes = [P] * 4 + [I] * 7 + [Fl, I, I, P]
            lib.flash_fwd_dense.restype = I
        elif name == "flash_bwd":
            lib.flash_bwd_fused.argtypes = [P] * 12 + [I] * 8 + [Fl, I, I, P]
            lib.flash_bwd_fused.restype = I
        else:
            lib.flash_decode.argtypes = [P] * 8 + [I] * 8 + [Fl, I, I, P]
            lib.flash_decode.restype = I
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
    route = _route(qf, kf, vf)
    status = _lib("flash_fwd").flash_fwd_fused(
        _build.ptr(qf), _build.ptr(kf), _build.ptr(vf), _build.ptr(out),
        _build.ptr(lse), _build.ptr(exe.table), _build.ptr(exe.q_index),
        s.num_q_blocks, bh, sq, s.sk, d, s.bq, s.bk, int(s.causal),
        d ** -0.5, _DTYPE_CODE[qf.dtype], _ROUTE_CODE[route],
        _build.stream_ptr(qf))
    LAUNCHES["flash_fwd_fused"] += 1
    ROUTES[route] += 1
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
    route = _route(qf, kf, vf, o, do)
    status = _lib("flash_bwd").flash_bwd_fused(
        _build.ptr(qf), _build.ptr(kf), _build.ptr(vf), _build.ptr(o),
        _build.ptr(do), _build.ptr(lse), _build.ptr(dq), _build.ptr(dk),
        _build.ptr(dv), _build.ptr(exe.table), _build.ptr(exe.k_offsets),
        _build.ptr(exe.k_rows), s.num_k_blocks, bh, sq, s.sk, d, s.bq, s.bk,
        int(s.causal), d ** -0.5, _DTYPE_CODE[qf.dtype], _ROUTE_CODE[route],
        _build.stream_ptr(qf))
    LAUNCHES["flash_bwd_fused"] += 1
    BWD_ROUTES[route] += 1
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
    route = _route(qf, kf, vf)
    status = _lib("flash_fwd").flash_fwd_dense(
        _build.ptr(qf), _build.ptr(kf), _build.ptr(vf), _build.ptr(out), bh,
        sq, sk, d, bq, bk, int(causal), d ** -0.5, _DTYPE_CODE[qf.dtype],
        _ROUTE_CODE[route], _build.stream_ptr(qf))
    LAUNCHES["flash_fwd_dense"] += 1
    ROUTES[route] += 1
    _build.check(status, "flash_fwd_dense")
    return out


def _check_decode(exe: FlashDecode, q, k_pool, v_pool, k_scale=None,
                  v_scale=None):
    sch = exe.schedule
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("k_scale and v_scale come together")
    if quant:
        want = tuple(k_pool.shape[:2])
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(t.shape) != want or t.dtype != torch.float32:
                raise ValueError(f"{name} must be {want} float32, got "
                                 f"{tuple(t.shape)} {t.dtype}")
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise ValueError(f"scaled pools must be int8, got "
                             f"{k_pool.dtype}, {v_pool.dtype}")
    if q.ndim != 3 or k_pool.ndim != 4 or k_pool.shape != v_pool.shape \
            or q.shape[2] != k_pool.shape[3] \
            or q.shape[1] % k_pool.shape[2]:
        raise ValueError(f"expected q (S,h,hd), pools (pages,P,hkv,hd) with "
                         f"hkv dividing h, got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    if (q.shape[0], k_pool.shape[0], k_pool.shape[1]) != \
            (sch.num_seqs, sch.pages, sch.page_size):
        raise ValueError(f"schedule is for {sch}, operands are q "
                         f"{tuple(q.shape)}, pool {tuple(k_pool.shape)}")
    if q.is_cuda:
        for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                        ("table", exe.table), ("k_scale", k_scale),
                        ("v_scale", v_scale)):
            if t is not None and (t.device != q.device
                                  or not t.is_contiguous()):
                raise ValueError(f"{name} must be contiguous on {q.device}")
        if q.dtype not in _DTYPE_CODE or not (
                quant or q.dtype == k_pool.dtype == v_pool.dtype):
            raise ValueError(f"the CUDA decode kernel takes float32 or "
                             f"bfloat16 q and pools of q's dtype (or int8 "
                             f"pools with scales), got {q.dtype}, "
                             f"{k_pool.dtype}, {v_pool.dtype}")
        # Page size, head dim and GQA group: plan_flash_decode holds them
        # to H100_SXM.decode_max_*, and the .cu entry refuses the rest.
    elif q.device.type != "cpu":
        raise RuntimeError(f"no decode kernel for device {q.device}")


def flash_decode(exe: FlashDecode, q, k_pool, v_pool, k_scale=None,
                 v_scale=None) -> torch.Tensor:
    """One launch over the tile table ``exe`` holds (:meth:`FlashDecode.
    update`) -> ``(S, h, hd)`` in q's dtype; an empty slot's row is 0.
    With ``k_scale``/``v_scale`` (``(pages, page_size)`` f32) the pools
    are int8 and the launch is the KV-int8 branch."""
    _check_decode(exe, q, k_pool, v_pool, k_scale, v_scale)
    if not q.is_cuda:
        return flash_decode_plain(exe, q, k_pool, v_pool, k_scale, v_scale)
    S, h, hd = q.shape
    pages, P, hkv = k_pool.shape[:3]
    max_blocks = exe.schedule.max_blocks
    out = torch.empty_like(q)
    route = choose_decode_route(
        q.dtype, k_pool.dtype, h // hkv, P, hd,
        tuple(t.data_ptr() for t in (q, k_pool, v_pool, out, k_scale,
                                     v_scale) if t is not None))
    clusters = decode_cluster(S, hkv, max_blocks, sm_count(q.device)) \
        if route == "A" else 1
    status = _lib("flash_decode").flash_decode(
        _build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool),
        _build.ptr(out), _build.ptr(exe.table), _build.ptr(exe.bstart),
        _build.ptr(k_scale), _build.ptr(v_scale), S, h, hkv, hd, P, pages,
        max_blocks, clusters, hd ** -0.5, _DTYPE_CODE[q.dtype],
        _DECODE_ROUTE_CODE[route], _build.stream_ptr(q))
    name = "flash_decode" if k_scale is None else "flash_decode_int8"
    LAUNCHES[name] += 1
    DECODE_ROUTES[route] += 1
    _build.check(status, name)
    return out


# ---------------------------------------------------------------------------
# Plain torch versions (the CPU path, and the card-side comparison).  The
# prefill ones run every batch-head at once and walk tiles in the kernels'
# order; the decode one walks the decode table row by row.
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


def flash_decode_plain(exe: FlashDecode, q, k_pool, v_pool, k_scale=None,
                       v_scale=None) -> torch.Tensor:
    """Walk the decode table's live rows (``[0, bstart[-1])``) as the kernel
    does, all heads of a row at once: K/V of dead page slots selected to
    0, their scores to -1e30, a per-head m/l/acc carry reset at ``first``
    and drained at ``last`` through ``acc / max(l, 1e-30)``, P rounded to
    q's dtype before the PV product.  With int8 pools the K scales
    multiply the score columns and the V scales fold into P before it is
    rounded (both selected to 0 on dead slots)."""
    if q.is_cuda:
        disable_tf32()
    S, h, hd = q.shape
    P, hkv = k_pool.shape[1], k_pool.shape[2]
    rep, scale = h // hkv, hd ** -0.5
    qg = q.float().reshape(S, hkv, rep, hd)
    out = torch.zeros_like(q)
    cols = torch.arange(P, device=q.device)
    rows = exe.table[:int(exe.bstart[-1])].tolist()
    m = l = acc = None
    for seq, page, k_len, first, last in rows:
        if first:
            m = torch.full((hkv, rep, 1), NEG_INF, device=q.device)
            l = torch.zeros((hkv, rep, 1), device=q.device)
            acc = torch.zeros((hkv, rep, hd), device=q.device)
        live = (cols < k_len)[:, None, None]
        k = torch.where(live, k_pool[page].float(), 0.0)  # (P, hkv, hd)
        v = torch.where(live, v_pool[page].float(), 0.0)
        s = torch.einsum("grd,pgd->grp", qg[seq], k) * scale
        if k_scale is not None:
            s = s * torch.where(cols < k_len, k_scale[page], 0.0)
        s = torch.where(cols < k_len, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if v_scale is not None:
            p = p * torch.where(cols < k_len, v_scale[page], 0.0)
        acc = acc * alpha + torch.einsum("grp,pgd->grd",
                                         p.to(q.dtype).float(), v)
        m = m_new
        if last:
            out[seq] = (acc / torch.clamp_min(l, 1e-30)).reshape(h, hd) \
                .to(q.dtype)
    return out


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES, BWD_ROUTES, DECODE_ROUTES):
        for name in counts:
            counts[name] = 0
