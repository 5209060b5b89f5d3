"""Multi-head self-attention: GQA, RoPE, qk-norm, optional QKV bias and
logit softcap, with a dense ring-buffer KV cache for the static decode
path and a paged KV pool for continuous batching.

Heads stay flattened as (b, s, h, hd), with K/V repeated to the full head
count for GQA before attention, as in the reference.  Under the
``engine`` backend the causal full-sequence case (prefill, sq == sk) runs
the flash-attention kernel and a decode step against a paged pool runs
the paged decode kernel (``flash_decode``); the ``s == 1`` decode step
against the dense cache is plain torch math (:func:`_attend`), which the
reference also computes outside any kernel.

``PageSpec(kv_quant="int8")`` stores the paged pools in int8 with a
per-token f32 scale (the row's absmax over heads x features / 127):
half the KV bytes of bf16.  A decode step quantizes the new token's K and
V as it writes them; the engine's decode kernel folds the scales into its
score and PV algebra, and the gather path dequantizes in f32 first.

Sliding-window ("local") attention takes ``window``: keys more than
``window - 1`` positions behind a query are masked.  It stays off the flash
kernels, as in the reference: past ``Q_CHUNK`` queries each 512-query chunk
attends a ``window + Q_CHUNK`` slice of a copy of K/V padded by
``window``; its decode cache is a dense ring of ``min(capacity, window)``
rows.  With gradients on, every query chunk of the chunked path runs under
a non-reentrant ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of its scan body), so the backward never holds every
chunk's fp32 scores at once.

Cross-attention (``kv_override``, the reference's) takes K and V from
another sequence -- the encoder's output, or in the encoder the sequence
itself -- with every key visible: under the ``engine`` backend the
non-causal flash kernel (``sq`` and ``sk`` may differ; a decode step's
``sq`` is 1), under ``torch`` :func:`_attend` with an all-true mask.  RoPE
turns only q; no cache is read or written.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.core.config import get_config
from repro_torch.core.machine import torch_dtype
from repro_torch.models.common import Init, Linear, RMSNorm, checkpointed
from repro_torch.models.rotary import apply_rope
from repro_torch.runtime.shardlib import (axis_size, current_mesh,
                                          shard_activation)

Q_CHUNK = 512

NEG_INF = -1e30


@dataclasses.dataclass
class KVCache:
    """Dense per-slot ring buffer; updated in place by each step (the port
    writes new K/V into the existing buffers instead of copying them)."""

    k: torch.Tensor    # (b, S, h_kv, hd)
    v: torch.Tensor    # (b, S, h_kv, hd)
    pos: torch.Tensor  # (b, S) absolute position of each slot, -1 = empty


def init_kv_cache(batch, capacity, n_kv, head_dim, dtype, device) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, capacity, n_kv, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, capacity, n_kv, head_dim), dtype=dtype,
                      device=device),
        pos=torch.full((batch, capacity), -1, dtype=torch.int32,
                       device=device))


class PageSpec(NamedTuple):
    """Static paged-cache geometry (the serving runtime's pool shape).
    ``max_blocks * page_size`` caps the context one block table can map.
    ``kv_quant="int8"`` stores the pools in int8 with per-token f32
    dequant scales."""

    num_pages: int
    page_size: int
    max_blocks: int
    kv_quant: Optional[str] = None


@dataclasses.dataclass
class PagedKVCache:
    """Paged KV pool plus per-slot block tables (continuous batching).

    Pool pages are allocated to sequences by the host-side free list
    (``repro_torch.runtime.pages.PagePool``) and mapped by ``tables``:
    position ``p`` of slot ``i`` lives at ``(tables[i, p // P], p % P)``.
    Decode steps write the new token's K/V into the pools in place, and
    the runtime rewrites ``tables`` in place after the allocator moved
    pages."""

    k: torch.Tensor       # (num_pages, page_size, h_kv, hd)
    v: torch.Tensor       # (num_pages, page_size, h_kv, hd)
    tables: torch.Tensor  # (num_slots, max_blocks) int32 page ids
    # int8 pools only: per-token f32 dequant scales, (num_pages, page_size)
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def init_paged_kv_cache(num_slots, spec: PageSpec, n_kv, head_dim, dtype,
                        device) -> PagedKVCache:
    if spec.kv_quant not in (None, "int8"):
        raise ValueError(f"kv_quant must be None or 'int8', got "
                         f"{spec.kv_quant!r}")
    quant = spec.kv_quant == "int8"
    shape = (spec.num_pages, spec.page_size, n_kv, head_dim)
    pool_dtype = torch.int8 if quant else dtype

    def scales():
        return torch.zeros((spec.num_pages, spec.page_size),
                           dtype=torch.float32, device=device) \
            if quant else None

    return PagedKVCache(
        k=torch.zeros(shape, dtype=pool_dtype, device=device),
        v=torch.zeros(shape, dtype=pool_dtype, device=device),
        tables=torch.zeros((num_slots, spec.max_blocks), dtype=torch.int32,
                           device=device),
        k_scale=scales(), v_scale=scales())


def quantize_kv_rows(rows: torch.Tensor):
    """Symmetric per-token int8 quantization of KV rows ``(..., hkv, hd)``:
    each row's scale is its absmax over heads x features / 127 + 1e-12,
    the values rounded half to even and clipped to +-127.  Returns (int8
    values, f32 scales of shape ``rows.shape[:-2]``)."""
    r32 = rows.float()
    s = r32.abs().amax(dim=(-2, -1)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(r32 / s[..., None, None]), -127, 127)
    return q.to(torch.int8), s


def _repeat_kv(x, n_rep: int):
    return x if n_rep == 1 else torch.repeat_interleave(x, n_rep, dim=2)


def _model_axis() -> int:
    mesh = current_mesh()
    return axis_size(mesh, "model") if mesh is not None else 1


def _head_axes(n_heads: int):
    """The reference's sharding specs of (b, s|q, h, hd) and (b, h, q, k)
    tensors: heads on "model" when they divide it, else the query dim
    (the context-parallel fallback)."""
    msize = _model_axis()
    if msize <= 1 or n_heads % msize == 0:
        return (("pod", "data"), None, "model", None), \
               (("pod", "data"), "model", None, None)
    return (("pod", "data"), "model", None, None), \
           (("pod", "data"), None, "model", None)


def _attend(q, k, v, mask, softcap: Optional[float], *,
            kv_seq_sharded: bool = False):
    """q: (b, sq, h, hd); k/v: (b, sk, h, hd); mask broadcasts to
    (b, h, sq, sk).  Products in fp32 (bf16 operands are upcast, matching
    the reference's fp32 accumulation), softmax in fp32, probabilities
    rounded to V's dtype before the PV product.  ``kv_seq_sharded``: the
    reference's split-K decode against a sequence-sharded cache."""
    if kv_seq_sharded:
        qspec = (("pod", "data"), None, None, None)
        sspec = (("pod", "data"), None, None, "model")
    else:
        qspec, sspec = _head_axes(q.shape[2])
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    scores = torch.where(mask, scores, NEG_INF)
    scores = shard_activation(scores, sspec)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return shard_activation(out.to(v.dtype), qspec)


def _causal_mask(q_pos, k_pos, window: Optional[int] = None):
    m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    m &= (k_pos >= 0)[None, :]
    return m[None, None]


def _chunk(body, *args):
    """``body(*args)``, under a non-reentrant checkpoint when gradients are
    on (the reference checkpoints its chunk scan's body whatever
    ``cfg.remat`` says)."""
    return checkpointed(body, *args) if torch.is_grad_enabled() \
        else body(*args)


def _attention_seq(q, k, v, positions, window, softcap):
    """Causal attention over a whole sequence (train / prefill), optionally
    windowed; the score tensor stays linear in sq."""
    sq = q.shape[1]
    if (get_config().backend == "engine" and window is None and not softcap
            and sq == k.shape[1]):
        from repro_torch.kernels.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=True)
    if sq <= Q_CHUNK:
        return _attend(q, k, v, _causal_mask(positions, positions, window),
                       softcap)
    # Query chunks of Q_CHUNK (the last one may be shorter).
    if window is not None and k.shape[1] > window + Q_CHUNK:
        # Sliding window: each chunk attends a window + Q_CHUNK KV slice of
        # a copy padded by ``window`` rows at position -1.
        pad = (0, 0, 0, 0, window, 0)
        k_pad = torch.nn.functional.pad(k, pad)
        v_pad = torch.nn.functional.pad(v, pad)
        kp_pad = torch.cat([positions.new_full((window,), -1), positions])

        def body(qc, qpc, ks, vs, kps):
            return _attend(qc, ks, vs, _causal_mask(qpc, kps, window), softcap)

        span = window + Q_CHUNK
        outs = [_chunk(body, q[:, i:i + Q_CHUNK], positions[i:i + Q_CHUNK],
                       k_pad[:, i:i + span], v_pad[:, i:i + span],
                       kp_pad[i:i + span])
                for i in range(0, sq, Q_CHUNK)]
    else:
        def body(qc, qpc):
            return _attend(qc, k, v, _causal_mask(qpc, positions, window),
                           softcap)

        outs = [_chunk(body, q[:, i:i + Q_CHUNK], positions[i:i + Q_CHUNK])
                for i in range(0, sq, Q_CHUNK)]
    return torch.cat(outs, dim=1)


def _cross_attend(q, k, v, softcap):
    """Every key visible to every query (cross-attention, the encoder's
    bidirectional self-attention): the non-causal flash kernel under the
    ``engine`` backend without a softcap, else :func:`_attend` with an
    all-true mask."""
    if get_config().backend == "engine" and not softcap:
        from repro_torch.kernels.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=False)
    mask = torch.ones((1, 1, q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    return _attend(q, k, v, mask, softcap)


def _ring_write(cache: KVCache, k, v, pos2d) -> None:
    """Dense-cache write at slot = pos % capacity, in place.  Only each
    row's last ``capacity`` positions are written (a longer prefill would
    map several positions to one slot, and duplicate indices leave the
    winner undefined on CUDA), and a row at a negative position (an
    inactive continuous-batching slot) writes nothing: it puts back what
    its slot held."""
    b, s = k.shape[:2]
    cap = cache.k.shape[1]
    if s > cap:
        k, v, pos2d, s = k[:, -cap:], v[:, -cap:], pos2d[:, -cap:], cap
    pos = pos2d.expand(b, s)
    slots = (pos % cap).long()
    bidx = torch.arange(b, device=k.device)[:, None]
    keep = pos >= 0
    rows = keep[..., None, None]
    cache.k[bidx, slots] = torch.where(rows, k.to(cache.k.dtype),
                                       cache.k[bidx, slots])
    cache.v[bidx, slots] = torch.where(rows, v.to(cache.v.dtype),
                                       cache.v[bidx, slots])
    cache.pos[bidx, slots] = torch.where(keep, pos.to(cache.pos.dtype),
                                         cache.pos[bidx, slots])


class PagedStep(NamedTuple):
    """One decode step's per-slot state, the same for every layer (the
    layers share one block-table tensor): built once per step by
    :func:`paged_step`."""

    active: torch.Tensor   # (S,) bool
    pid: torch.Tensor      # (S,) page the slot's new K/V goes to
    off: torch.Tensor      # (S,) row in that page
    first: torch.Tensor    # () the first active row (0 if none)
    lengths: torch.Tensor  # (S,) live KV length after the write, 0 inactive


def paged_step(cache: PagedKVCache, positions) -> PagedStep:
    """The step's write targets and lengths from a layer's block tables
    and the ``(S, 1)`` per-slot positions (the slot's current length; -1 =
    inactive; one shared position broadcasts).  An inactive row targets
    the first active row's slot (:func:`_write_token`)."""
    S, P = cache.tables.shape[0], cache.k.shape[1]
    pos = positions.reshape(-1)
    pos = (pos if pos.shape[0] == S else pos.expand(S)).long()
    active = pos >= 0
    safe = torch.clamp_min(pos, 0)
    blk = cache.tables.long().gather(1, (safe // P)[:, None])[:, 0]
    off = safe % P
    first = torch.argmax(active.int())
    return PagedStep(active=active,
                     pid=torch.where(active, blk, blk[first]),
                     off=torch.where(active, off, off[first]), first=first,
                     lengths=torch.where(active, pos + 1, 0))


def _write_token(pool, new, step: PagedStep):
    """``pool[pid[i], off[i]] = new[i]`` for the active rows, in place and
    without a host sync.  Torch has no dropped-write mode, so an inactive
    row writes what leaves the pool as the active rows alone would: the
    first active row's value at that row's target (``pid``/``off`` already
    point there), or, when no row is active, the value already at its
    target."""
    active, first = step.active, step.first
    new = new.to(pool.dtype)
    cur = pool[step.pid, step.off]
    sel = active.reshape(-1, *([1] * (new.ndim - 1)))
    val = torch.where(sel, new, torch.where(active[first], new[first], cur))
    pool[step.pid, step.off] = val


def _paged_decode(cfg, cache: PagedKVCache, q, k, v, step: PagedStep, dt, g):
    """One decode step against the paged KV pool.

    q/k/v: (S, 1, h|hkv, hd).  The new token's K/V is written in place at
    ``(tables[i, pos // P], pos % P)`` (int8 pools: quantized per token,
    its scales written beside it); inactive rows leave the pools and
    scales unchanged (:func:`_write_token`) and their output rows are
    garbage the scheduler ignores.  Attention runs through the engine's
    ``flash_decode`` family (``engine`` backend: ONE launch over the
    runtime decode table, built once per step) or the gather formulation
    (``ref_paged_decode_attention``'s math through :func:`_attend`)."""
    S = q.shape[0]
    pages, P, hkv, hd = cache.k.shape
    B = cache.tables.shape[1]
    quant = cache.k_scale is not None
    if quant:
        kq, ks = quantize_kv_rows(k[:, 0])
        vq, vs = quantize_kv_rows(v[:, 0])
        for pool, new in ((cache.k, kq), (cache.v, vq), (cache.k_scale, ks),
                          (cache.v_scale, vs)):
            _write_token(pool, new, step)
    else:
        _write_token(cache.k, k[:, 0], step)
        _write_token(cache.v, v[:, 0], step)
    lengths = step.lengths

    if get_config().backend == "engine" and not cfg.attn_logit_softcap:
        from repro_torch.kernels.flash_attention import paged_decode_attention
        return paged_decode_attention(q[:, 0], cache.k, cache.v, cache.tables,
                                      lengths, k_scale=cache.k_scale,
                                      v_scale=cache.v_scale)[:, None]
    # Gather the block-table pages into a contiguous view (gathered column
    # j holds absolute position j) and mask j >= length; int8 pools are
    # dequantized in f32 first.
    gidx = torch.clamp(cache.tables.long(), 0, pages - 1)
    gk, gv = cache.k[gidx], cache.v[gidx]  # (S, B, P, hkv, hd)
    if quant:
        gk = gk.float() * cache.k_scale[gidx][..., None, None]
        gv = gv.float() * cache.v_scale[gidx][..., None, None]
    gk = _repeat_kv(gk.reshape(S, B * P, hkv, hd).to(dt), g)
    gv = _repeat_kv(gv.reshape(S, B * P, hkv, hd).to(dt), g)
    live = torch.arange(B * P, device=q.device)[None, :] < lengths[:, None]
    return _attend(q, gk, gv, live[:, None, None, :], cfg.attn_logit_softcap)


class Attention(nn.Module):
    def __init__(self, cfg, init: Init):
        super().__init__()
        d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        self.cfg = cfg
        self.wq = Linear(d, hq * hd, init, bias=cfg.qkv_bias)
        self.wk = Linear(d, hkv * hd, init, bias=cfg.qkv_bias)
        self.wv = Linear(d, hkv * hd, init, bias=cfg.qkv_bias)
        self.wo = Linear(hq * hd, d, init)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, init)
            self.k_norm = RMSNorm(hd, init)

    def forward(self, x, positions, *, cache=None,
                window: Optional[int] = None,
                step: Optional[PagedStep] = None, kv_override=None):
        """Self-attention, sliding-window with ``window``, or with
        ``kv_override`` (b, sk, d) cross-attention into it.  positions:
        (s,) or (b, s) absolute positions; with a :class:`PagedKVCache`,
        (S, 1) per-slot positions (-1 marks an inactive slot) and the
        step's :class:`PagedStep` (built here when not given).  Returns
        (y, cache); with a cache and s == 1 this is a decode step."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        b, s, _ = x.shape
        hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        g = hq // hkv
        pos2d = positions if positions.ndim == 2 else positions[None, :]

        kv_src = x if kv_override is None else kv_override
        sk = kv_src.shape[1]
        q = self.wq(x, compute_dtype=dt).reshape(b, s, hq, hd)
        k = self.wk(kv_src, compute_dtype=dt).reshape(b, sk, hkv, hd)
        v = self.wv(kv_src, compute_dtype=dt).reshape(b, sk, hkv, hd)
        if cfg.qk_norm:
            q = self.q_norm(q, cfg.norm_eps)
            k = self.k_norm(k, cfg.norm_eps)
        if cfg.rope:
            q = apply_rope(q, pos2d, cfg.rope_theta)
            if kv_override is None:
                k = apply_rope(k, pos2d, cfg.rope_theta)
        q = shard_activation(q, _head_axes(hq)[0])

        if kv_override is not None:
            out = _cross_attend(q, _repeat_kv(k, g), _repeat_kv(v, g),
                                cfg.attn_logit_softcap)
        elif isinstance(cache, PagedKVCache):
            if s != 1:
                raise ValueError("a paged cache takes one decode token per "
                                 f"slot, got {s}")
            out = _paged_decode(cfg, cache, q, k, v,
                                paged_step(cache, pos2d) if step is None
                                else step, dt, g)
        elif cache is not None and s == 1:
            _ring_write(cache, k, v, pos2d)
            msize = _model_axis()
            seq_sharded = msize > 1 and hkv % msize != 0 \
                and cache.k.shape[1] % msize == 0
            kf = _repeat_kv(cache.k.to(dt), g)
            vf = _repeat_kv(cache.v.to(dt), g)
            if seq_sharded:
                kv_spec = (("pod", "data"), "model", None, None)
                kf = shard_activation(kf, kv_spec)
                vf = shard_activation(vf, kv_spec)
            qpos = pos2d[:, -1].reshape(-1, 1, 1, 1)
            cpos = cache.pos[:, None, None, :]
            mask = cpos <= qpos
            if window is not None:
                mask &= cpos > qpos - window
            mask &= cpos >= 0
            out = _attend(q, kf, vf, mask, cfg.attn_logit_softcap,
                          kv_seq_sharded=seq_sharded)
        else:
            if cache is not None:
                _ring_write(cache, k, v, pos2d)
            if positions.ndim != 1:
                raise NotImplementedError("per-row positions need a paged "
                                          "KV cache")
            out = _attention_seq(q, _repeat_kv(k, g), _repeat_kv(v, g),
                                 positions, window, cfg.attn_logit_softcap)
        y = self.wo(out.reshape(b, s, hq * hd), compute_dtype=dt)
        return y, cache
