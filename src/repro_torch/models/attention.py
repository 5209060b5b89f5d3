"""Multi-head self-attention: GQA, RoPE, qk-norm, optional QKV bias and
logit softcap, with a dense ring-buffer KV cache for decode.

Heads stay flattened as (b, s, h, hd), with K/V repeated to the full head
count for GQA before attention, as in the reference.  Under the
``engine`` backend the causal full-sequence case (prefill, sq == sk) runs
the flash-attention kernel; everything else -- including the ``s == 1``
decode step against the cache -- is plain torch math (:func:`_attend`),
which the reference also computes outside any kernel.

Not ported (they raise): paged caches, cross-attention and sliding-window
attention.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.core.config import get_config
from repro_torch.core.machine import torch_dtype
from repro_torch.models.common import Init, Linear, RMSNorm
from repro_torch.models.rotary import apply_rope

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


def _repeat_kv(x, n_rep: int):
    return x if n_rep == 1 else torch.repeat_interleave(x, n_rep, dim=2)


def _attend(q, k, v, mask, softcap: Optional[float]):
    """q: (b, sq, h, hd); k/v: (b, sk, h, hd); mask broadcasts to
    (b, h, sq, sk).  Products in fp32 (bf16 operands are upcast, matching
    the reference's fp32 accumulation), softmax in fp32, probabilities
    rounded to V's dtype before the PV product."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(v.dtype)


def _causal_mask(q_pos, k_pos):
    m = (k_pos[None, :] <= q_pos[:, None]) & (k_pos >= 0)[None, :]
    return m[None, None]


def _attention_seq(q, k, v, positions, softcap):
    """Causal attention over a whole sequence (train / prefill)."""
    sq = q.shape[1]
    if (get_config().backend == "engine" and not softcap
            and sq == k.shape[1]):
        from repro_torch.kernels.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=True)
    # Query chunks keep the score tensor linear in sq.
    outs = [_attend(q[:, i:i + Q_CHUNK], k, v,
                    _causal_mask(positions[i:i + Q_CHUNK], positions), softcap)
            for i in range(0, sq, Q_CHUNK)]
    return torch.cat(outs, dim=1)


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

    def forward(self, x, positions, *, cache: Optional[KVCache] = None,
                window: Optional[int] = None):
        """Self-attention.  positions: (s,) or (b, s) absolute positions.
        Returns (y, cache); with a cache and s == 1 this is a decode step."""
        if window is not None:
            raise NotImplementedError("sliding-window attention is not ported")
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        b, s, _ = x.shape
        hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        g = hq // hkv
        pos2d = positions if positions.ndim == 2 else positions[None, :]

        q = self.wq(x, compute_dtype=dt).reshape(b, s, hq, hd)
        k = self.wk(x, compute_dtype=dt).reshape(b, s, hkv, hd)
        v = self.wv(x, compute_dtype=dt).reshape(b, s, hkv, hd)
        if cfg.qk_norm:
            q = self.q_norm(q, cfg.norm_eps)
            k = self.k_norm(k, cfg.norm_eps)
        if cfg.rope:
            q = apply_rope(q, pos2d, cfg.rope_theta)
            k = apply_rope(k, pos2d, cfg.rope_theta)

        if cache is not None:
            # Ring-buffer write at slot = pos % capacity, in place.
            cap = cache.k.shape[1]
            slots = (pos2d % cap).long()
            bidx = torch.arange(b, device=x.device)[:, None]
            cache.k[bidx, slots] = k.to(cache.k.dtype)
            cache.v[bidx, slots] = v.to(cache.v.dtype)
            cache.pos[bidx, slots] = pos2d.expand(b, s).to(cache.pos.dtype)
        if cache is not None and s == 1:
            kf = _repeat_kv(cache.k.to(dt), g)
            vf = _repeat_kv(cache.v.to(dt), g)
            qpos = pos2d[:, -1].reshape(-1, 1, 1, 1)
            cpos = cache.pos[:, None, None, :]
            mask = (cpos <= qpos) & (cpos >= 0)
            out = _attend(q, kf, vf, mask, cfg.attn_logit_softcap)
        else:
            if positions.ndim != 1:
                raise NotImplementedError("per-row positions need the paged "
                                          "serving runtime, not ported")
            out = _attention_seq(q, _repeat_kv(k, g), _repeat_kv(v, g),
                                 positions, cfg.attn_logit_softcap)
        y = self.wo(out.reshape(b, s, hq * hd), compute_dtype=dt)
        return y, cache
