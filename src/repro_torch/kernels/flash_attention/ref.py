"""Oracles for the flash-attention family: plain softmax attention, and
paged decode over a KV pool."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def ref_paged_decode_attention(q, k_pool, v_pool, block_tables,
                               lengths) -> torch.Tensor:
    """Oracle for the paged decode kernel.

    q: (S, h, hd); k_pool/v_pool: (pages, P, hkv, hd); block_tables:
    (S, max_blocks) int32; lengths: (S,) -> (S, h, hd).  Gathers each
    slot's block-table pages into a contiguous KV view (gathered column
    ``j`` holds absolute position ``j``), masks ``j >= length`` and runs
    plain fp32 softmax attention.  A zero-length slot returns zeros."""
    s, h, hd = q.shape
    pages, p, hkv, _ = k_pool.shape
    b = block_tables.shape[1]
    idx = torch.clamp(block_tables.long(), 0, pages - 1)
    gk = k_pool[idx].reshape(s, b * p, hkv, hd).to(q.dtype)
    gv = v_pool[idx].reshape(s, b * p, hkv, hd).to(q.dtype)
    if h != hkv:
        gk = torch.repeat_interleave(gk, h // hkv, dim=2)
        gv = torch.repeat_interleave(gv, h // hkv, dim=2)
    scale = hd ** -0.5
    scores = torch.einsum("shd,skhd->shk", q.float(), gk.float()) * scale
    live = torch.arange(b * p, device=q.device)[None, :] \
        < lengths.to(q.device)[:, None]                       # (S, B*P)
    scores = torch.where(live[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(live[:, None, :], probs, 0.0)  # len-0 slots: exact 0
    out = torch.einsum("shk,skhd->shd", probs.to(gv.dtype).float(),
                       gv.float())
    return out.to(q.dtype)


def ref_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q/k/v: (b, s, h, d) -> (b, s, h, d), fp32 softmax.  The causal mask
    is end-aligned (``tril(k=sk-sq)``), like the reference's oracle."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def ref_flat(causal: bool, qf, kf, vf) -> torch.Tensor:
    """Reference over flattened (BH, s, d) operands with the kernels'
    start-aligned causal diagonal (``kpos <= qpos``)."""
    scale = qf.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", qf.float(), kf.float()) * scale
    if causal:
        sq, sk = qf.shape[1], kf.shape[1]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=qf.device).tril()
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, vf.float()).to(qf.dtype)
