"""Oracles for the flash-attention family: plain softmax attention."""
from __future__ import annotations

import torch

NEG_INF = -1e30


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
