"""Rotary position embeddings (RoPE), half-split form."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., s, h, hd); positions: broadcastable to (..., s).

    Angles, sin and cos in fp32; the rotation multiplies stay in
    ``x.dtype``, as in the reference.
    """
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta).to(x.device)
    ang = positions[..., None].float() * inv
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
