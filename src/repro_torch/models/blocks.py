"""Residual blocks and the layer stack.

A block is norm -> attention -> residual, then norm -> MLP -> residual.
The stack is an ``nn.ModuleList`` run in a Python loop (the reference
scans stacked parameters; the port runs eagerly).  Only the "attn" block
kind and dense MLPs are ported: other kinds, MoE and cross-attention
raise.
"""
from __future__ import annotations

from typing import List, Optional

from torch import nn

from repro_torch.core.machine import torch_dtype
from repro_torch.models.attention import Attention, KVCache, init_kv_cache
from repro_torch.models.common import Init, make_norm
from repro_torch.models.mlp import MLP


def check_ported(cfg) -> None:
    """Raise for any configuration axis this port does not cover yet."""
    unported = {
        "block kinds other than 'attn'": set(cfg.block_pattern) != {"attn"},
        "mixture of experts": cfg.num_experts > 0,
        "encoder-decoder": cfg.encoder_decoder,
        "modality frontends": cfg.modality is not None,
        "sliding-window attention": cfg.attn_window is not None,
    }
    missing = [name for name, hit in unported.items() if hit]
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported: {', '.join(missing)}")


class Block(nn.Module):
    def __init__(self, cfg, init: Init):
        super().__init__()
        self.cfg = cfg
        self.norm_mix = make_norm(cfg.norm_type, cfg.d_model, init)
        self.mixer = Attention(cfg, init)
        if cfg.block_has_mlp:
            self.norm_ff = make_norm(cfg.norm_type, cfg.d_model, init)
            self.ff = MLP(cfg, init)

    def forward(self, x, positions, *, cache: Optional[KVCache] = None):
        """Returns (x, cache)."""
        cfg = self.cfg
        y, cache = self.mixer(self.norm_mix(x, cfg.norm_eps), positions,
                              cache=cache)
        x = x + y
        if cfg.block_has_mlp:
            x = x + self.ff(self.norm_ff(x, cfg.norm_eps))
        return x, cache


def stack_cache(cfg, batch: int, capacity: int, device) -> List[KVCache]:
    """One dense KV cache per layer."""
    return [init_kv_cache(batch, capacity, cfg.num_kv_heads, cfg.head_dim,
                          torch_dtype(cfg.kv_cache_dtype), device)
            for _ in range(cfg.num_layers)]


def stack_apply(blocks: nn.ModuleList, x, positions, *, cache=None):
    """Run every block in order; returns (x, caches or None)."""
    new_cache = [] if cache is not None else None
    for i, block in enumerate(blocks):
        x, c = block(x, positions, cache=None if cache is None else cache[i])
        if new_cache is not None:
            new_cache.append(c)
    return x, new_cache

