"""Residual blocks and the layer stack.

A block is norm -> mixer -> residual, then (where the model has one)
norm -> MLP or mixture of experts -> residual.  Mixer kinds ported:
"attn" (global attention) and "ssm" (Mamba-2 SSD); the layer at depth
``i`` has kind ``block_pattern[i % len(block_pattern)]``.  The stack is
an ``nn.ModuleList`` run in a Python loop (the reference scans stacked
parameters; the port runs eagerly) and sums the blocks' MoE auxiliary
losses.  Its decode cache is one leaf per layer, dense or (for the
continuous-batching runtime) paged.  Other kinds ("rec", "local") and
cross-attention raise.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from repro_torch.core.machine import torch_dtype
from repro_torch.models.attention import (Attention, KVCache, PagedKVCache,
                                          init_kv_cache, init_paged_kv_cache,
                                          paged_step)
from repro_torch.models.common import Init, make_norm
from repro_torch.models.mlp import MLP
from repro_torch.models.moe import MoE
from repro_torch.models.ssd import SSD, init_ssm_state


def check_ported(cfg) -> None:
    """Raise for any configuration axis this port does not cover yet."""
    unported = {
        "block kinds other than 'attn' and 'ssm'":
            not set(cfg.block_pattern) <= {"attn", "ssm"},
        "mixture of experts without top-k routing (num_experts_per_tok < 1)":
            cfg.num_experts > 0 and cfg.num_experts_per_tok < 1,
        "encoder-decoder": cfg.encoder_decoder,
        "modality frontends": cfg.modality is not None,
        "sliding-window attention": cfg.attn_window is not None,
    }
    missing = [name for name, hit in unported.items() if hit]
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported: {', '.join(missing)}")


def layer_kinds(cfg) -> List[str]:
    """The mixer kind of every layer, in depth order."""
    pat = cfg.block_pattern
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


class Block(nn.Module):
    def __init__(self, cfg, init: Init, kind: str):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.norm_mix = make_norm(cfg.norm_type, cfg.d_model, init)
        self.mixer = SSD(cfg, init) if kind == "ssm" else Attention(cfg, init)
        if cfg.block_has_mlp:
            self.norm_ff = make_norm(cfg.norm_type, cfg.d_model, init)
            self.ff = MoE(cfg, init) if cfg.num_experts else MLP(cfg, init)

    def forward(self, x, positions, *, cache: Optional[KVCache] = None,
                step=None):
        """Returns (x, cache, aux_loss); ``step`` is a paged decode step's
        :class:`~repro_torch.models.attention.PagedStep`.  An "ssm" block's
        cache is its :class:`~repro_torch.models.ssd.SSMState`; aux_loss is
        the MoE load-balancing loss (zero without experts)."""
        cfg = self.cfg
        h = self.norm_mix(x, cfg.norm_eps)
        if self.kind == "ssm":
            y, cache = self.mixer(h, state=cache)
        else:
            y, cache = self.mixer(h, positions, cache=cache, step=step)
        x = x + y
        aux = torch.zeros((), device=x.device)
        if cfg.block_has_mlp:
            h = self.norm_ff(x, cfg.norm_eps)
            if cfg.num_experts:
                y, aux = self.ff(h)
            else:
                y = self.ff(h)
            x = x + y
        return x, cache, aux


def stack_cache(cfg, batch: int, capacity: int, device, paged=None) -> List:
    """One decode cache per layer.  An "attn" layer gets a dense KV cache,
    or with ``paged`` (a :class:`~repro_torch.models.attention.PageSpec`)
    a paged pool with ``batch`` block-table rows, the continuous-batching
    serving cache: every attention layer maps its pool through the same
    slots' pages, so those layers share one block-table tensor.  An "ssm"
    layer gets a slot-major :class:`~repro_torch.models.ssd.SSMState` of
    ``batch`` rows either way (O(1) in the sequence length), as the
    reference's ``block_cache`` gives it."""
    dt = torch_dtype(cfg.kv_cache_dtype)
    leaves, tables = [], None
    for kind in layer_kinds(cfg):
        if kind == "ssm":
            leaves.append(init_ssm_state(batch, cfg, device))
        elif paged is None:
            leaves.append(init_kv_cache(batch, capacity, cfg.num_kv_heads,
                                        cfg.head_dim, dt, device))
        else:
            leaf = init_paged_kv_cache(batch, paged, cfg.num_kv_heads,
                                       cfg.head_dim, dt, device)
            if tables is None:
                tables = leaf.tables
            leaf.tables = tables
            leaves.append(leaf)
    return leaves


def stack_apply(blocks: nn.ModuleList, x, positions, *, cache=None):
    """Run every block in order; returns (x, caches or None, the sum of
    the blocks' aux losses).  A paged decode step's per-slot state is
    built once, from the first paged leaf, for every attention layer."""
    new_cache = [] if cache is not None else None
    paged = [c for c in cache or () if isinstance(c, PagedKVCache)]
    step = paged_step(paged[0], positions) if paged else None
    aux_total = torch.zeros((), device=x.device)
    for i, block in enumerate(blocks):
        x, c, aux = block(x, positions,
                          cache=None if cache is None else cache[i],
                          step=step)
        aux_total = aux_total + aux
        if new_cache is not None:
            new_cache.append(c)
    return x, new_cache, aux_total

