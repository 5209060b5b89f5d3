"""Residual blocks and the layer stack.

A block is norm -> mixer -> residual, then in a decoder block built with
``cross=True`` (the encoder-decoder's) norm -> cross-attention into the
encoder's output -> residual, then (where the model has one) norm -> MLP
or mixture of experts -> residual.  Mixer kinds: "attn"
(global attention), "local" (sliding-window attention over
``cfg.attn_window``), "rec" (RG-LRU) and "ssm" (Mamba-2 SSD); the layer
at depth ``i`` has kind ``block_pattern[i % len(block_pattern)]``.  The
stack is an ``nn.ModuleList`` run in a Python loop (the reference scans
stacked parameters over pattern groups, ``len(block_pattern)``
consecutive layers, and runs any remainder layers unscanned; the port
runs eagerly) and sums the blocks' MoE auxiliary losses group by group,
as the reference's scan does.  With ``cfg.remat`` and gradients on, each
whole group runs under one non-reentrant ``torch.utils.checkpoint``,
which keeps only the group's input and recomputes its forward in the
backward (the reference's ``save_only_these_names("block_carry")``);
remainder layers run without it.  The decode cache is one leaf per
layer: dense or paged KV for "attn", a dense ring of ``min(capacity,
window)`` rows for "local", slot-major states for "rec" and "ssm";
cross-attention keeps no cache (the encoder's output is passed to every
step).
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from repro_torch.core.machine import torch_dtype
from repro_torch.core.trace import span
from repro_torch.models.attention import (Attention, KVCache, PagedKVCache,
                                          init_kv_cache, init_paged_kv_cache,
                                          paged_step)
from repro_torch.models.common import Init, checkpointed, make_norm
from repro_torch.models.mlp import MLP
from repro_torch.models.moe import MoE
from repro_torch.models.rglru import RGLRU, init_recurrent_state
from repro_torch.models.ssd import SSD, init_ssm_state
from repro_torch.runtime.shardlib import shard_activation


def check_ported(cfg) -> None:
    """Raise for any configuration axis this port does not cover yet."""
    unported = {
        "block kinds other than 'attn', 'local', 'rec' and 'ssm'":
            not set(cfg.block_pattern) <= {"attn", "local", "rec", "ssm"},
        "mixture of experts without top-k routing (num_experts_per_tok < 1)":
            cfg.num_experts > 0 and cfg.num_experts_per_tok < 1,
        "modality frontends other than 'vision' and 'audio'":
            cfg.modality not in (None, "vision", "audio"),
    }
    missing = [name for name, hit in unported.items() if hit]
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported: {', '.join(missing)}")


def layer_kinds(cfg) -> List[str]:
    """The mixer kind of every layer, in depth order."""
    pat = cfg.block_pattern
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


class Block(nn.Module):
    def __init__(self, cfg, init: Init, kind: str, cross: bool = False):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.norm_mix = make_norm(cfg.norm_type, cfg.d_model, init)
        mixers = {"attn": Attention, "local": Attention, "rec": RGLRU,
                  "ssm": SSD}
        if kind not in mixers:
            raise ValueError(f"unknown block kind {kind!r}")
        self.mixer = mixers[kind](cfg, init)
        self.window = cfg.attn_window if kind == "local" else None
        self.cross = None
        if cross:
            self.norm_cross = make_norm(cfg.norm_type, cfg.d_model, init)
            self.cross = Attention(cfg, init)
        if cfg.block_has_mlp:
            self.norm_ff = make_norm(cfg.norm_type, cfg.d_model, init)
            self.ff = MoE(cfg, init) if cfg.num_experts else MLP(cfg, init)

    def forward(self, x, positions, *, cache: Optional[KVCache] = None,
                step=None, enc_out=None):
        """Returns (x, cache, aux_loss); ``step`` is a paged decode step's
        :class:`~repro_torch.models.attention.PagedStep`.  An "ssm" or
        "rec" block's cache is its state (:class:`~repro_torch.models.ssd.
        SSMState`, :class:`~repro_torch.models.rglru.RecurrentState`);
        aux_loss is the MoE load-balancing loss (zero without experts).
        A block built with ``cross`` attends into ``enc_out`` (b, s_enc,
        d) after its mixer, when ``enc_out`` is given."""
        cfg = self.cfg
        h = self.norm_mix(x, cfg.norm_eps)
        if self.kind in ("ssm", "rec"):
            with span(self.kind):
                y, cache = self.mixer(h, state=cache)
        else:
            with span("attention"):
                y, cache = self.mixer(h, positions, cache=cache,
                                      window=self.window, step=step)
        x = x + y
        x = shard_activation(x, (("pod", "data"), "model", None))
        if enc_out is not None and self.cross is not None:
            h = self.norm_cross(x, cfg.norm_eps)
            y, _ = self.cross(h, positions, kv_override=enc_out)
            x = x + y
        aux = torch.zeros((), device=x.device)
        if cfg.block_has_mlp:
            h = self.norm_ff(x, cfg.norm_eps)
            with span("mlp"):
                if cfg.num_experts:
                    y, aux = self.ff(h)
                else:
                    y = self.ff(h)
            x = x + y
            x = shard_activation(x, (("pod", "data"), "model", None))
        return x, cache, aux


def stack_cache(cfg, batch: int, capacity: int, device, paged=None) -> List:
    """One decode cache per layer.  An "attn" layer gets a dense KV cache,
    or with ``paged`` (a :class:`~repro_torch.models.attention.PageSpec`)
    a paged pool with ``batch`` block-table rows, the continuous-batching
    serving cache: every attention layer maps its pool through the same
    slots' pages, so those layers share one block-table tensor.  A "local"
    layer gets a dense ring of ``min(capacity, attn_window)`` rows and an
    "ssm" or "rec" layer a slot-major state of ``batch`` rows, paged or
    not (O(window) and O(1) in the sequence length), as the reference's
    ``block_cache`` gives them."""
    dt = torch_dtype(cfg.kv_cache_dtype)
    leaves, tables = [], None
    for kind in layer_kinds(cfg):
        if kind == "ssm":
            leaves.append(init_ssm_state(batch, cfg, device))
        elif kind == "rec":
            leaves.append(init_recurrent_state(batch, cfg, device))
        elif kind == "local":
            leaves.append(init_kv_cache(batch, min(capacity, cfg.attn_window),
                                        cfg.num_kv_heads, cfg.head_dim, dt,
                                        device))
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


def _run_blocks(blocks, x, positions, caches, step, enc_out=None):
    """Blocks in order; returns (x, their caches, the sum of their aux
    losses from zero)."""
    aux = torch.zeros((), device=x.device)
    new = []
    for block, c in zip(blocks, caches):
        x, c, a = block(x, positions, cache=c, step=step, enc_out=enc_out)
        aux = aux + a
        new.append(c)
    return x, new, aux


def _group_forward(blocks, x, positions, enc_out):
    x, _, aux = _run_blocks(blocks, x, positions, [None] * len(blocks), None,
                            enc_out)
    return x, aux


def _spans(n: int, group: int):
    """(start, end) of each scanned group of ``group`` layers, then of each
    remainder layer on its own."""
    grouped = n // group * group
    return [(g0, g0 + group) for g0 in range(0, grouped, group)] \
        + [(i, i + 1) for i in range(grouped, n)]


def stack_apply(blocks: nn.ModuleList, x, positions, *, cache=None,
                group: int = 1, remat: bool = False, enc_out=None):
    """Run every block in order; returns (x, caches or None, the sum of
    the blocks' aux losses).  ``enc_out`` reaches every block (the
    cross-attention of an encoder-decoder's decoder), the recompute of a
    checkpointed group too.  The first ``len(blocks) // group * group``
    blocks form groups of ``group`` (``len(cfg.block_pattern)``); each
    group's aux losses are summed before they join the total, and each
    remainder layer's joins it alone, the reference's order.  With
    ``remat`` and gradients on, each group runs under one non-reentrant
    checkpoint: the values are the same, only memory and recompute change.
    A paged decode step's per-slot state is built once, from the first
    paged leaf, for every attention layer."""
    n, grouped = len(blocks), len(blocks) // group * group
    recompute = remat and torch.is_grad_enabled()
    if recompute and cache is not None:
        # The recompute replays the forward: a cache written in place
        # would be written twice.
        raise ValueError("remat recomputes each group's forward: a "
                         "checkpointed group cannot carry a cache")
    paged = [c for c in cache or () if isinstance(c, PagedKVCache)]
    step = paged_step(paged[0], positions) if paged else None
    caches = [None] * n if cache is None else cache
    new_cache = []
    aux_total = torch.zeros((), device=x.device)
    for start, end in _spans(n, group):
        if recompute and start < grouped:
            x, aux = checkpointed(_group_forward, blocks[start:end], x,
                                  positions, enc_out)
        else:
            x, c, aux = _run_blocks(blocks[start:end], x, positions,
                                    caches[start:end], step, enc_out)
            new_cache += c
        aux_total = aux_total + aux
    return x, None if cache is None else new_cache, aux_total
