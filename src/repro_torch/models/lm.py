"""Decoder-only language model, with an optional modality prefix.

  * ``LanguageModel(cfg, device=None, seed=0)`` -- builds the modules with
    seeded fp32 master weights on ``device`` (the configured default,
    CUDA unless the caller says otherwise);
  * ``model.apply(tokens, ...) -> (logits, cache, aux)`` (also ``forward``;
    with ``cfg.remat`` and gradients on, each layer group's forward is
    recomputed in the backward);
  * ``model.init_cache(batch, capacity, paged=None) -> cache``.

Decode is ``apply`` with a one-token input and a cache.  A model whose
config names a ``modality`` builds ``frontend``; ``modality_feats`` then
prepend the projected prefix to the token embeddings.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.config import resolve_device
from repro_torch.core.machine import torch_dtype
from repro_torch.models.blocks import Block, check_ported, layer_kinds, \
    stack_apply, stack_cache
from repro_torch.models.common import Embedding, Init, Linear, make_norm, \
    readout
from repro_torch.models.frontends import Frontend
from repro_torch.runtime.shardlib import shard_activation


class LanguageModel(nn.Module):
    def __init__(self, cfg, *, device=None, seed: int = 0):
        super().__init__()
        check_ported(cfg)
        if cfg.encoder_decoder:
            raise ValueError(f"{cfg.name} is an encoder-decoder: build it "
                             f"with EncoderDecoderModel")
        self.cfg = cfg
        init = Init(seed, resolve_device(device))
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, init)
        self.blocks = nn.ModuleList(Block(cfg, init, kind)
                                    for kind in layer_kinds(cfg))
        self.final_norm = make_norm(cfg.norm_type, cfg.d_model, init)
        if not cfg.tie_embeddings:
            self.lm_head = Linear(cfg.d_model, cfg.vocab_size, init)
        if cfg.modality is not None:
            self.frontend = Frontend(cfg, init)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def forward(self, tokens, *, positions=None, cache=None,
                modality_feats=None, logits_mode="all"):
        """tokens: (b, s) integer ids.  modality_feats: (b, n_mod,
        modality_dim), projected and prepended before the text tokens
        (default positions count the prefix).  ``logits_mode="last"``
        unembeds only the final position.  Returns (logits, new_cache,
        aux_loss), the last the sum of the MoE layers' load-balancing
        losses."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        s = tokens.shape[1]
        x = self.embed.embed(tokens, dt)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
        n_mod = 0
        if modality_feats is not None:
            prefix = self.frontend(modality_feats)
            n_mod = prefix.shape[1]
            x = torch.cat([prefix, x], dim=1)
        if positions is None:
            positions = torch.arange(s + n_mod, dtype=torch.int32,
                                     device=tokens.device)
        x = shard_activation(x, (("pod", "data"), "model", None))
        x, new_cache, aux = stack_apply(self.blocks, x, positions,
                                        cache=cache,
                                        group=len(cfg.block_pattern),
                                        remat=cfg.remat)
        x = self.final_norm(x, cfg.norm_eps)
        if logits_mode == "last":
            x = x[:, -1:]
        ldt = torch_dtype(cfg.logits_dtype)
        if cfg.tie_embeddings:
            logits = self.embed.unembed(x, dt, out_dtype=ldt)
        else:
            logits = readout(x, self.lm_head.w, dt, ldt)
        if cfg.final_logit_softcap:
            cap = cfg.final_logit_softcap
            logits = torch.tanh(logits / cap) * cap
        logits = shard_activation(logits, (("pod", "data"), "model", None))
        return logits, new_cache, aux

    # The reference's name for the forward pass.  (It shadows
    # nn.Module.apply(fn); the port never applies functions to submodules.)
    apply = forward

    def init_cache(self, batch: int, capacity: int, paged=None):
        """Dense per-layer decode caches (KV caches, local rings of
        ``min(capacity, attn_window)`` rows, RG-LRU and SSM states), or
        with ``paged`` (a ``PageSpec``) the continuous-batching serving
        cache: paged pools sharing one block-table tensor for "attn"
        layers, the same rings and slot-major states for the others."""
        return stack_cache(self.cfg, batch, capacity, self.device, paged)
