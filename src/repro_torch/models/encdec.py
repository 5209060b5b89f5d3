"""Encoder-decoder model (the seamless-m4t backbone; its audio frontend
is a stub, as in the reference).

  * ``EncoderDecoderModel(cfg, device=None, seed=0)`` -- seeded fp32
    master weights on ``device`` (CUDA unless the caller says otherwise);
  * ``model.encode(feats)``: the frontend's ``adapter`` over precomputed
    frame embeddings (b, s_enc, modality_dim), then ``num_encoder_layers``
    encoder blocks (norm -> bidirectional attention -> residual -> norm ->
    MLP -> residual) and ``enc_norm`` -> (b, s_enc, d);
  * ``model.apply(tokens, feats=None, *, enc_out=None, ...)`` (also
    ``forward``): the decoder (blocks with cross-attention into
    ``enc_out``, computed from ``feats`` when not given) over ``tokens``,
    ``final_norm`` and the untied ``lm_head`` -> (logits, cache, aux);
  * ``model.init_cache(batch, capacity)``: the decoder's self-attention
    caches.  A decode step passes the same ``enc_out`` again: the
    cross-attention keeps no cache, as in the reference.

The encoder's bidirectional attention is the reference's: cross-attention
of the sequence into itself (``kv_override``), the non-causal flash
kernel under the ``engine`` backend.  With ``cfg.remat`` and gradients on,
each encoder layer runs under a non-reentrant checkpoint (the reference's
``nothing_saveable`` checkpoint of its scan body) and each decoder layer
group as in :func:`~repro_torch.models.blocks.stack_apply`.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.config import resolve_device
from repro_torch.core.machine import torch_dtype
from repro_torch.models.attention import Attention
from repro_torch.models.blocks import Block, check_ported, layer_kinds, \
    stack_apply, stack_cache
from repro_torch.models.common import Embedding, Init, Linear, \
    checkpointed, make_norm, readout
from repro_torch.models.frontends import Frontend
from repro_torch.models.mlp import MLP
from repro_torch.runtime.shardlib import shard_activation

_SEQ_SPEC = (("pod", "data"), "model", None)


class EncoderBlock(nn.Module):
    def __init__(self, cfg, init: Init):
        super().__init__()
        self.cfg = cfg
        self.norm_attn = make_norm(cfg.norm_type, cfg.d_model, init)
        self.attn = Attention(cfg, init)
        self.norm_ff = make_norm(cfg.norm_type, cfg.d_model, init)
        self.ff = MLP(cfg, init)

    def forward(self, x, positions):
        cfg = self.cfg
        h = self.norm_attn(x, cfg.norm_eps)
        # Bidirectional: the sequence attends into itself, no causal mask.
        y, _ = self.attn(h, positions, kv_override=h)
        x = x + y
        x = x + self.ff(self.norm_ff(x, cfg.norm_eps))
        return shard_activation(x, _SEQ_SPEC)


class EncoderDecoderModel(nn.Module):
    def __init__(self, cfg, *, device=None, seed: int = 0):
        super().__init__()
        check_ported(cfg)
        if not cfg.encoder_decoder:
            raise ValueError(f"{cfg.name} is not an encoder-decoder: build "
                             f"it with LanguageModel")
        self.cfg = cfg
        init = Init(seed, resolve_device(device))
        self.frontend = Frontend(cfg, init)
        self.encoder = nn.ModuleList(EncoderBlock(cfg, init)
                                     for _ in range(cfg.num_encoder_layers))
        self.enc_norm = make_norm(cfg.norm_type, cfg.d_model, init)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, init)
        self.decoder = nn.ModuleList(Block(cfg, init, kind, cross=True)
                                     for kind in layer_kinds(cfg))
        self.final_norm = make_norm(cfg.norm_type, cfg.d_model, init)
        self.lm_head = Linear(cfg.d_model, cfg.vocab_size, init)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def encode(self, feats):
        """feats: (b, s_enc, modality_dim) -> (b, s_enc, d)."""
        cfg = self.cfg
        x = self.frontend(feats)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        x = shard_activation(x, _SEQ_SPEC)
        recompute = cfg.remat and torch.is_grad_enabled()
        for layer in self.encoder:
            x = checkpointed(layer, x, positions) if recompute \
                else layer(x, positions)
        return self.enc_norm(x, cfg.norm_eps)

    def forward(self, tokens, feats=None, *, enc_out=None, positions=None,
                cache=None, logits_mode="all"):
        """Teacher-forced decode over ``tokens`` (b, s) given the encoder's
        input ``feats`` or its output ``enc_out``.  ``logits_mode="last"``
        unembeds only the final position.  Returns (logits, new_cache,
        aux_loss)."""
        cfg = self.cfg
        if enc_out is None:
            if feats is None:
                raise ValueError("an encoder-decoder needs the encoder's "
                                 "input (feats) or its output (enc_out)")
            enc_out = self.encode(feats)
        dt = torch_dtype(cfg.dtype)
        s = tokens.shape[1]
        x = self.embed.embed(tokens, dt)
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
        x = shard_activation(x, _SEQ_SPEC)
        x, new_cache, aux = stack_apply(self.decoder, x, positions,
                                        cache=cache,
                                        group=len(cfg.block_pattern),
                                        remat=cfg.remat, enc_out=enc_out)
        x = self.final_norm(x, cfg.norm_eps)
        if logits_mode == "last":
            x = x[:, -1:]
        logits = readout(x, self.lm_head.w, dt,
                         torch_dtype(cfg.logits_dtype))
        logits = shard_activation(logits, _SEQ_SPEC)
        return logits, new_cache, aux

    # The reference's name for the forward pass (see LanguageModel.apply).
    apply = forward

    def init_cache(self, batch: int, capacity: int):
        """The decoder's dense per-layer self-attention caches."""
        return stack_cache(self.cfg, batch, capacity, self.device)
