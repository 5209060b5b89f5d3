"""Step builders for serving: prefill and decode.

The reference builds these for ``jax.jit``; the port runs them eagerly
under ``torch.no_grad()``.  Training steps are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import LanguageModel


def model_for(cfg):
    if cfg.encoder_decoder:
        raise NotImplementedError("encoder-decoder models are not ported")
    return LanguageModel


def forward(model, batch: Dict[str, Any], *, cache=None, positions=None,
            logits_mode="all"):
    return model.apply(batch["tokens"], positions=positions, cache=cache,
                       logits_mode=logits_mode)


def make_prefill_step(model, capacity: int):
    """Prefill: forward the prompt, return last-position logits + cache."""

    @torch.no_grad()
    def prefill_step(batch):
        b = batch["tokens"].shape[0]
        cache = model.init_cache(b, capacity)
        logits, cache, _ = forward(model, batch, cache=cache,
                                   logits_mode="last")
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(model):
    """One decode step: (cache, tokens (b, 1), pos) -> (logits, cache,
    pos + 1).  ``pos`` is a device scalar carried through the loop, so the
    loop never builds a host-side position per token."""

    @torch.no_grad()
    def serve_step(cache, tokens, pos):
        positions = pos.reshape(1) if pos.ndim == 0 else pos
        logits, new_cache, _ = forward(model, {"tokens": tokens}, cache=cache,
                                       positions=positions)
        return logits[:, -1], new_cache, pos + 1

    return serve_step
