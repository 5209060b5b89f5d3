"""Step builders: train, prefill and decode.

The reference builds these for ``jax.jit``; the port runs them eagerly.
The train step updates the model's parameters and the optimizer state in
place and returns the metrics; the serving steps run under
``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.convert import reference_ndims
from repro_torch.models import LanguageModel
from repro_torch.models.losses import softmax_cross_entropy

AUX_LOSS_WEIGHT = 0.01
Z_LOSS = 1e-4


def model_for(cfg):
    if cfg.encoder_decoder:
        raise NotImplementedError("encoder-decoder models are not ported")
    return LanguageModel


def forward(model, batch: Dict[str, Any], *, cache=None, positions=None,
            logits_mode="all"):
    return model.apply(batch["tokens"], positions=positions, cache=cache,
                       logits_mode=logits_mode)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def make_loss_fn(cfg):
    """``loss_fn(model, batch) -> (total, metrics)``: next-token
    cross-entropy with z-loss, plus the weighted auxiliary loss."""
    if cfg.modality is not None:
        raise NotImplementedError("modality frontends are not ported")

    def loss_fn(model, batch):
        logits, _, aux = forward(model, batch)
        loss, metrics = softmax_cross_entropy(logits, batch["labels"],
                                              z_loss=Z_LOSS)
        total = loss + AUX_LOSS_WEIGHT * aux
        return total, dict(metrics, aux_loss=aux, loss=total)

    return loss_fn


def make_train_step(cfg, optimizer, *, microbatches: int = 1,
                    grad_compress: bool = False):
    """``train_step(model, opt_state, batch, step) -> metrics``.

    Computes the gradients, then ``optimizer.update`` changes the model's
    parameters and ``opt_state`` in place, with weight decay decided by
    each parameter's rank in the reference (``reference_ndims``).
    ``microbatches > 1`` splits the batch on its first axis and sums the
    microbatch gradients in bf16, dividing at the end, as the reference
    does; the metrics are the last microbatch's.
    """
    if grad_compress:
        raise NotImplementedError("grad_compress (int8 error-feedback "
                                  "gradients) is not ported")
    loss_fn = make_loss_fn(cfg)

    def grads_of(model, names, params, batch):
        total, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        return {n: torch.zeros_like(p) if g is None else g
                for n, p, g in zip(names, params, grads)}, metrics

    def train_step(model, opt_state, batch, step):
        names, params = zip(*model.named_parameters())
        if microbatches == 1:
            grads, metrics = grads_of(model, names, params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            grads = {n: torch.zeros_like(p, dtype=torch.bfloat16)
                     for n, p in zip(names, params)}
            for mb in range(microbatches):
                rows = slice(mb * (b // microbatches),
                             (mb + 1) * (b // microbatches))
                g, metrics = grads_of(model, names, params,
                                      {k: v[rows] for k, v in batch.items()})
                for n in names:
                    grads[n] = grads[n] + g[n].to(torch.bfloat16)
                del g
            grads = {n: g / microbatches for n, g in grads.items()}
        metrics = {k: v.detach() for k, v in metrics.items()}
        opt_metrics = optimizer.update(
            grads, opt_state, dict(zip(names, params)), step,
            ndims=reference_ndims(cfg, model))
        return {**metrics, **opt_metrics}

    return train_step


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

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
