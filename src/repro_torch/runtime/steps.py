"""Step builders: train, prefill, decode and the paged continuous-batching
decode step.

The reference builds these for ``jax.jit``; the port runs them eagerly.
The model family (decoder-only, vision prefix, encoder-decoder) is
resolved here, from the config, as in the reference.
The train step updates the model's parameters and the optimizer state in
place and returns the metrics; the serving steps run under
``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.convert import reference_ndims
from repro_torch.models import EncoderDecoderModel, LanguageModel
from repro_torch.models.losses import softmax_cross_entropy

AUX_LOSS_WEIGHT = 0.01
Z_LOSS = 1e-4


def model_for(cfg):
    return EncoderDecoderModel if cfg.encoder_decoder else LanguageModel


def refuse_encoder_decoder(cfg, what: str) -> None:
    """Raise a ``ValueError`` for an encoder-decoder ``cfg``: ``what``
    (generation, continuous batching, the training CLI) serves and trains
    decoder-only models (a vision model text-only), as the reference's do,
    and passes no encoder input."""
    if cfg.encoder_decoder:
        raise ValueError(f"{cfg.name} is an encoder-decoder: {what} takes "
                         f"decoder-only models and passes no encoder input")


def forward(model, batch: Dict[str, Any], *, cache=None, positions=None,
            logits_mode="all"):
    """The model over ``batch``: an encoder-decoder takes the encoder's
    input (``modality_feats``) or its output (``enc_out``), a decoder-only
    model the prefix ``modality_feats``."""
    if model.cfg.encoder_decoder:
        return model.apply(batch["tokens"], feats=batch.get("modality_feats"),
                           enc_out=batch.get("enc_out"), positions=positions,
                           cache=cache, logits_mode=logits_mode)
    return model.apply(batch["tokens"], positions=positions, cache=cache,
                       modality_feats=batch.get("modality_feats"),
                       logits_mode=logits_mode)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def make_loss_fn(cfg):
    """``loss_fn(model, batch) -> (total, metrics)``: next-token
    cross-entropy with z-loss, plus the weighted auxiliary loss.  Under a
    vision prefix only the text positions carry labels."""

    def loss_fn(model, batch):
        logits, _, aux = forward(model, batch)
        labels = batch["labels"]
        if cfg.modality == "vision":
            logits = logits[:, -labels.shape[1]:]
        loss, metrics = softmax_cross_entropy(logits, labels, z_loss=Z_LOSS)
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
    does; the metrics are the last microbatch's.  ``grad_compress`` runs
    the accumulated gradients through int8 error-feedback quantization
    (``optim.compression.error_feedback_compress``, the compressed wire
    format of a cross-host reduction, simulated on one device) before
    the update; the residual is carried in ``opt_state["ef_residual"]``.
    """
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
        if grad_compress:
            from repro_torch.optim.compression import error_feedback_compress
            grads, opt_state["ef_residual"] = error_feedback_compress(
                grads, opt_state.get("ef_residual"))
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
    """Prefill: forward the prompt (with the batch's ``modality_feats`` or
    ``enc_out``), return last-position logits + cache."""

    @torch.no_grad()
    def prefill_step(batch):
        b = batch["tokens"].shape[0]
        cache = model.init_cache(b, capacity)
        logits, cache, _ = forward(model, batch, cache=cache,
                                   logits_mode="last")
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(model):
    """One decode step: (cache, tokens (b, 1), pos, enc_out=None) ->
    (logits, cache, pos + 1).  ``pos`` is a device scalar carried through
    the loop, so the loop never builds a host-side position per token; an
    encoder-decoder passes its encoder's output each step."""

    @torch.no_grad()
    def serve_step(cache, tokens, pos, enc_out=None):
        batch = {"tokens": tokens}
        if enc_out is not None:
            batch["enc_out"] = enc_out
        positions = pos.reshape(1) if pos.ndim == 0 else pos
        logits, new_cache, _ = forward(model, batch, cache=cache,
                                       positions=positions)
        return logits[:, -1], new_cache, pos + 1

    return serve_step


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------

def _merge_inactive(new_cache, old_cache, active):
    """Keep the state rows of inactive slots from the previous step (the
    reference's ``_merge_inactive``).

    Inactive slots run through the forward at position -1: their paged KV
    and local-ring writes are already dropped (those buffers pass through
    as they are), but an RG-LRU or SSM layer computes a garbage update for
    every row, which is masked back to the old state here, with
    ``torch.where`` on the slot axis.  A layer's forward returns a new
    state and leaves the old one's tensors alone, so ``old_cache`` still
    holds the state before the step.  The merged leaf takes the promoted
    dtype of the two, as ``jnp.where`` gives it (a bf16 conv tail turns
    fp32 after the first step of an fp32 model)."""
    from repro_torch.models.rglru import RecurrentState
    from repro_torch.models.ssd import SSMState

    def where(new, old):
        dt = torch.promote_types(new.dtype, old.dtype)
        mask = active.reshape(-1, *([1] * (new.ndim - 1)))
        return torch.where(mask, new.to(dt), old.to(dt))

    return [type(new)(*(where(n, o) for n, o in zip(new, old)))
            if isinstance(new, (RecurrentState, SSMState)) else new
            for new, old in zip(new_cache, old_cache)]


def make_paged_serve_step(model):
    """One continuous-batching decode step over the paged serving cache.

    ``(cache, tokens (S, 1), lengths (S,), active (S,)) -> (next_tokens
    (S, 1), cache, lengths')``: greedy argmax decode.  Inactive slots run
    at position -1: they leave the pools and rings unchanged, their state rows
    are merged back from before the step (:func:`_merge_inactive`), their
    length is kept, and their token rows are garbage the scheduler
    ignores.  The batch composition reaches the kernels only through the
    block tables' and lengths' values.
    """

    @torch.no_grad()
    def paged_serve_step(cache, tokens, lengths, active):
        positions = torch.where(active, lengths, -1).to(torch.int32)[:, None]
        logits, new_cache, _ = forward(model, {"tokens": tokens}, cache=cache,
                                       positions=positions)
        new_cache = _merge_inactive(new_cache, cache, active)
        tok = torch.argmax(logits[:, -1], -1)
        new_lengths = torch.where(active, lengths + 1, lengths)
        return tok[:, None], new_cache, new_lengths

    return paged_serve_step


# ---------------------------------------------------------------------------
# shape-only helpers for the dry-run
# ---------------------------------------------------------------------------

def param_shapes(cfg, seed: int = 0):
    """The model built on the meta device: every parameter's shape and
    dtype, no storage (grok-1's 316 B parameters cost nothing).  The
    reference's ``eval_shape`` of its initialiser."""
    from repro_torch.core.config import shape_only
    with shape_only():
        return model_for(cfg)(cfg, device="meta", seed=seed)


def cache_shapes(cfg, batch: int, capacity: int, model=None):
    """The dense decode cache of ``batch`` x ``capacity`` on the meta
    device (``model``: a meta model of ``cfg``, built when not given)."""
    model = param_shapes(cfg) if model is None else model
    return model.init_cache(batch, capacity)


def opt_state_shapes(cfg, optimizer, params_shapes):
    """``optimizer``'s state for the meta model ``params_shapes``, on the
    meta device (factored where the reference factors its leaf)."""
    from repro_torch.convert import reference_shapes
    return optimizer.init(dict(params_shapes.named_parameters()),
                          shapes=reference_shapes(cfg, params_shapes))
