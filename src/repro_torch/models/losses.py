"""Losses: next-token cross-entropy with z-loss and a memory-lean backward.

The forward reductions run in fp32; the backward recomputes the softmax
from the saved log-sum-exp rows and returns d(logits) in the logits'
dtype (bf16 at full width), so the only logits-sized buffer it makes is
that gradient -- as the reference's custom VJP does.
"""
from __future__ import annotations

import torch


class _NllAndLse(torch.autograd.Function):
    """(nll, lse) per position from logits (..., V) and labels (...)."""

    @staticmethod
    def forward(ctx, logits, labels):
        l32 = logits.float()
        lse = torch.logsumexp(l32, dim=-1)
        gold = torch.gather(l32, -1, labels[..., None].long())[..., 0]
        ctx.save_for_backward(logits, labels, lse)
        return lse - gold, lse

    @staticmethod
    def backward(ctx, g_nll, g_lse):
        logits, labels, lse = ctx.saved_tensors
        p = torch.exp(logits.float() - lse[..., None])
        coeff = (g_nll + g_lse)[..., None]
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        is_gold = vocab == labels[..., None].long()
        dlogits = coeff * p - torch.where(is_gold, g_nll[..., None], 0.0)
        return dlogits.to(logits.dtype), None


def softmax_cross_entropy(logits, labels, *, z_loss: float = 0.0, mask=None):
    """logits: (..., V); labels: (...) int.  Returns (loss, metrics)."""
    nll, lse = _NllAndLse.apply(logits, labels)
    total = nll
    if z_loss:
        total = total + z_loss * torch.square(lse)
    if mask is not None:
        denom = torch.clamp_min(mask.sum(), 1.0)
        loss = (total * mask).sum() / denom
        nll_mean = (nll * mask).sum() / denom
    else:
        loss = total.mean()
        nll_mean = nll.mean()
    metrics = {"nll": nll_mean,
               "ppl_proxy": torch.exp(torch.clamp(nll_mean, 0.0, 20.0))}
    return loss, metrics
