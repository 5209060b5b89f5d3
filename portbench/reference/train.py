"""The training step in plain float32 PyTorch: next-token cross-entropy
with z-loss (1e-4 x lse^2), the loss the mean over every token of the
batch; gradients clipped to a global norm of 1; AdamW (bias-corrected
moments with t = step + 1, ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd *
p)``), the decay on every leaf of the layer stack and every leaf of rank 2
or more, not on the final norm's scale.  A dense decoder only.

The batch runs one sequence at a time, each layer under a checkpoint, so
the reference fits beside nothing else; the gradients sum over sequences,
which is the same loss.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from reference.model import block, linear, no_tf32, rmsnorm

Z_LOSS = 1e-4


def decayed(name: str, shape) -> bool:
    return name.startswith("blocks.") or len(shape) >= 2


def sequence_loss(cfg: Dict, P: Dict, tokens, labels, fp8: bool):
    """Sum over the sequence's positions of nll + z * lse^2."""
    x = P["embed.table"][tokens]
    for i in range(cfg["num_layers"]):
        x = checkpoint(lambda x, i=i: block(x, P, i, cfg, fp8), x,
                       use_reentrant=False)
    x = rmsnorm(x, P["final_norm.scale"], cfg["norm_eps"])
    logits = linear(x, P["lm_head.w"], fp8)
    lse = torch.logsumexp(logits, -1)
    nll = lse - logits.gather(-1, labels[:, None])[:, 0]
    return (nll + Z_LOSS * lse.square()).sum()


def train(cfg: Dict, opt: Dict, params: Dict[str, torch.Tensor],
          batches: Callable[[int], tuple], steps: int, *, fp8: bool = False,
          rows: Optional[slice] = None) -> Dict:
    """Run ``steps`` steps from ``params`` (float32 leaves, changed in
    place).  ``batches(step)`` gives (tokens, labels), (batch, seq) each;
    ``rows`` keeps only those rows (a fault of the check's tests).  Returns
    each step's loss, the first step's clipped gradient norm a leaf, and
    the parameters after the last step."""
    if cfg["num_experts"]:
        raise NotImplementedError("the training reference is dense only")
    no_tf32()
    names = list(params)
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    for p in params.values():
        p.requires_grad_(True)
    losses: List[float] = []
    first_grad: Dict[str, float] = {}
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    for step in range(steps):
        tokens, labels = batches(step)
        if rows is not None:
            tokens, labels = tokens[rows], labels[rows]
        count = tokens.numel()
        total = 0.0
        for r in range(tokens.shape[0]):
            loss = sequence_loss(cfg, params, tokens[r], labels[r], fp8) \
                / count
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            grads = {n: params[n].grad for n in names}
            norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            scale = torch.clamp(opt["max_grad_norm"] / (norm + 1e-9), max=1.0)
            t = step + 1
            for n in names:
                g = grads[n] * scale
                if step == 0:
                    first_grad[n] = float(g.norm())
                m[n].mul_(b1).add_((1 - b1) * g)
                v[n].mul_(b2).add_((1 - b2) * g.square())
                delta = (m[n] / (1 - b1 ** t)) / (
                    torch.sqrt(v[n] / (1 - b2 ** t)) + eps)
                if decayed(n, params[n].shape) and wd:
                    delta = delta + wd * params[n]
                params[n].sub_(opt["lr"] * delta)
                params[n].grad = None
    for p in params.values():
        p.requires_grad_(False)
    return {"losses": losses, "first_grad": first_grad, "params": params}
