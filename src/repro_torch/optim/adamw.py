"""AdamW in plain torch, with the reference's math (optax-style
``(init, update)`` pair, fp32 moments).

Parameters, gradients and moments are dicts of tensors keyed by the
model's parameter names.  ``update`` changes the parameters and the
moments in place (the reference returns new trees) and returns the
metrics.

Weight decay follows the reference's rule, ``ndim >= 2`` -- but of the
leaf as the reference holds it.  The reference stacks the parameters of
scanned layers on a leading layer axis, so a per-layer norm scale, 1-D
here, is 2-D there and decayed.  ``update`` therefore takes each leaf's
reference rank (``repro_torch.convert.reference_ndims``), never the
tensor's own.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch


class Optimizer(NamedTuple):
    init: Callable[[Dict[str, torch.Tensor]], Dict]
    update: Callable[..., Dict[str, torch.Tensor]]


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in tree.values()]).sum())


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """Scale every leaf by ``min(1, max_norm / (norm + 1e-9))`` in fp32,
    keeping each leaf's dtype.  Returns (clipped, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, norm


def adamw(lr, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          max_grad_norm: Optional[float] = 1.0) -> Optimizer:
    """AdamW: clip, bias-corrected moments with ``t = step + 1``, decay
    added to the update (``delta + wd * p``) for leaves of rank >= 2."""
    lr_fn = lr if callable(lr) else (
        lambda step: torch.tensor(lr, dtype=torch.float32))

    def init(params):
        return {"m": {k: torch.zeros_like(p, dtype=torch.float32)
                      for k, p in params.items()},
                "v": {k: torch.zeros_like(p, dtype=torch.float32)
                      for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step, *, ndims):
        if max_grad_norm:
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        else:
            grads = {k: g.float() for k, g in grads.items()}
            gnorm = global_norm(grads)
        t = torch.as_tensor(step).to(torch.float32) + 1
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
        lr_t = lr_fn(step)
        # bc1, bc2 and lr_t are 0-d tensors; on the host they enter the
        # device arithmetic as scalars, with no copy per leaf.
        for name, p in params.items():
            g, m, v = grads[name].float(), state["m"][name], state["v"][name]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if ndims[name] >= 2 and weight_decay:
                delta = delta + weight_decay * p.float()
            p.copy_(p.float() - lr_t * delta)
        return {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init, update)
