"""AdamW in plain torch, with the reference's math (optax-style
``(init, update)`` pairs):

  * ``adamw`` -- standard AdamW, fp32 moments;
  * ``scalable_adamw`` -- the variant the reference gives models past 10 B
    parameters: a bf16 first moment (or none, ``use_momentum=False``) and
    a second moment factored into row and column means of g^2 for every
    leaf whose two trailing dims are both >= 128 (Adafactor).

Parameters, gradients and moments are dicts of tensors keyed by the
model's parameter names.  ``update`` changes the parameters and the
moments in place (the reference returns new trees) and returns the
metrics.

Weight decay follows the reference's rule, ``ndim >= 2`` -- but of the
leaf as the reference holds it.  The reference stacks the parameters of
scanned layers on a leading layer axis, so a per-layer norm scale, 1-D
here, is 2-D there and decayed.  ``update`` therefore takes each leaf's
reference rank (``repro_torch.convert.reference_ndims``), never the
tensor's own.  Which leaves ``scalable_adamw`` factors is likewise decided
on the leaf as the reference holds it (``init``'s ``shapes``,
``repro_torch.convert.reference_shapes``); the state records the choice
(a factored leaf's second moment is ``{"r": ..., "c": ...}``), and
``update`` reads it from there.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.core.trace import span


class Optimizer(NamedTuple):
    init: Callable[[Dict[str, torch.Tensor]], Dict]
    update: Callable[..., Dict[str, torch.Tensor]]


def _spanned(update):
    """``update`` as an ``optim.update`` span."""
    @functools.wraps(update)
    def spanned(*args, **kwargs):
        with span("optim.update"):
            return update(*args, **kwargs)
    return spanned


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

    def init(params, *, shapes=None):
        # ``shapes`` is accepted for a call shared with scalable_adamw.
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

    return Optimizer(init, _spanned(update))


_FACTOR_MIN_SIZE = 128  # factor v only for matrices with both dims >= this


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= _FACTOR_MIN_SIZE \
        and shape[-2] >= _FACTOR_MIN_SIZE


def is_factored_leaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {"r", "c"}


def scalable_adamw(lr, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                   max_grad_norm: Optional[float] = 1.0,
                   use_momentum: bool = True) -> Optimizer:
    """AdamW with a bf16 first moment and a factored second moment.

    ``v ~ r (x) c / mean(r)``: r and c are the row and column means of
    ``g^2 + 1e-30`` (Adafactor, Shazeer & Stern 2018), taken over the
    leaf's two trailing dims.  The first moment is updated in fp32 and
    stored rounded to bf16; ``use_momentum=False`` keeps none and steps
    along ``g`` itself.  ``init(params, shapes=...)`` factors a leaf when
    its shape as the reference holds it (``shapes[name]``, default the
    tensor's own) has two trailing dims >= 128.  A layer of a scanned group
    has the reference's trailing dims, so the choice is the reference's;
    the one case that differs, a stacked 1-D leaf over 128 or more groups
    (which the reference factors across layers), raises."""
    lr_fn = lr if callable(lr) else (
        lambda step: torch.tensor(lr, dtype=torch.float32))

    def init(params, *, shapes=None):
        v = {}
        for k, p in params.items():
            ref = tuple(shapes[k]) if shapes is not None else tuple(p.shape)
            if _factored(ref) and p.ndim < 2:
                raise NotImplementedError(
                    f"{k}: the reference factors this leaf across its "
                    f"{ref[0]} stacked layers ({ref})")
            if _factored(ref):
                v[k] = {"r": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                         device=p.device),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                         dtype=torch.float32,
                                         device=p.device)}
            else:
                v[k] = torch.zeros_like(p, dtype=torch.float32)
        state = {"v": v}
        if use_momentum:
            state["m"] = {k: torch.zeros_like(p, dtype=torch.bfloat16)
                          for k, p in params.items()}
        return state

    @torch.no_grad()
    def update(grads, state, params, step, *, ndims):
        if max_grad_norm:
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        else:
            gnorm = global_norm(grads)
        t = torch.as_tensor(step).to(torch.float32) + 1
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
        lr_t = lr_fn(step)
        for name, p in params.items():
            g = grads[name].float()  # per-leaf upcast (not the whole tree)
            g2 = torch.square(g) + 1e-30
            v = state["v"][name]
            if is_factored_leaf(v):
                r = v["r"].mul_(b2).add_((1 - b2) * g2.mean(-1))
                c = v["c"].mul_(b2).add_((1 - b2) * g2.mean(-2))
                del g2
                rm = r.mean(-1, keepdim=True)
                vh = (r[..., None] * c[..., None, :]) / (rm[..., None] + 1e-30)
            else:
                vh = v.mul_(b2).add_((1 - b2) * g2)
                del g2
            if use_momentum:
                m = state["m"][name]
                num = m.float().mul_(b1).add_((1 - b1) * g)
                m.copy_(num)
                num = num.div_(bc1)
            else:
                num = g
            del g
            # a factored vh is a temporary; an unfactored one is the state
            den = (vh.div_(bc2) if is_factored_leaf(v) else vh / bc2) \
                .sqrt_().add_(eps)
            delta = num.div_(den) if use_momentum else num / den
            del den, num, vh
            if ndims[name] >= 2 and weight_decay:
                delta = delta.add_(weight_decay * p.float())
            p.copy_(p.float() - lr_t * delta)
        return {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init, _spanned(update))
