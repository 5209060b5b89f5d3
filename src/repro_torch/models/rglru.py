"""Real-Gated Linear Recurrent Unit (RG-LRU) block from Griffin
(arXiv:2402.19427), used by recurrentgemma.

Block structure (one "recurrent block"):

    x - lin_y - gelu ----------------------.
    x - lin_x - conv1d(4) - RG-LRU - (*) --'- lin_out

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)        recurrence gate
    i_t = sigmoid(W_x x_t + b_x)        input gate
    a_t = a^(c r_t),  a = sigmoid(L)    (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

The five projections go through ``repro_torch.core.matmul`` (``lin_y``
with its bias and gelu in the GEMM epilogue).  A prefill or a training
forward runs the recurrence as a log-depth scan in plain torch
(:func:`_rglru_scan`, the reference's ``lax.associative_scan``, which no
kernel replaces: the same code on the CPU and on the card); decode is one
step on the carried state.  The state is O(width): (h, conv tail).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.core.machine import torch_dtype
from repro_torch.models.common import Init, Linear
from repro_torch.runtime.shardlib import shard_activation

_C = 8.0
_MIN_LOG = -8.0


class RecurrentState(NamedTuple):
    h: torch.Tensor     # (b, width) fp32 recurrent state
    conv: torch.Tensor  # (b, conv_width - 1, width) conv tail


def init_recurrent_state(batch, cfg, device) -> RecurrentState:
    """Zero decode state; the conv tail starts in bf16 whatever
    ``cfg.dtype`` is, as in the reference."""
    w = cfg.rglru_width
    return RecurrentState(
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv1d_width - 1, w),
                         dtype=torch.bfloat16, device=device))


def _causal_conv1d(x, w, b, tail: Optional[torch.Tensor]):
    """Depthwise causal conv. x: (b, s, w); w: (cw, w); tail: (b, cw-1, w).
    The taps are summed in the reference's order, ``0 + t0 + t1 + ...``,
    in ``x``'s dtype.  Returns (out, new tail)."""
    cw, s = w.shape[0], x.shape[1]
    if tail is None:
        tail = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + s] * w[i].to(x.dtype) for i in range(cw))
    new_tail = xp[:, -(cw - 1):] if cw > 1 else tail
    return out + b.to(x.dtype), new_tail


def _interleave(even, odd):
    """[even0, odd0, even1, odd1, ...] along axis 1 (``even`` as long as
    ``odd`` or one longer)."""
    m = odd.shape[1]
    out = torch.stack([even[:, :m], odd], dim=2).flatten(1, 2)
    return out if even.shape[1] == m else torch.cat([out, even[:, m:]], 1)


def _scan(a, b):
    """Inclusive scan of ``(a, b)`` pairs along axis 1 under ``combine(l,
    r) = (a_l a_r, a_r b_l + b_r)``, with ``lax.associative_scan``'s
    recursion (pairs reduced, the half-length scan, the even elements
    filled in), so the fp32 products and sums are the reference's."""
    n = a.shape[1]
    if n < 2:
        return a, b
    al, bl, ar, br = a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = _scan(al * ar, ar * bl + br)
    a2, b2 = a[:, 2::2], b[:, 2::2]
    if n % 2 == 0:
        pa, pb = odd_a[:, :-1], odd_b[:, :-1]
    else:
        pa, pb = odd_a, odd_b
    even_a = torch.cat([a[:, :1], pa * a2], dim=1)
    even_b = torch.cat([b[:, :1], a2 * pb + b2], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def _rglru_scan(xs, a_log_t, h0):
    """``h_t = a_t h_{t-1} + b_t`` over time (axis 1) by a log-depth scan.

    xs/b: (b, s, w) fp32; a_log_t: log(a_t); h0: (b, w) or None, folded
    into ``b_0`` first."""
    a_t = torch.exp(a_log_t)
    b_t = xs
    if h0 is not None:
        b_t = torch.cat([b_t[:, :1] + a_t[:, :1] * h0[:, None], b_t[:, 1:]],
                        dim=1)
    return _scan(a_t, b_t)[1]


class RGLRU(nn.Module):
    """The recurrent mixer.  Its constructor is the reference's
    ``rglru_init`` (seeded draws with the reference's distributions: ``L``
    from ``u ~ U(0.9^2, 0.999^2)`` as ``log(u^(1/c) / (1 - u^(1/c)))``, so
    that ``sigmoid(L)^c = u``); its forward is
    ``rglru_apply``.  ``lambda`` is a Python keyword: the parameter is
    registered under that name (the reference's leaf name) and read as
    :attr:`lam`."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        self.cfg = cfg
        d, w = cfg.d_model, cfg.rglru_width
        self.lin_y = Linear(d, w, init, bias=True)
        self.lin_x = Linear(d, w, init, bias=True)
        self.lin_out = Linear(w, d, init, bias=True)
        self.conv_w = nn.Parameter(init.normal((cfg.conv1d_width, w), 0.02))
        self.conv_b = nn.Parameter(torch.zeros(w, device=init.device))
        self.gate_a = Linear(w, w, init, bias=True)
        self.gate_x = Linear(w, w, init, bias=True)
        u = init.uniform((w,), 0.9 ** 2, 0.999 ** 2) ** (1.0 / _C)
        self.register_parameter("lambda", nn.Parameter(torch.log(u / (1 - u))))

    @property
    def lam(self) -> torch.Tensor:
        return getattr(self, "lambda")

    def forward(self, x, *, state: Optional[RecurrentState] = None):
        """x: (b, s, d) -> (y, new_state).  With a state and s == 1 this
        is a decode step."""
        dt = torch_dtype(self.cfg.dtype)
        s = x.shape[1]
        y_branch = self.lin_y(x, epilogue="gelu", compute_dtype=dt)
        xb = self.lin_x(x, compute_dtype=dt)
        # The reference's width-parallel region: post-gate activations on
        # "model" along the width (xb stays whole: the gates contract it).
        wspec = (("pod", "data"), None, "model")
        y_branch = shard_activation(y_branch, wspec)
        xb, new_tail = _causal_conv1d(xb, self.conv_w, self.conv_b,
                                      state.conv if state is not None
                                      else None)
        # The gate projections read the bf16 conv output; only their
        # outputs are upcast for the recurrence math (as the reference).
        r = torch.sigmoid(self.gate_a(xb, compute_dtype=dt).float())
        i = torch.sigmoid(self.gate_x(xb, compute_dtype=dt).float())
        r = shard_activation(r, wspec)
        i = shard_activation(i, wspec)
        lam = self.lam
        # log sigmoid(L) = -softplus(-L); jax.nn.softplus is logaddexp(x, 0)
        log_a1 = -torch.logaddexp(-lam, torch.zeros_like(lam))
        log_at = torch.clamp_min(_C * r * log_a1[None, None, :], _MIN_LOG)
        gated = i * xb.float()
        mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_at),
                                          1e-12))
        bt = shard_activation(mult * gated, wspec)

        h0 = state.h if state is not None else None
        if s == 1 and h0 is not None:
            h = (torch.exp(log_at[:, 0]) * h0 + bt[:, 0])[:, None]
        else:
            h = _rglru_scan(bt, log_at, h0)
        new_state = RecurrentState(h=h[:, -1].float(), conv=new_tail)
        out = h.to(dt) * y_branch
        return self.lin_out(out, compute_dtype=dt), new_state
