"""Dense MLP: gated (SwiGLU/GeGLU) or classic two-layer.

The gated path runs the activation inside the gate projection's GEMM
epilogue, as the reference does.
"""
from __future__ import annotations

from torch import nn

from repro_torch.core.machine import torch_dtype
from repro_torch.models.common import Init, Linear


class MLP(nn.Module):
    def __init__(self, cfg, init: Init):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.cfg = cfg
        if cfg.mlp_gated:
            self.w_gate = Linear(d, f, init, bias=cfg.mlp_bias)
        self.w_up = Linear(d, f, init, bias=cfg.mlp_bias)
        self.w_down = Linear(f, d, init, bias=cfg.mlp_bias)

    def forward(self, x):
        dt = torch_dtype(self.cfg.dtype)
        act = self.cfg.mlp_act
        if self.cfg.mlp_gated:
            gate = self.w_gate(x, epilogue=act, compute_dtype=dt)
            h = gate * self.w_up(x, compute_dtype=dt)
        else:
            h = self.w_up(x, epilogue=act, compute_dtype=dt)
        return self.w_down(h, compute_dtype=dt)
