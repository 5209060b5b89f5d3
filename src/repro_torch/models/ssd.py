"""Mamba-2 SSD (state-space duality) layer, chunked algorithm
(arXiv:2405.21060 §6).

Layer structure (a Mamba-2 block's mixer):

    in_proj -> [z | x | B | C | dt];  conv1d + silu over [x | B | C];
    SSD(x, dt, A, B, C) + D·x;  RMSNorm(y ⊙ silu(z));  out_proj

Under the ``engine`` backend the whole chunked scan of a prefill or a
training forward is ONE dispatch of the ``ssd_chunk`` family's scan form
(each (batch, head) pair a group, the (p, n) state carried across the
chunk walk inside the kernel), and training differentiates it through
the family's reverse-walk kernel.  The ``torch`` backend is the einsum
composition with the inter-chunk recurrence as a chunk loop (the
reference's ``backend="xla"`` runs an associative scan).  Decode is the
single recurrent step in plain torch, as in the reference, which has no
kernel for it.  Decode carries (conv tail, S[h, p, n]): O(1) state in the
sequence length.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.config import get_config
from repro_torch.core.machine import torch_dtype
from repro_torch.models.common import Init, Linear, RMSNorm, rmsnorm


class SSMState(NamedTuple):
    conv: torch.Tensor  # (b, cw-1, conv_dim)
    s: torch.Tensor     # (b, h, p, n) fp32


def ssd_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    h = d_in // cfg.ssm_head_dim
    return d_in, h, cfg.ssm_ngroups, cfg.ssm_state


def _einsum(eq: str, *ops) -> torch.Tensor:
    """``jnp.einsum``'s dtype rule: operands promote to one dtype, which is
    the result's (torch's einsum wants them equal)."""
    dt = ops[0].dtype
    for t in ops[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(eq, *(t.to(dt) for t in ops))


def _segsum(x):
    """log-decay lower-triangular matrix: out[..., i, j] = sum_{j<k<=i} x[k]."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -math.inf)


def _ssd_chunked(x, dt, a, b_mat, c_mat, chunk, s0=None):
    """Chunked SSD scan.

    x: (b, s, h, p); dt: (b, s, h) (post-softplus, fp32); a: (h,) negative;
    b_mat/c_mat: (b, s, g, n); s0: optional initial state (b, h, p, n).
    Returns y: (b, s, h, p), final state (b, h, p, n) fp32.
    """
    bsz, s_orig, h, p = x.shape
    g, n = b_mat.shape[-2], b_mat.shape[-1]
    pad = (-s_orig) % chunk
    if pad:
        # dt = 0 on padded steps => decay 1 and zero input: state-exact.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    s = s_orig + pad
    nc = s // chunk
    rep = h // g

    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b_mat.reshape(bsz, nc, chunk, g, n)
    cc = c_mat.reshape(bsz, nc, chunk, g, n)

    da = dtc * a[None, None, None, :]               # (b, nc, Q, h) log-decay
    da_cs = torch.cumsum(da, dim=2)                 # within-chunk cumsum
    da_tot = da_cs[:, :, -1]                        # (b, nc, h)

    L = torch.exp(_segsum(da.permute(0, 1, 3, 2)))  # (b, nc, h, Q, Q)
    xdt = xc * dtc[..., None]                       # (b, nc, Q, h, p)
    if get_config().backend == "engine":
        # ONE dispatch of the scan form: the intra-chunk ladder and the
        # inter-chunk recurrence, each (batch, head) pair a group.
        from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
        gdim = bsz * h
        cg = cc.repeat_interleave(rep, dim=3).permute(0, 3, 1, 2, 4) \
            .reshape(gdim, nc, chunk, n)
        bg = bc.repeat_interleave(rep, dim=3).permute(0, 3, 1, 2, 4) \
            .reshape(gdim, nc, chunk, n)
        lg = L.permute(0, 2, 1, 3, 4).reshape(gdim, nc, chunk, chunk)
        xg = xdt.permute(0, 3, 1, 2, 4).reshape(gdim, nc, chunk, p)
        di = torch.exp(da_cs).permute(0, 3, 1, 2).reshape(gdim, nc, chunk)
        do = torch.exp(da_tot[:, :, None] - da_cs) \
            .permute(0, 3, 1, 2).reshape(gdim, nc, chunk)
        s0g = torch.zeros((gdim, p, n), dtype=torch.float32, device=x.device) \
            if s0 is None else s0.float().reshape(gdim, p, n)
        yg, s_fin = ssd_chunk_scan(cg, bg, lg, xg, di, do, s0g)
        y = yg.reshape(bsz, h, nc, chunk, p).permute(0, 2, 3, 1, 4) \
            .reshape(bsz, s, h, p)
        return y[:, :s_orig], s_fin.reshape(bsz, h, p, n)

    # scores: C_i · B_j over the state dim, groups broadcast to heads
    cb = _einsum("bnqgd,bnkgd->bngqk", cc, bc)      # (b, nc, g, Q, Q)
    cb = cb.repeat_interleave(rep, dim=2)           # (b, nc, h, Q, Q)
    w = cb * L
    y_diag = _einsum("bnhqk,bnkhp->bnqhp", w.to(x.dtype), xdt)

    # chunk states
    decay_out = torch.exp(da_tot[..., None] - da_cs.permute(0, 1, 3, 2))
    bfull = bc.repeat_interleave(rep, dim=3)        # (b, nc, Q, h, n)
    bx = _einsum("bnqhd,bnqhp->bnhpd", bfull,
                 (xdt * decay_out.permute(0, 1, 3, 2)[..., None]).to(x.dtype))

    # inter-chunk recurrence, chunk by chunk
    dec = torch.exp(da_tot).float()                 # (b, nc, h)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                        device=x.device) if s0 is None else s0.float()
    s_prev = []
    for ci in range(nc):
        s_prev.append(state)
        state = state * dec[:, ci, :, None, None] + bx[:, ci].float()
    s_prev = torch.stack(s_prev, dim=1)             # (b, nc, h, p, n)

    # inter-chunk contribution
    decay_in = torch.exp(da_cs)                     # (b, nc, Q, h)
    cfull = cc.repeat_interleave(rep, dim=3)        # (b, nc, Q, h, n)
    y_off = _einsum("bnqhd,bnhpd->bnqhp", cfull, s_prev.to(x.dtype)) \
        * decay_in[..., None].to(x.dtype)

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y[:, :s_orig], state


class SSD(nn.Module):
    """The Mamba-2 mixer.  Its constructor is the reference's ``ssd_init``
    (seeded draws with the reference's distributions: ``A_log = log(1..h)``,
    ``D = 1``, ``dt_bias`` the inverse softplus of a log-uniform dt in
    [0.001, 0.1]); its forward is ``ssd_apply``."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        d_in, h, g, n = ssd_dims(cfg)
        conv_dim = d_in + 2 * g * n
        proj_dim = 2 * d_in + 2 * g * n + h
        dev = init.device
        self.in_proj = Linear(d, proj_dim, init)
        self.out_proj = Linear(d_in, d, init)
        self.conv_w = nn.Parameter(init.normal((cfg.conv1d_width, conv_dim),
                                               0.02))
        self.conv_b = nn.Parameter(torch.zeros(conv_dim, device=dev))
        self.A_log = nn.Parameter(torch.log(torch.arange(
            1, h + 1, dtype=torch.float32, device=dev)))
        self.D = nn.Parameter(torch.ones(h, device=dev))
        dt = torch.exp(init.uniform((h,), math.log(0.001), math.log(0.1)))
        self.dt_bias = nn.Parameter(dt + torch.log(-torch.expm1(-dt)))
        self.norm = RMSNorm(d_in, init)

    def forward(self, x, *, state: Optional[SSMState] = None):
        """x: (b, s, d) -> (y, new_state).  With a state and s == 1 this is
        a decode step."""
        cfg = self.cfg
        dt_ = torch_dtype(cfg.dtype)
        bsz, s, _ = x.shape
        d_in, h, g, n = ssd_dims(cfg)
        p = cfg.ssm_head_dim

        zxbcdt = self.in_proj(x, compute_dtype=dt_)
        z, xs, bb, cc, dt_raw = torch.split(
            zxbcdt, [d_in, d_in, g * n, g * n, h], dim=-1)

        conv_in = torch.cat([xs, bb, cc], dim=-1)
        cw = self.conv_w.shape[0]
        tail = state.conv if state is not None else torch.zeros(
            (bsz, cw - 1, conv_in.shape[-1]), dtype=conv_in.dtype,
            device=x.device)
        xp = torch.cat([tail.to(conv_in.dtype), conv_in], dim=1)
        conv_out = sum(xp[:, i:i + s] * self.conv_w[i].to(conv_in.dtype)
                       for i in range(cw))
        conv_out = F.silu(conv_out + self.conv_b.to(conv_in.dtype))
        new_tail = xp[:, -(cw - 1):]

        xs, bb, cc = torch.split(conv_out, [d_in, g * n, g * n], dim=-1)
        xs = xs.reshape(bsz, s, h, p)
        bb = bb.reshape(bsz, s, g, n)
        cc = cc.reshape(bsz, s, g, n)
        # jax.nn.softplus is logaddexp(x, 0)
        v = dt_raw.float() + self.dt_bias
        dt = torch.clamp(torch.logaddexp(v, torch.zeros_like(v)), 0.0, 10.0)
        a = -torch.exp(self.A_log)  # (h,) negative

        if s == 1 and state is not None:
            # decode: a single recurrent step
            da = torch.exp(dt[:, 0] * a[None, :])  # (b, h)
            bx = torch.einsum(
                "bgd,bhp->bhpd", bb[:, 0].float(),
                (xs[:, 0] * dt[:, 0, :, None].to(xs.dtype)).float())
            s_new = state.s * da[..., None, None] + bx
            cfull = cc[:, 0].repeat_interleave(h // g, dim=1)  # (b, h, n)
            y = torch.einsum("bhd,bhpd->bhp", cfull.float(), s_new)
            y = y[:, None].to(dt_)  # (b, 1, h, p)
            final_state = s_new
        else:
            s0 = state.s if state is not None else None
            y, final_state = _ssd_chunked(xs, dt, a, bb, cc, cfg.ssm_chunk,
                                          s0)

        y = y + xs * self.D.to(dt_)[None, None, :, None]
        y = y.reshape(bsz, s, d_in)
        y = rmsnorm(self.norm.scale, y * F.silu(z), cfg.norm_eps)
        out = self.out_proj(y, compute_dtype=dt_)
        return out, SSMState(conv=new_tail, s=final_state.float())


def init_ssm_state(batch, cfg, device) -> SSMState:
    """Zero decode state; the conv tail starts in bf16 whatever
    ``cfg.dtype`` is, as in the reference."""
    d_in, h, g, n = ssd_dims(cfg)
    conv_dim = d_in + 2 * g * n
    return SSMState(
        conv=torch.zeros((batch, cfg.conv1d_width - 1, conv_dim),
                         dtype=torch.bfloat16, device=device),
        s=torch.zeros((batch, h, cfg.ssm_head_dim, n), dtype=torch.float32,
                      device=device),
    )
