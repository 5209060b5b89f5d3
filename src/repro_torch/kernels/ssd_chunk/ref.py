"""Oracles for the SSD intra-chunk ladder, the carried-state scan and its
backward (transliterations of the reference's ``ssd_chunk/ref.py`` and,
for the backward, of its kernel's reverse-walk body).

Rounding points are the reference's: the decay-weighted scores ``w`` are
rounded to xdt's dtype before the second product, the diag output to
xdt's dtype before the inter-chunk term is added, and ``xdt * decay_out``
to xdt's dtype before the state product.  Products accumulate in fp32
(bf16 operands are widened first: their products are exact in fp32).
"""
from __future__ import annotations

import torch


def ref_ssd_chunk_diag(c_mat, b_mat, l_mat, xdt) -> torch.Tensor:
    """y = (C·Bᵀ ∘ L) · xdt, batched over the leading dim.

    c_mat/b_mat: (G, Q, n); l_mat: (G, Q, Q); xdt: (G, Q, p) -> (G, Q, p).
    """
    scores = torch.einsum("gqn,gkn->gqk", c_mat.float(), b_mat.float())
    w = scores * l_mat.float()
    return torch.einsum("gqk,gkp->gqp", w.to(xdt.dtype).float(),
                        xdt.float()).to(xdt.dtype)


def ref_ssd_chunk_scan(c_mat, b_mat, l_mat, xdt, decay_in, decay_out, s0):
    """Sequential-recurrence oracle for the carried-state chunked scan.

    ``c_mat``/``b_mat``: (G, NC, Q, n); ``l_mat``: (G, NC, Q, Q); ``xdt``:
    (G, NC, Q, p); ``decay_in``/``decay_out``: (G, NC, Q) fp32; ``s0``:
    (G, p, n) fp32.  Walks the chunks one by one -> ``(y (G, NC, Q, p) in
    xdt's dtype, s_final (G, p, n) fp32)``.  Differentiable by autograd.
    """
    g, nc, q, n = c_mat.shape
    p = xdt.shape[-1]
    y_diag = ref_ssd_chunk_diag(
        c_mat.reshape(g * nc, q, n), b_mat.reshape(g * nc, q, n),
        l_mat.reshape(g * nc, q, q),
        xdt.reshape(g * nc, q, p)).reshape(g, nc, q, p)
    state = s0.float()
    ys = []
    for ci in range(nc):
        y_off = torch.einsum("gqn,gpn->gqp", c_mat[:, ci].float(), state) \
            * decay_in[:, ci, :, None]
        ys.append((y_diag[:, ci].float() + y_off).to(xdt.dtype))
        xw = (xdt[:, ci].float() * decay_out[:, ci, :, None]).to(xdt.dtype)
        bx = torch.einsum("gqp,gqn->gpn", xw.float(), b_mat[:, ci].float())
        state = state * decay_in[:, ci, -1][:, None, None] + bx
    return torch.stack(ys, dim=1), state


def ref_ssd_chunk_scan_bwd(c_mat, b_mat, l_mat, xdt, decay_in, decay_out,
                           states, dy, dsf):
    """Reverse-walk oracle of the scan's backward (the plain version of
    the ``ssd_scan_bwd`` kernel).

    ``states``: (G, NC, p, n) fp32, the state entering each chunk as the
    forward walked it; ``dy``: (G, NC, Q, p) and ``dsf``: (G, p, n) the
    output cotangents.  Walks chunks last to first with the state
    cotangent carried, recomputing each chunk's scores, in fp32 without
    the forward's rounding points (as the reference's backward kernel) ->
    fp32 ``(dC, dB, dL, dxdt, d_decay_in, d_decay_out, ds0)``.
    """
    g, nc, q, n = c_mat.shape
    c_all, b_all, l_all, x_all = (t.float() for t in (c_mat, b_mat, l_mat,
                                                       xdt))
    dy_all = dy.float()
    dc, db = torch.empty_like(c_all), torch.empty_like(b_all)
    dl, dx = torch.empty_like(l_all), torch.empty_like(x_all)
    ddi = torch.empty_like(decay_in, dtype=torch.float32)
    ddo = torch.empty_like(ddi)
    ds = dsf.float()
    for ci in reversed(range(nc)):
        c, b, l, x = (t[:, ci] for t in (c_all, b_all, l_all, x_all))
        di, do = decay_in[:, ci].float(), decay_out[:, ci].float()
        s_in, dyc = states[:, ci].float(), dy_all[:, ci]
        # S_out = S_in * di[Q-1] + Bᵀ(x ⊙ do): the carried cotangent splits
        # into the decay leg and the Bx leg.
        ds_in = ds * di[:, -1, None, None]
        ddi_last = (s_in * ds).sum((1, 2))
        dxw = torch.einsum("gqn,gpn->gqp", b, ds)
        xw = x * do[..., None]
        dbc = torch.einsum("gqp,gpn->gqn", xw, ds)
        dxc = dxw * do[..., None]
        ddo[:, ci] = (dxw * x).sum(-1)
        # y = (scores ⊙ L) · x, backward from recomputed scores.
        scores = torch.einsum("gqn,gkn->gqk", c, b)
        w = scores * l
        dw = torch.einsum("gqp,gkp->gqk", dyc, x)
        dxc = dxc + torch.einsum("gqk,gqp->gkp", w, dyc)
        dscores = dw * l
        dl[:, ci] = dw * scores
        dcc = torch.einsum("gqk,gkn->gqn", dscores, b)
        dbc = dbc + torch.einsum("gqk,gqn->gkn", dscores, c)
        # y_off = (C · S_inᵀ) ⊙ di, backward.
        a = dyc * di[..., None]
        y_off_raw = torch.einsum("gqn,gpn->gqp", c, s_in)
        dcc = dcc + torch.einsum("gqp,gpn->gqn", a, s_in)
        ds = ds_in + torch.einsum("gqp,gqn->gpn", a, c)
        ddic = (dyc * y_off_raw).sum(-1)
        ddic[:, -1] += ddi_last
        ddi[:, ci] = ddic
        dc[:, ci], db[:, ci], dx[:, ci] = dcc, dbc, dxc
    return dc, db, dl, dx, ddi, ddo, ds
