"""The decoder in plain float32 PyTorch.

The model the configuration file states: token embedding; per layer
RMSNorm -> attention (RoPE half-split, causal, grouped KV heads, scale
head_dim^-0.5) -> residual, RMSNorm -> gated SiLU MLP or a mixture of
experts -> residual; final RMSNorm; untied read-out.  The mixture of experts
routes in float32 (softmax, top-k with ties to the lower index, the k gates
renormalised over their sum + 1e-9) with GShard capacity: the tokens of one
call form groups of ``g`` consecutive tokens, ``g`` the largest divisor of
the call's token count not above ``min(moe_group, tokens // 32)`` (at least
1); an expert takes at most ``max(8, ceil8(int(capacity_factor * g * k /
E)))`` of a group's choices, every first choice before any second; a choice
past that passes through the residual only.

``fp8=True`` is the control: every product of a linear map takes its
operands rounded to float8 e4m3 (the weight with one scale a tensor, the
activations one a row), accumulating in float32 -- the precision below the
configuration's bfloat16.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

E4M3_MAX = 448.0
QUERY_BLOCK = 1024


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _Fp8(torch.autograd.Function):
    """Round to e4m3 at a scale that maps ``dims``' absmax to its largest
    value; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x, per_row: bool):
        amax = x.detach().abs().amax(dim=-1, keepdim=True) if per_row \
            else x.detach().abs().amax()
        scale = E4M3_MAX / torch.clamp(amax, min=1e-30)
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g, None


def linear(x, w, fp8: bool):
    """``x @ w`` in float32; with ``fp8`` both operands rounded first."""
    if fp8:
        x = _Fp8.apply(x, True)
        w = _Fp8.apply(w, False)
    return x @ w


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, theta: float):
    """x: (s, h, hd); positions: (s,)."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = positions.float()[:, None] * inv
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(h, W: Dict, p: str, cfg: Dict, fp8: bool):
    """Causal self-attention over one sequence h: (s, d)."""
    s = h.shape[0]
    hq, hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    pos = torch.arange(s, device=h.device)
    q = rope(linear(h, W[p + "mixer.wq.w"], fp8).reshape(s, hq, hd), pos,
             cfg["rope_theta"])
    k = rope(linear(h, W[p + "mixer.wk.w"], fp8).reshape(s, hkv, hd), pos,
             cfg["rope_theta"])
    v = linear(h, W[p + "mixer.wv.w"], fp8).reshape(s, hkv, hd)
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)   # (hq, s, hd)
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    q = q.transpose(0, 1)
    outs = []
    for q0 in range(0, s, QUERY_BLOCK):
        q1 = min(s, q0 + QUERY_BLOCK)
        scores = q[:, q0:q1] @ k[:, :q1].transpose(1, 2) * hd ** -0.5
        mask = torch.arange(q1, device=h.device)[None, :] \
            <= torch.arange(q0, q1, device=h.device)[:, None]
        scores = scores.masked_fill(~mask, float("-inf"))
        outs.append(torch.softmax(scores, dim=-1) @ v[:, :q1])
    o = torch.cat(outs, dim=1).transpose(0, 1).reshape(s, hq * hd)
    return linear(o, W[p + "mixer.wo.w"], fp8)


def mlp(h, W: Dict, p: str, fp8: bool):
    gate = torch.nn.functional.silu(linear(h, W[p + "ff.w_gate.w"], fp8))
    return linear(gate * linear(h, W[p + "ff.w_up.w"], fp8),
                  W[p + "ff.w_down.w"], fp8)


def capacity_groups(tokens: int, cfg: Dict):
    """(group size, capacity) of one call of ``tokens`` tokens."""
    g = max(1, min(cfg["moe_group"], tokens // 32))
    while tokens % g:
        g -= 1
    k, e = cfg["num_experts_per_tok"], cfg["num_experts"]
    cap = int(cfg["capacity_factor"] * g * k / e)
    return g, max(8, -(-cap // 8) * 8)


def route(h, W: Dict, p: str, cfg: Dict):
    """(expert ids (s, k), renormalised gates (s, k)) in float32."""
    probs = torch.softmax(h @ W[p + "ff.router.w"], dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg["num_experts_per_tok"]
    vals, idx = vals[:, :k], idx[:, :k]
    if cfg["moe_renormalize"]:
        vals = vals / (vals.sum(-1, keepdim=True) + 1e-9)
    return idx, vals


def kept(idx, tokens: int, cfg: Dict):
    """(s, k) bool: which choices the capacity keeps, the s tokens being one
    call."""
    g, cap = capacity_groups(tokens, cfg)
    s, k = idx.shape
    e = cfg["num_experts"]
    onehot = torch.nn.functional.one_hot(idx, e).reshape(s // g, g, k, e)
    order = onehot.transpose(1, 2).reshape(s // g, k * g, e)  # firsts first
    seen = torch.cumsum(order, dim=1) - 1
    pos = (seen * order).sum(-1).reshape(s // g, k, g).transpose(1, 2)
    return (pos < cap).reshape(s, k)


def moe(h, W: Dict, p: str, cfg: Dict, fp8: bool, prompt_len: int,
        decode_call_tokens: int):
    """Positions below ``prompt_len`` were one prefill call and keep the
    capacity of that call; each later position was one token of a decode
    call over ``decode_call_tokens`` slots, whose capacity cannot bind
    (checked)."""
    idx, gates = route(h, W, p, cfg)
    keep = torch.ones_like(idx, dtype=torch.bool)
    if prompt_len:
        keep[:prompt_len] = kept(idx[:prompt_len], prompt_len, cfg)
    if h.shape[0] > prompt_len:
        g, cap = capacity_groups(decode_call_tokens, cfg)
        if g * cfg["num_experts_per_tok"] > cap:
            raise ValueError(f"a decode call of {decode_call_tokens} tokens "
                             f"can drop choices (group {g}, capacity {cap}): "
                             f"the reference cannot follow it alone")
    gates = gates * keep
    y = torch.zeros_like(h)
    wg, wu, wd = W[p + "ff.w_gate.w"], W[p + "ff.w_up.w"], W[p + "ff.w_down.w"]
    for e in range(cfg["num_experts"]):
        rows, slot = torch.nonzero((idx == e) & keep, as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        out = linear(torch.nn.functional.silu(linear(x, wg[e], fp8))
                     * linear(x, wu[e], fp8), wd[e], fp8)
        y.index_add_(0, rows, out * gates[rows, slot][:, None])
    return y


def block(x, W: Dict, i: int, cfg: Dict, fp8: bool, prompt_len: int = 0,
          decode_call_tokens: int = 0):
    p = f"blocks.{i}."
    eps = cfg["norm_eps"]
    x = x + attention(rmsnorm(x, W[p + "norm_mix.scale"], eps), W, p, cfg,
                      fp8)
    h = rmsnorm(x, W[p + "norm_ff.scale"], eps)
    if cfg["num_experts"]:
        return x + moe(h, W, p, cfg, fp8, prompt_len, decode_call_tokens)
    return x + mlp(h, W, p, fp8)


def served_logits(cfg: Dict, weights, seqs: List[torch.Tensor],
                  prompt_lens: List[int], decode_call_tokens: int,
                  fp8: bool = False) -> List[torch.Tensor]:
    """The logits at every position from the last prompt token on, of each
    sequence (prompt + served tokens but the last), layer by layer over all
    sequences: ``weights(names)`` gives a dict of float32 leaves, drawn
    when asked, so one layer's weights are held at a time."""
    no_tf32()
    with torch.no_grad():
        outer = weights(["embed.table"])
        xs = [outer["embed.table"][t] for t in seqs]
        del outer
        for i in range(cfg["num_layers"]):
            W = weights(layer_names(cfg, i))
            xs = [block(x, W, i, cfg, fp8, L, decode_call_tokens)
                  for x, L in zip(xs, prompt_lens)]
            del W
        W = weights(["final_norm.scale", "lm_head.w"])
        return [linear(rmsnorm(x[L - 1:], W["final_norm.scale"],
                               cfg["norm_eps"]), W["lm_head.w"], fp8)
                for x, L in zip(xs, prompt_lens)]


def layer_names(cfg: Dict, i: int) -> List[str]:
    from harness.weights import layer_leaves
    return [leaf[0] for leaf in layer_leaves(cfg, i)]


def logit_gaps(ref: torch.Tensor, tokens: torch.Tensor,
               control: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per position, how far the chosen token's reference logit lies below
    the reference's best: the chosen token is the served one, or with
    ``control`` the control's first."""
    chosen = tokens if control is None else control.argmax(-1)
    return ref.max(-1).values - ref.gather(-1, chosen[:, None])[:, 0]
