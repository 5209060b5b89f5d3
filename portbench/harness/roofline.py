"""The yardstick: published peaks, the least time work can take, and the
operations and bytes each kernel family's work needs, counted from shapes.

Peaks are NVIDIA's data-sheet figures for the H100 SXM5 at its 700 W
limit (dense, without sparsity); the run prints the card's power limit
beside them.  A bound is the larger of operations over the dtype's peak and
bytes over the HBM rate, with each input read once at its own dtype and
each output written once, whatever a kernel reads again (the arithmetic of
``chip_smoke.py::bound``, copied).  Work a call does not need is not
counted: padding rows, the capacity slots no token fills, remat's second
forward, an fp32 recompute.
"""
from __future__ import annotations

import re
from typing import Dict

PEAK_FLOPS = {"bfloat16": 989e12, "float8": 1979e12, "int8": 1979e12,
              "tf32": 494.7e12, "float32": 66.9e12}
HBM_BYTES_PER_S = 3.35e12
PEAK_SOURCE = "NVIDIA H100 SXM5 data sheet, dense, 700 W"

BF16 = 2

# Kernel families by the names the profiler gives the kernels: the port's
# own kernels (kernels/*/csrc) and any library GEMM (cuBLAS / cuBLASLt /
# CUTLASS names) the step launches.
_GEMM = re.compile(r"gemm|nvjet|cutlass|splitkreduce|xmma", re.I)
_GROUPED = re.compile(r"grouped_")
_FLASH = re.compile(r"flash_(fused|dense|bwd)")


def family(kernel_name: str) -> str:
    """"grouped", "flash", "gemm" or "other" for a kernel name."""
    if _GROUPED.search(kernel_name):
        return "grouped"
    if _FLASH.search(kernel_name):
        return "flash"
    if _GEMM.search(kernel_name):
        return "gemm"
    return "other"


def bound_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def gemm_bound_s(m: int, k: int, n: int, *, a_bytes=BF16, b_bytes=BF16,
                 c_bytes=BF16) -> float:
    """One (m, k) x (k, n) product."""
    return bound_s(2.0 * m * k * n,
                   m * k * a_bytes + k * n * b_bytes + m * n * c_bytes)


def linear_maps(cfg: Dict):
    """(k, n, count) of every linear map a token goes through on the
    dense path: the projections and MLP of each layer and the read-out."""
    d, hq, hkv, hd, f = (cfg["d_model"], cfg["num_heads"],
                         cfg["num_kv_heads"], cfg["head_dim"], cfg["d_ff"])
    L = cfg["num_layers"]
    maps = [(d, hq * hd, L), (d, hkv * hd, 2 * L), (hq * hd, d, L)]
    if not cfg["num_experts"]:
        maps += [(d, f, 2 * L), (f, d, L)]
    return maps + [(d, cfg["vocab_size"], 1)]


def linear_train_bound_s(cfg: Dict, tokens: int) -> float:
    """The forward, dX and dW of every linear map and of the read-out over
    ``tokens`` rows, at bf16: three products a map, each bounded alone."""
    total = 0.0
    for k, n, count in linear_maps(cfg):
        fwd = gemm_bound_s(tokens, k, n)          # X W -> Y
        dx = gemm_bound_s(tokens, n, k)           # dY W^T -> dX
        dw = gemm_bound_s(k, tokens, n)           # X^T dY -> dW
        total += count * (fwd + dx + dw)
    return total


def attention_flops_fwd(batch: int, seq: int, heads: int, hd: int) -> float:
    """Causal attention forward, the half square: QK^T and PV."""
    return 2.0 * batch * heads * seq * seq * hd


def attention_train_bound_s(cfg: Dict, batch: int, seq: int) -> float:
    """Causal flash forward and backward of every layer at bf16: the
    backward's five products are 2.5 forwards; the forward reads q, k, v
    and writes o and the fp32 log-sum-exp rows, the backward reads q, k, v,
    o, dO and the rows and writes dq, dk, dv and the fp32 row sums of
    dO * o."""
    hq, hkv, hd, L = (cfg["num_heads"], cfg["num_kv_heads"],
                      cfg["head_dim"], cfg["num_layers"])
    fwd = attention_flops_fwd(batch, seq, hq, hd)
    q = batch * seq * hq * hd * BF16
    kv = batch * seq * hkv * hd * BF16
    lse = batch * hq * seq * 4
    fwd_s = bound_s(fwd, 2 * q + 2 * kv + lse)
    bwd_s = bound_s(2.5 * fwd, 4 * q + 4 * kv + 2 * lse)
    return L * (fwd_s + bwd_s)


def expected_experts_hit(experts: int, top_k: int, tokens: int) -> float:
    """Experts with at least one routed row among ``tokens`` tokens, in
    expectation, under uniform routing (the program does not report its
    routing counts yet)."""
    if tokens <= 0:
        return 0.0
    return experts * (1.0 - (1.0 - top_k / experts) ** tokens)


def expert_bound_s(cfg: Dict, tokens: int) -> float:
    """One MoE forward of ``tokens`` tokens, every layer: the banks (gate,
    up, down) of each expert hit, read once at bf16, and the routed rows in
    and out of the three products; the FLOPs of the routed rows alone."""
    d, f, e, k = (cfg["d_model"], cfg["d_ff"], cfg["num_experts"],
                  cfg["num_experts_per_tok"])
    rows = tokens * k
    hit = expected_experts_hit(e, k, tokens)
    nbytes = 3 * hit * d * f * BF16 + rows * BF16 * (2 * (d + f) + (f + d))
    return cfg["num_layers"] * bound_s(3 * 2.0 * rows * d * f, nbytes)


def dense_params_per_token(cfg: Dict, *, readout: bool = True) -> int:
    """Parameters a token multiplies through (MoE: the top-k experts and
    the router), the embedding lookup excluded."""
    d, hq, hkv, hd, f = (cfg["d_model"], cfg["num_heads"],
                         cfg["num_kv_heads"], cfg["head_dim"], cfg["d_ff"])
    per_layer = 2 * d * hq * hd + 2 * d * hkv * hd
    if cfg["num_experts"]:
        per_layer += cfg["num_experts_per_tok"] * 3 * d * f \
            + d * cfg["num_experts"]
    else:
        per_layer += 3 * d * f
    return cfg["num_layers"] * per_layer + \
        (d * cfg["vocab_size"] if readout else 0)


def train_step_flops(cfg: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of a training step: 3 x (2 x parameters a token + causal
    attention)."""
    fwd = 2.0 * dense_params_per_token(cfg) * batch * seq + cfg["num_layers"] \
        * attention_flops_fwd(batch, seq, cfg["num_heads"], cfg["head_dim"])
    return 3.0 * fwd


def prefill_flops(cfg: Dict, length: int) -> float:
    """A prompt of ``length`` tokens, the read-out at the last only."""
    return 2.0 * (dense_params_per_token(cfg, readout=False) * length
                  + cfg["d_model"] * cfg["vocab_size"]) + cfg["num_layers"] \
        * attention_flops_fwd(1, length, cfg["num_heads"], cfg["head_dim"])


def decode_flops(cfg: Dict, position: int) -> float:
    """One decoded token at ``position``, attending to position + 1 keys."""
    return 2.0 * dense_params_per_token(cfg) + cfg["num_layers"] * 4.0 \
        * (position + 1) * cfg["num_heads"] * cfg["head_dim"]
