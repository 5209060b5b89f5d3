"""Phi-3-mini-3.8B [arXiv:2404.14219; unverified]. Dense MHA (kv=32),
head_dim=96 (non-lane-aligned edge case for the GEMM planner), RoPE,
SwiGLU."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    rope=True,
    mlp_act="silu",
    mlp_gated=True,
    source="arXiv:2404.14219 (unverified)",
))
