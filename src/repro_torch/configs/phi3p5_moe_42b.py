"""Phi-3.5-MoE 42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct; hf].
16 experts, top-2 routing, GQA kv=8, SwiGLU experts."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    rope=True,
    num_experts=16,
    num_experts_per_tok=2,
    mlp_act="silu",
    mlp_gated=True,
    source="hf:microsoft/Phi-3.5-MoE-instruct (verified: hf)",
))
