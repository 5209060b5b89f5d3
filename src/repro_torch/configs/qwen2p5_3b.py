"""Qwen2.5-3B [hf:Qwen/Qwen2.5 family; hf]. Dense GQA kv=2, QKV bias,
SwiGLU, tied embeddings."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    rope=True,
    rope_theta=1000000.0,
    qkv_bias=True,
    mlp_act="silu",
    mlp_gated=True,
    tie_embeddings=True,
    source="hf:Qwen/Qwen2.5-3B (verified: hf)",
))
