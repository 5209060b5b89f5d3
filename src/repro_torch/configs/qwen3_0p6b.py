"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family; hf]. Dense GQA with qk-norm,
head_dim=128 (projection width != d_model), SwiGLU, tied embeddings."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    rope=True,
    rope_theta=1000000.0,
    qk_norm=True,
    mlp_act="silu",
    mlp_gated=True,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-0.6B (verified: hf)",
))
