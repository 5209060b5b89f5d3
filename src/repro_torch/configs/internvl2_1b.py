"""InternVL2-1B [arXiv:2404.16821; hf]. InternViT-300M frontend (STUB:
precomputed patch embeddings, 1024-d) + Qwen2-0.5B LM backbone: 24L,
d=896, 14 heads (GQA kv=2), head_dim=64, QKV bias, tied embeddings."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    rope=True,
    rope_theta=1000000.0,
    qkv_bias=True,
    mlp_act="silu",
    mlp_gated=True,
    tie_embeddings=True,
    modality="vision",
    modality_dim=1024,
    num_modality_tokens=256,
    source="arXiv:2404.16821 (verified: hf)",
))
