"""Grok-1 314B [hf:xai-org/grok-1; unverified]. 8 experts top-2, GQA kv=8,
attention/final logit softcaps (30.0), embed scaling."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    rope=True,
    attn_logit_softcap=30.0,
    final_logit_softcap=30.0,
    embed_scale=True,
    num_experts=8,
    num_experts_per_tok=2,
    mlp_act="gelu",
    mlp_gated=True,
    source="hf:xai-org/grok-1 (unverified)",
))
