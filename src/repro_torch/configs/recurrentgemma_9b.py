"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427; unverified]. 38 blocks,
pattern (rec, rec, local-attn) = 1 local-attention per 2 RG-LRU blocks,
MQA (kv=1), window 2048, GeGLU MLP, embed scaling. Sub-quadratic:
long_500k runs."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    rope=True,
    attn_window=2048,
    block_pattern=("rec", "rec", "local"),
    rglru_width=4096,
    conv1d_width=4,
    mlp_act="gelu",
    mlp_gated=True,
    embed_scale=True,
    source="arXiv:2402.19427 (unverified)",
))
