"""StarCoder2-15B [arXiv:2402.19173; hf]. Dense GQA + RoPE, non-gated GELU
MLP (d_ff = 4·d), LayerNorm, learned biases on linears."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    rope=True,
    rope_theta=100000.0,
    qkv_bias=True,
    mlp_act="gelu",
    mlp_gated=False,
    mlp_bias=True,
    norm_type="layernorm",
    norm_eps=1e-5,
    source="arXiv:2402.19173; hf (verified: hf)",
))
