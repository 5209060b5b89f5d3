"""SeamlessM4T-large-v2 [arXiv:2308.11596; hf]. Encoder-decoder backbone:
24L encoder over audio-frame embeddings (STUB frontend), 24L decoder with
cross-attention; MHA kv=16, GeGLU-free classic MLP per original (gated
kept off), LayerNorm."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    rope=False,  # learned sinusoidal in original; RoPE off for backbone stub
    mlp_act="relu",
    mlp_gated=False,
    norm_type="layernorm",
    norm_eps=1e-5,
    encoder_decoder=True,
    num_encoder_layers=24,
    modality="audio",
    modality_dim=160,
    source="arXiv:2308.11596 (verified: hf)",
))
