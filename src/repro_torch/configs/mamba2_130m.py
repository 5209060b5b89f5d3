"""Mamba2-130M [arXiv:2405.21060; unverified]. Attention-free SSD
(state-space duality): 24 SSD blocks (no MLP), d=768, expand 2 (d_inner
1536), headdim 64 (24 heads), state 128, chunk 256, conv width 4, tied
embeddings."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=24,       # SSD heads (d_inner/headdim); attention unused
    num_kv_heads=24,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    rope=False,
    block_pattern=("ssm",),
    block_has_mlp=False,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_ngroups=1,
    ssm_expand=2,
    ssm_chunk=256,
    conv1d_width=4,
    tie_embeddings=True,
    source="arXiv:2405.21060 (unverified)",
))
