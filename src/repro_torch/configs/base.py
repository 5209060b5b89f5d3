"""ModelConfig dataclass + architecture registry (``--arch <id>``).

A copy of the reference package's config schema, so a configuration means
the same model in both packages.  The port registers the decoders
(``qwen3-0.6b``, ``qwen2.5-3b``, ``phi3-mini-3.8b``, ``starcoder2-15b``),
the MoE models (``phi3.5-moe-42b``, ``grok-1-314b``), ``mamba2-130m``, the
hybrid ``recurrentgemma-9b``, the vision-prefixed ``internvl2-1b`` and the
encoder-decoder ``seamless-m4t-large-v2``: every configuration the
reference has."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention features ---------------------------------------------
    rope: bool = True
    rope_theta: float = 10000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_window: Optional[int] = None
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None

    # --- mlp ---------------------------------------------------------------
    mlp_act: str = "silu"
    mlp_gated: bool = True
    mlp_bias: bool = False
    block_has_mlp: bool = True

    # --- moe ---------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 1024
    moe_renormalize: bool = True

    # --- hybrid / ssm -------------------------------------------------------
    block_pattern: Tuple[str, ...] = ("attn",)
    rglru_width: int = 0
    conv1d_width: int = 4
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_expand: int = 2
    ssm_chunk: int = 256

    # --- enc-dec ------------------------------------------------------------
    encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # --- modality frontends (stubs) ------------------------------------------
    modality: Optional[str] = None  # None | "vision" | "audio"
    modality_dim: int = 0
    num_modality_tokens: int = 0

    # --- norms / embeddings / dtypes ------------------------------------------
    norm_type: str = "rmsnorm"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"
    logits_dtype: str = "bfloat16"  # CE upcasts to fp32 in-reduction
    remat: bool = True

    # --- provenance ------------------------------------------------------------
    source: str = ""  # citation + verification tier

    # -------------------------------------------------------------------------
    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: no global full-attention block."""
        return all(k in ("rec", "ssm", "local") for k in self.block_pattern)

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (enc-dec included)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hq, hkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        per_kind = {}
        attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
        if self.qkv_bias:
            attn += hq * hd + 2 * hkv * hd
        per_kind["attn"] = per_kind["local"] = attn
        if self.rglru_width:
            w = self.rglru_width
            per_kind["rec"] = 2 * d * w + w * d + 2 * w * w + \
                self.conv1d_width * w + w
        if self.ssm_state:
            d_in = self.ssm_expand * d
            h = d_in // self.ssm_head_dim
            g, n = self.ssm_ngroups, self.ssm_state
            conv_dim = d_in + 2 * g * n
            per_kind["ssm"] = d * (2 * d_in + 2 * g * n + h) + d_in * d + \
                self.conv1d_width * conv_dim + conv_dim + 3 * h + d_in
        if self.num_experts:
            ff = self.num_experts * (2 if not self.mlp_gated else 3) * d * f \
                + d * self.num_experts
        elif self.mlp_gated:
            ff = 3 * d * f
        else:
            ff = 2 * d * f
        total = 0
        for i in range(self.num_layers):
            kind = self.block_pattern[i % len(self.block_pattern)]
            total += per_kind[kind] + (ff if self.block_has_mlp else 0)
        total += v * d  # embed
        if not self.tie_embeddings:
            total += v * d  # head
        if self.encoder_decoder:
            total += self.num_encoder_layers * (per_kind["attn"] + 3 * d * f)
            total += self.num_layers * per_kind["attn"]  # cross-attn
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k of E experts)."""
        if not self.num_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        per_expert = (3 if self.mlp_gated else 2) * d * f
        inactive = self.num_layers * (self.num_experts - self.num_experts_per_tok) \
            * per_expert
        return self.param_count() - inactive


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    return sorted(_REGISTRY)


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test scale: same family/features, tiny dims."""
    pat = cfg.block_pattern
    base = dict(
        num_layers=max(2, 2 * len(pat)),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 4),
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
        moe_group=64,
        rglru_width=64 if cfg.rglru_width else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        attn_window=16 if cfg.attn_window else None,
        num_encoder_layers=2 if cfg.encoder_decoder else 0,
        modality_dim=32 if cfg.modality else 0,
        num_modality_tokens=4 if cfg.modality else 0,
        dtype="float32",
        kv_cache_dtype="float32",
        logits_dtype="float32",
        remat=False,
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
