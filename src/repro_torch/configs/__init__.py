"""Architecture configs (one module per architecture) + registry."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, get_config, register, reduced_config)
# Imported for registration.
from repro_torch.configs import (  # noqa: F401
    mamba2_130m, phi3p5_moe_42b, qwen3_0p6b)
