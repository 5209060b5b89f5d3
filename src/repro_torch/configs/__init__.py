"""Architecture configs (one module per architecture) + registry."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, get_config, list_configs, register, reduced_config)
# Imported for registration.
from repro_torch.configs import (  # noqa: F401
    grok1_314b, internvl2_1b, mamba2_130m, phi3_mini_3p8b, phi3p5_moe_42b,
    qwen2p5_3b, qwen3_0p6b, recurrentgemma_9b, seamless_m4t_large_v2,
    starcoder2_15b)
from repro_torch.configs.shapes import (  # noqa: F401
    SHAPES, input_specs, shape_for)
