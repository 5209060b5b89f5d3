"""PyTorch/CUDA port of the planned small-GEMM engine and the dense
decoder built on it, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports neither
it nor JAX.  Entry points run on the card unless the caller passes
``device="cpu"`` (or configures it), where every kernel wrapper runs its
plain torch version instead.
"""
from repro_torch.core import (  # noqa: F401
    EngineConfig, configure, engine, get_config, matmul, use)
