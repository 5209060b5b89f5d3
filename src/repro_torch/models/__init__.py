"""The dense decoder built on the engine: every projection calls
``repro_torch.core.matmul``; prefill attention runs the flash kernels
under the ``engine`` backend."""
from repro_torch.models.lm import LanguageModel  # noqa: F401
