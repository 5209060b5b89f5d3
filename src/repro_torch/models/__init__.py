"""The models built on the engine: every projection calls
``repro_torch.core.matmul``; prefill attention runs the flash kernels
under the ``engine`` backend.  ``LanguageModel`` is the decoder-only
model (with an optional vision prefix), ``EncoderDecoderModel`` the
encoder-decoder."""
from repro_torch.models.encdec import EncoderDecoderModel  # noqa: F401
from repro_torch.models.lm import LanguageModel  # noqa: F401
