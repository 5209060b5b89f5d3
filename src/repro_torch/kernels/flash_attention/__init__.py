from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention, paged_decode_attention)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    ref_attention, ref_flat, ref_paged_decode_attention)
