from repro_torch.kernels.grouped_gemm.ops import grouped_gemm  # noqa: F401
from repro_torch.kernels.grouped_gemm.ref import (  # noqa: F401
    ref_grouped_gemm, ref_grouped_gemm_bwd)
