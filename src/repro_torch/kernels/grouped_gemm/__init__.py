from repro_torch.kernels.grouped_gemm.ops import (  # noqa: F401
    expert_parallel_grouped_gemm, grouped_gemm)
from repro_torch.kernels.grouped_gemm.ref import (  # noqa: F401
    ref_grouped_gemm, ref_grouped_gemm_bwd)
