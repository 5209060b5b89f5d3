from repro_torch.kernels.gemm.ops import gemm  # noqa: F401
from repro_torch.kernels.gemm.ref import ref_gemm  # noqa: F401
