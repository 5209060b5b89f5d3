from repro_torch.kernels.transpose.ops import transpose  # noqa: F401
from repro_torch.kernels.transpose.ref import ref_transpose  # noqa: F401
