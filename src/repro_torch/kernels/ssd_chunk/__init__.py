from repro_torch.kernels.ssd_chunk.ops import (  # noqa: F401
    ssd_chunk_diag, ssd_chunk_scan)
from repro_torch.kernels.ssd_chunk.ref import (  # noqa: F401
    ref_ssd_chunk_diag, ref_ssd_chunk_scan, ref_ssd_chunk_scan_bwd)
