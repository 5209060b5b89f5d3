"""The planned small-GEMM engine (paper §IV) for PyTorch on Hopper.

  * ``machine``    -- machine models (``H100_SXM``; ``TPU_V5E`` as data)
  * ``config``     -- process-wide backend / device / machine / fused policy
  * ``descriptor`` -- per-family kernel metadata (libxsmm descriptor analogue)
  * ``blocking``   -- machine-model tile planners (§IV-B)
  * ``schedule``   -- tile tables the fused kernels walk
  * ``jit_cache``  -- LRU plan and kernel registries
  * ``engine``     -- family registry, planning and dispatch
  * ``matmul``     -- the GEMM front door every model layer calls
"""
from repro_torch.core.descriptor import (  # noqa: F401
    FlashBwdDescriptor, FlashDescriptor, GemmDescriptor, KernelDescriptor)
from repro_torch.core.blocking import (  # noqa: F401
    BlockingPlan, FlashPlan, Region, flash_bwd_fused_legal, flash_fused_legal,
    fused_legal, palette, plan_flash, plan_flash_bwd, plan_gemm)
from repro_torch.core.schedule import (  # noqa: F401
    FlashTileSchedule, TileSchedule, flash_tile_schedule, flatten_regions,
    plan_launches)
from repro_torch.core.machine import (  # noqa: F401
    DEFAULT_MACHINE, H100_SXM, MachineModel, TPU_V5E, get_machine)
from repro_torch.core.config import (  # noqa: F401
    EngineConfig, configure, get_config, resolve_device, use)
from repro_torch.core.matmul import matmul  # noqa: F401
from repro_torch.core.jit_cache import (  # noqa: F401
    GLOBAL_KERNEL_CACHE, KernelCache, LruCache)
from repro_torch.core import engine  # noqa: F401
