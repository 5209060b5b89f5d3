"""The planned small-GEMM engine (paper §IV) for PyTorch on Hopper.

  * ``machine``    -- machine models (``H100_SXM``; ``TPU_V5E`` as data)
  * ``config``     -- process-wide backend / device / machine / fused policy
  * ``descriptor`` -- per-family kernel metadata (libxsmm descriptor analogue)
  * ``blocking``   -- machine-model tile planners (§IV-B)
  * ``schedule``   -- tile tables the fused kernels walk
  * ``jit_cache``  -- LRU plan and kernel registries
  * ``engine``     -- family registry, three-tier planning, dispatch, warmup
  * ``autotune``   -- candidate timing and the persistent tuning cache
  * ``warmstart``  -- descriptor manifests and zero-operand synthesis
  * ``refit``      -- cost-coefficient refit from tuning-cache timings
  * ``microbench`` -- device probes that calibrate a machine model
  * ``matmul``     -- the GEMM front door every model layer calls
  * ``trace``      -- named spans on the profiler's clock
"""
from repro_torch.core.descriptor import (  # noqa: F401
    FlashBwdDescriptor, FlashDecodeDescriptor, FlashDescriptor,
    GemmDescriptor, GroupedGemmBwdDescriptor, GroupedGemmDescriptor,
    KernelDescriptor, MeshSpec, QuantSpec, SsdChunkBwdDescriptor, SsdChunkDescriptor,
    TransposeDescriptor, descriptor_from_cache_key, resolve_quant)
from repro_torch.core.blocking import (  # noqa: F401
    BlockingPlan, FlashDecodePlan, FlashPlan, GroupedGemmPlan,
    MESH_STRATEGIES, Region, candidate_plans, mesh_comm_events,
    mesh_comm_seconds, mesh_local_desc, flash_bwd_fused_legal, flash_decode_legal, flash_fused_legal, fused_legal,
    grouped_bwd_fused_legal, grouped_fused_legal, palette, plan_flash,
    plan_flash_bwd, plan_flash_decode, plan_gemm, plan_grouped,
    plan_grouped_bwd, plan_ssd, plan_ssd_bwd, plan_transpose,
    ssd_bwd_fused_legal, ssd_fused_legal, SsdChunkPlan, TransposePlan)
from repro_torch.core.schedule import (  # noqa: F401
    DecodeTileSchedule, FlashTileSchedule, GroupedTileSchedule, TileSchedule,
    flash_tile_schedule, flatten_regions, plan_launches)
from repro_torch.core.machine import (  # noqa: F401
    DEFAULT_MACHINE, H100_SXM, MachineModel, TPU_V5E, get_machine)
from repro_torch.core.config import (  # noqa: F401
    EngineConfig, configure, get_config, resolve_device, use)
from repro_torch.core.matmul import matmul  # noqa: F401
from repro_torch.core.jit_cache import (  # noqa: F401
    GLOBAL_KERNEL_CACHE, KernelCache, LruCache)
from repro_torch.core import autotune, engine, warmstart  # noqa: F401
