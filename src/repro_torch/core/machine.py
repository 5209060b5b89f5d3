"""Machine models: the constants every planner reads.

``TPU_V5E`` is the reference package's pinned model, copied as data only
so the port's planners can be checked plan-for-plan against the
reference.  ``H100_SXM`` is the port's target and ``DEFAULT_MACHINE``:
its peaks are NVIDIA's published H100 SXM figures (dense, no sparsity,
at the 700 W limit), and its legality comes from what the port's CUDA
kernels accept rather than from a scratchpad size:

  * the GEMM kernels stream operands from device memory tile by tile,
    so any GEMM is legal for the fused single-launch lowering;
  * their accumulator blockings are the shapes ``csrc/gemm.cu``
    instantiates (``bm_candidates`` x ``bn_candidates``), with a fixed
    K panel of ``k_panel`` elements, K split over clusters of up to
    ``gemm_max_cluster`` blocks;
  * the flash kernels take ``(block_q, block_k)`` from ``flash_blocks``;
  * the paged decode kernel takes pages of up to ``decode_max_page``
    slots, head dims up to ``decode_max_head_dim`` and GQA groups of up to
    ``decode_max_group`` query heads per KV head (the constants of
    ``csrc/flash_decode.cu``); its route A (the cluster-split walk on TMA
    page loads) takes bf16 q with pages of up to ``decode_a_max_page``
    rows (a multiple of 4), GQA groups of up to ``decode_a_max_group`` and
    the head dims ``decode_a_head_dims``, and route B the rest;
  * the SSD chunked-scan kernels take chunks of up to ``ssd_max_q`` rows,
    states of up to ``ssd_max_state`` and head dims of up to
    ``ssd_max_head_dim`` (the constants of ``csrc/ssd_scan.cu`` and
    ``csrc/ssd_scan_bwd.cu``); their route A (a cluster of blocks a group,
    wgmma products) takes chunks of a multiple of ``ssd_a_block`` rows,
    states of exactly ``ssd_a_state`` and head dims of exactly
    ``ssd_a_head_dim``, and route B the rest;
  * the grouped-GEMM kernels take the ``(bm, bk, bn)`` tilings of
    ``grouped_blocks`` (the shapes ``csrc/grouped.cu`` instantiates), each
    of which must fit its static shared memory (``grouped_smem_bytes``);
  * the transpose kernel takes the square tile edges ``transpose_tiles``
    (the ones ``csrc/transpose.cu`` instantiates).

The dispatch overheads are pinned assumptions, not measurements.  Two
sources replace them, as in the reference: :meth:`MachineModel.from_probes`
folds ``repro_torch.core.microbench`` probe results (matmul rate per dtype,
copy bandwidth, launch latency) into a copy of a base model, and
:func:`load_refit_model` overlays the cost coefficients that
``repro_torch.core.refit`` fitted to a tuning cache's timings, stamping a
``+refit`` provenance on ``fingerprint`` and ``tuning_key``.

The interconnect is modelled as in the reference: pinned link figures
(``ici_bw_per_link``, ``ici_links``) until the collective probes of
``core.microbench`` calibrate ``ici_bandwidth_gbps``,
``collective_launch_s`` and ``collective_efficiency`` (or a refit's
network stage does); a network-calibrated model carries ``+net`` in its
``fingerprint`` and ``tuning_key``.  The field names are the reference's,
so refit files and tuning keys read in both packages.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import math
import warnings
from typing import Dict, Iterable, Mapping, Optional, Tuple, Union

import torch

DEFAULT_STEP_OVERHEAD_S = 2.0e-7
DEFAULT_LAUNCH_OVERHEAD_S = 2.0e-6
DEFAULT_FUSED_TILE_DECODE_S = 6e-7
DEFAULT_EXTRA_LAUNCH_FACTOR = 0.25
DEFAULT_STITCH_DISCOUNT = 0.25

# Version of the refit-model JSON that ``tools/tune_torch.py refit`` writes
# and :func:`load_refit_model` reads (the reference's format).
REFIT_MODEL_VERSION = 1

# Coefficients a refit model may carry; a file naming anything else was
# written by a newer tool and is refused (the reference's list, so that the
# two packages read each other's files).
REFIT_COEFFICIENTS = (
    "step_overhead_s", "launch_overhead_s", "extra_launch_factor",
    "fused_tile_decode_s", "stitch_discount",
    "ici_bandwidth_gbps", "collective_launch_s", "collective_efficiency",
)

# The e4m3 wire dtype of the quant axis (``jnp.float8_e4m3fn`` in the
# reference): 4 exponent bits, 3 mantissa bits, no infinities, +-448.
FP8_DTYPE = torch.float8_e4m3fn

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1,
             "float8_e4m3": 1, "float64": 8}

_TORCH_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int8: "int8",
                torch.float64: "float64",
                FP8_DTYPE: "float8_e4m3"}

_NAME_TO_TORCH = {v: k for k, v in _TORCH_NAMES.items()}


def canonical_dtype(dtype) -> str:
    """Canonical descriptor dtype name for a torch dtype or a name."""
    if isinstance(dtype, str):
        name = "float8_e4m3" if dtype == "float8_e4m3fn" else dtype
        if name in _ITEMSIZE:
            return name
        raise ValueError(f"unsupported dtype for machine model: {dtype}")
    if dtype in _TORCH_NAMES:
        return _TORCH_NAMES[dtype]
    raise ValueError(f"unsupported dtype for machine model: {dtype}")


def itemsize(dtype) -> int:
    """Bytes per element of a dtype name or torch dtype."""
    return _ITEMSIZE[canonical_dtype(dtype)]


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a canonical name (or a torch dtype)."""
    return _NAME_TO_TORCH[canonical_dtype(dtype)]


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Performance and legality model of one accelerator."""

    name: str
    peak_flops: Dict[str, float]  # dtype name -> FLOP/s
    hbm_bw: float  # bytes/s
    # On-chip staging budget: VMEM on the TPU, the shared memory one
    # thread block may use on Hopper.
    vmem_bytes: int
    sublanes: Dict[str, int]
    lanes: int
    # Device memory in bytes (the roofline's fit budget); None: not
    # modelled.
    hbm_bytes: Optional[int] = None
    # --- interconnect: pinned link figures ------------------------------
    ici_bw_per_link: float = 1e9  # bytes/s per link
    ici_links: int = 1  # links per device
    # bytes/s per device across pods (hosts); None: not modelled.
    dcn_bw: Optional[float] = None
    step_overhead_s: float = DEFAULT_STEP_OVERHEAD_S
    launch_overhead_s: float = DEFAULT_LAUNCH_OVERHEAD_S
    fused_tile_decode_s: float = DEFAULT_FUSED_TILE_DECODE_S
    extra_launch_factor: float = DEFAULT_EXTRA_LAUNCH_FACTOR
    stitch_discount: float = DEFAULT_STITCH_DISCOUNT
    # --- GEMM palette (the reference hard-wires these in blocking.py) ----
    acc_budget_elems: int = 256 * 256
    bm_candidates: Tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512)
    bn_candidates: Tuple[int, ...] = (128, 256, 512, 1024)
    # --- legality ---------------------------------------------------------
    # True: fused kernels stage whole operands on chip (the TPU lowering),
    # so fused legality is a VMEM fit.  False: they stream from device
    # memory and every problem is legal.
    stages_whole_operands: bool = True
    # Fixed K-panel depth of the kernel; None plans bk against VMEM.
    k_panel: Optional[int] = None
    # The largest thread-block cluster the dense GEMM kernel splits one
    # tile's K over; None: no split.
    gemm_max_cluster: Optional[int] = None
    # Flash (block_q, block_k) shapes the kernels take; None derives them
    # from VMEM fit.
    flash_blocks: Optional[Tuple[Tuple[int, int], ...]] = None
    # Paged decode kernel limits; None: any pool geometry is legal.
    decode_max_page: Optional[int] = None
    decode_max_head_dim: Optional[int] = None
    decode_max_group: Optional[int] = None
    # The decode kernel's route A limits; None: no route A.
    decode_a_max_page: Optional[int] = None
    decode_a_max_group: Optional[int] = None
    decode_a_head_dims: Optional[Tuple[int, ...]] = None
    # SSD chunked-scan kernel limits (chunk, state, head dim); None: legality
    # is the VMEM fit of a kernel that stages whole chunk cells.
    ssd_max_q: Optional[int] = None
    ssd_max_state: Optional[int] = None
    ssd_max_head_dim: Optional[int] = None
    # The SSD kernels' route A (chunk-row multiple, state, head dim), the
    # forward's and the backward's alike; None: no route A.
    ssd_a_block: Optional[int] = None
    ssd_a_state: Optional[int] = None
    ssd_a_head_dim: Optional[int] = None
    # Grouped-GEMM kernel tilings (bm, bk, bn) and the static shared memory
    # a tile may stage; None: legality is the VMEM fit of a kernel that
    # stages whole operands.
    grouped_blocks: Optional[Tuple[Tuple[int, int, int], ...]] = None
    grouped_smem_bytes: Optional[int] = None
    # Square tile edges the transpose kernel instantiates; None: legality
    # is the VMEM fit of a staged (bt, bt) tile.
    transpose_tiles: Optional[Tuple[int, ...]] = None
    # --- calibrated network -------------------------------------------
    # None: not network-calibrated (the collective probes did not run: one
    # device, or a pinned model); ``collective_seconds`` then uses the
    # pinned link figures.
    ici_bandwidth_gbps: Optional[float] = None  # measured all_gather GB/s
    collective_launch_s: Optional[float] = None  # per-collective launch
    # per-collective bandwidth relative to the all_gather probe, e.g.
    # {"all_gather": 1.0, "all_to_all": 0.7, "psum": 0.5}
    collective_efficiency: Optional[Dict[str, float]] = None
    # Fingerprint of the offline refit model whose cost coefficients
    # replaced the pinned or probed ones (:func:`load_refit_model`); None:
    # not refitted.
    refit_fingerprint: Optional[str] = None

    @property
    def network_calibrated(self) -> bool:
        """True when the collective probes parameterized this model."""
        return self.ici_bandwidth_gbps is not None

    @property
    def _provenance(self) -> str:
        """``+net`` for a network-calibrated model, ``+refit`` for refitted
        coefficients; they compose (``+net+refit``)."""
        return (("+net" if self.network_calibrated else "")
                + ("+refit" if self.refit_fingerprint else ""))

    @functools.cached_property
    def fingerprint(self) -> str:
        """Short digest of every model constant (plan-cache keys), with the
        ``+net`` / ``+refit`` provenance suffix."""
        blob = repr(dataclasses.astuple(self)).encode()
        return hashlib.md5(blob).hexdigest()[:8] + self._provenance

    @property
    def tuning_key(self) -> str:
        """The machine's name in tuning-cache entry keys: ``name`` plus the
        ``+net`` / ``+refit`` provenance, so that winners ranked under
        calibrated and uncalibrated, fitted and probed costs never serve
        each other.  Probe drift on one host keeps the key (unlike
        ``fingerprint``)."""
        return self.name + self._provenance

    def peak(self, dtype) -> float:
        return self.peak_flops[canonical_dtype(dtype)]

    def reg_tile(self, dtype) -> Tuple[int, int]:
        """(row, column) alignment granule of an accumulator block."""
        return (self.sublanes[canonical_dtype(dtype)], self.lanes)

    # Roofline helpers (the reference's) ----------------------------------
    def compute_seconds(self, flops: float, dtype="bfloat16",
                        chips: int = 1) -> float:
        return flops / (self.peak(dtype) * chips)

    def memory_seconds(self, nbytes: float, chips: int = 1) -> float:
        return nbytes / (self.hbm_bw * chips)

    def collective_seconds(self, nbytes: float, chips: int = 1,
                           collective: str = "all_gather") -> float:
        """Seconds to move ``nbytes`` through one ``collective``.

        Network-calibrated: the measured all_gather rate scaled by the
        collective's efficiency ratio, plus the measured launch cost.
        Otherwise: one link's pinned rate, with ``launch_overhead_s`` as
        the launch cost, so that the mesh strategies still rank."""
        if self.network_calibrated:
            eff = 1.0
            if self.collective_efficiency:
                eff = self.collective_efficiency.get(collective, 1.0)
            bw = self.ici_bandwidth_gbps * 1e9 * max(eff, 1e-6)
            launch = self.collective_launch_s or 0.0
            return launch + nbytes / (bw * chips)
        return (self.launch_overhead_s
                + nbytes / (self.ici_bw_per_link * chips))

    @classmethod
    def from_probes(cls, probes: Union[Mapping[str, object], Iterable],
                    base: Optional["MachineModel"] = None,
                    name: str = "calibrated") -> "MachineModel":
        """A calibrated copy of ``base`` (default ``DEFAULT_MACHINE``) from
        ``repro_torch.core.microbench`` probes (``characterize``'s dict or
        any iterable of its ``ProbeResult``s):

          * ``matmul_<dtype>``   [GFLOP/s] -> ``peak_flops[dtype]``
          * ``copy_bw``          [GB/s]    -> ``hbm_bw``
          * ``dispatch_latency`` [us]      -> ``step_overhead_s`` and
            ``launch_overhead_s``
          * ``all_gather_bw``    [GB/s]    -> ``ici_bandwidth_gbps``
          * ``all_to_all_bw`` / ``psum_bw`` [GB/s]
                                           -> ``collective_efficiency``
          * ``collective_latency`` [us]    -> ``collective_launch_s``

        Other probes (the ``target_*`` echoes) are ignored, and a missing
        probe leaves the base constant, so a partial run still gives a
        model.  The collective probes report 0 with fewer than two ranks,
        and the network fields then stay ``None`` (uncalibrated)."""
        base = base if base is not None else DEFAULT_MACHINE
        if isinstance(probes, Mapping):
            probes = probes.values()
        peak = dict(base.peak_flops)
        hbm_bw = base.hbm_bw
        overhead = base.step_overhead_s
        launch = base.launch_overhead_s
        net = {}
        for p in probes:
            pname, value = p.name, p.value
            if pname.startswith("matmul_"):
                dtype = pname[len("matmul_"):]
                if dtype in peak and value > 0:
                    peak[dtype] = value * 1e9
            elif pname == "copy_bw" and value > 0:
                hbm_bw = value * 1e9
            elif pname == "dispatch_latency" and value > 0:
                # One whole dispatch round trip: the per-step and the
                # per-launch cost alike.
                overhead = launch = value * 1e-6
            elif pname in ("all_gather_bw", "all_to_all_bw", "psum_bw",
                           "collective_latency") and value > 0:
                net[pname] = value
        kwargs = dict(name=name, peak_flops=peak, hbm_bw=hbm_bw,
                      step_overhead_s=overhead, launch_overhead_s=launch)
        if "all_gather_bw" in net:
            ag = net["all_gather_bw"]
            eff = {"all_gather": 1.0}
            if "all_to_all_bw" in net:
                eff["all_to_all"] = net["all_to_all_bw"] / ag
            if "psum_bw" in net:
                eff["psum"] = net["psum_bw"] / ag
            kwargs["ici_bandwidth_gbps"] = ag
            kwargs["collective_efficiency"] = eff
            kwargs["collective_launch_s"] = (
                net["collective_latency"] * 1e-6
                if "collective_latency" in net else launch)
        return dataclasses.replace(base, **kwargs)


TPU_V5E = MachineModel(
    name="tpu_v5e",
    peak_flops={"bfloat16": 197e12, "float16": 197e12, "float32": 98.5e12,
                "int8": 394e12, "float8_e4m3": 394e12, "float64": 0.5e12},
    hbm_bw=819e9,
    vmem_bytes=128 * 1024**2,
    sublanes={"float32": 8, "bfloat16": 16, "float16": 16, "int8": 32,
              "float8_e4m3": 32, "float64": 8},
    lanes=128,
    hbm_bytes=16 * 1024**3,
    ici_bw_per_link=50e9,
    ici_links=4,
    dcn_bw=25e9 / 8,
)

# NVIDIA H100 SXM (NVIDIA's H100 data sheet, SXM5 part, dense rates
# without sparsity, at the 700 W limit): 989 TFLOP/s bf16/fp16, 1,979
# TFLOP/s fp8 (e4m3) and 1,979 TOP/s int8 on the tensor cores, 67 TFLOP/s
# fp32 outside them (the port's fp32 GEMMs never use TF32), 80 GB HBM3 at
# 3.35 TB/s (five 16 GiB stacks: 80 GiB), 227 KB shared memory per block.
# NVLink 4 (the same data sheet): 18 links, 900 GB/s in total, so 50 GB/s
# a link.  Across hosts (NVIDIA's DGX H100 data sheet): one 400 Gb/s
# ConnectX-7 NDR port per GPU, so 50e9 bytes/s a device.
H100_SXM = MachineModel(
    name="h100_sxm",
    peak_flops={"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
                "int8": 1979e12, "float8_e4m3": 1979e12, "float64": 67e12},
    hbm_bw=3.35e12,
    vmem_bytes=232448,
    sublanes={"float32": 16, "bfloat16": 16, "float16": 16, "int8": 16,
              "float8_e4m3": 16, "float64": 16},
    lanes=64,
    hbm_bytes=80 * 1024**3,
    ici_bw_per_link=900e9 / 18,
    ici_links=18,
    dcn_bw=400e9 / 8,
    # A kernel launch costs a few microseconds; tiles run in parallel on
    # 132 SMs, so a tile step costs ~1/132 of a serial one.
    step_overhead_s=2.0e-8,
    launch_overhead_s=4.0e-6,
    fused_tile_decode_s=1.0e-8,
    # The region kernel writes straight into C: nothing is stitched.
    stitch_discount=0.0,
    acc_budget_elems=128 * 128,
    bm_candidates=(16, 64, 128),
    bn_candidates=(64, 128),
    stages_whole_operands=False,
    k_panel=32,
    # 8 is the portable cluster size limit (CUDA programming guide, thread
    # block clusters).
    gemm_max_cluster=8,
    flash_blocks=((64, 64),),
    decode_max_page=64,
    decode_max_head_dim=128,
    decode_max_group=64,
    decode_a_max_page=64,
    decode_a_max_group=8,
    decode_a_head_dims=(64, 128),
    ssd_max_q=256,
    ssd_max_state=128,
    ssd_max_head_dim=64,
    ssd_a_block=64,
    ssd_a_state=128,
    ssd_a_head_dim=64,
    grouped_blocks=((16, 32, 64), (16, 32, 128), (64, 32, 64),
                    (64, 32, 128), (128, 32, 64), (128, 32, 128)),
    grouped_smem_bytes=48 * 1024,
    transpose_tiles=(32, 64),
)

DEFAULT_MACHINE = H100_SXM


def get_machine(name: str) -> MachineModel:
    """Look up a built-in machine model by name."""
    return {"tpu_v5e": TPU_V5E, "h100_sxm": H100_SXM}[name]


def _validate_refit(data, base: MachineModel) -> Optional[str]:
    """The reason a refit-model payload cannot be applied, or None."""
    if not isinstance(data, dict):
        return "not a JSON object"
    if data.get("kind") != "machine-refit":
        return f"kind={data.get('kind')!r}, expected 'machine-refit'"
    if data.get("version") != REFIT_MODEL_VERSION:
        return (f"version={data.get('version')!r}, expected "
                f"{REFIT_MODEL_VERSION} (stale model or stale reader)")
    fp = data.get("fingerprint")
    if not isinstance(fp, str) or not fp:
        return "missing provenance fingerprint"
    if data.get("base") not in (None, base.name):
        return (f"fitted against base {data.get('base')!r}, "
                f"refusing to overlay onto {base.name!r}")
    coeffs = data.get("coefficients")
    if not isinstance(coeffs, dict) or not coeffs:
        return "missing coefficients"
    for key, value in coeffs.items():
        if key not in REFIT_COEFFICIENTS:
            return f"unknown coefficient {key!r} (stale reader?)"
        if key == "collective_efficiency":
            if not isinstance(value, dict) or not all(
                    isinstance(k, str) and isinstance(v, (int, float))
                    and math.isfinite(v) and v > 0
                    for k, v in value.items()):
                return "collective_efficiency must map names to ratios > 0"
        elif (not isinstance(value, (int, float)) or isinstance(value, bool)
              or not math.isfinite(value) or value < 0):
            return f"coefficient {key}={value!r} is not a finite number >= 0"
    return None


def apply_refit(base: MachineModel, coefficients: dict,
                fingerprint: str) -> MachineModel:
    """``base`` with fitted cost coefficients (the network's included)
    and the ``+refit`` stamp."""
    return dataclasses.replace(base, **coefficients,
                               refit_fingerprint=fingerprint)


def load_refit_model(path: str,
                     base: Optional[MachineModel] = None) -> MachineModel:
    """Overlay an offline-refit coefficient model onto ``base`` (default
    ``DEFAULT_MACHINE``): the versioned JSON ``tools/tune_torch.py refit``
    writes.  A missing, corrupt, stale, wrong-base or out-of-range file
    warns and returns ``base`` unchanged."""
    base = base if base is not None else DEFAULT_MACHINE
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        warnings.warn(f"ignoring refit model {path}: {e}")
        return base
    reason = _validate_refit(data, base)
    if reason is not None:
        warnings.warn(f"ignoring refit model {path}: {reason}")
        return base
    return apply_refit(base, data["coefficients"], data["fingerprint"])
