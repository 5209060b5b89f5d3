"""Machine characterization: the paper's §III probes in library form.

The probes measure the device the port runs on -- matmul rate per dtype,
streaming copy bandwidth, the latency of one small launch -- and
:func:`calibrate` folds them into a :class:`~repro_torch.core.machine.
MachineModel` through :meth:`~repro_torch.core.machine.MachineModel.
from_probes`, so the planners rank tilings against the measured card
instead of pinned constants.  The probes time library calls
(``torch.matmul``, ``torch._int_mm``, ``torch._scaled_mm``, an elementwise
add), with CUDA events on the card; they are probes of the device, not
kernels of the port.  The collective probes (all_gather, all_to_all, psum
and the latency of a tiny collective) run over the default
``torch.distributed`` process group, every rank calling them together;
with fewer than two ranks they report 0 "(uncalibrated)", and
``from_probes`` then leaves the network fields ``None``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch

from .machine import DEFAULT_MACHINE, FP8_DTYPE, MachineModel


@dataclasses.dataclass
class ProbeResult:
    """One measured characterization probe: name, value, unit."""

    name: str
    value: float
    unit: str


def _device(device=None) -> torch.device:
    from .config import resolve_device
    return resolve_device(device)


def _timeit(fn, device: torch.device, iters: int = 5, warmup: int = 2
            ) -> float:
    """Median seconds of ``fn()`` after ``warmup`` calls: between CUDA
    events on the card, on the host clock elsewhere."""
    for _ in range(warmup):
        fn()
    ts = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e-3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def probe_matmul_flops(dtype: str = "float32", size: int = 512,
                       iters: int = 5, device=None) -> ProbeResult:
    """Matmul rate of one ``size``-cubed product, GFLOP/s.  ``int8`` times
    an int8 x int8 -> int32 product (``torch._int_mm``); ``float8_e4m3``
    an e4m3 product with unit scales into bf16 (``torch._scaled_mm``, the
    card only).  fp32 runs without TF32."""
    from repro_torch.kernels import disable_tf32
    dev = _device(device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    if dtype == "int8":
        a = torch.randint(-127, 128, (size, size), generator=gen,
                          dtype=torch.int8).to(dev)
        b = torch.randint(-127, 128, (size, size), generator=gen,
                          dtype=torch.int8).to(dev)

        def fn():
            return torch._int_mm(a, b)
    elif dtype in ("float8_e4m3", "float8_e4m3fn"):
        if dev.type != "cuda":
            raise ValueError("the float8_e4m3 probe needs the card")
        a = torch.randn((size, size), generator=gen).to(dev, FP8_DTYPE)
        # _scaled_mm takes B column-major.
        b = torch.randn((size, size), generator=gen).to(dev, FP8_DTYPE) \
            .t().contiguous().t()
        one = torch.ones((), device=dev)

        def fn():
            return torch._scaled_mm(a, b, scale_a=one, scale_b=one,
                                    out_dtype=torch.bfloat16)
    else:
        dt = getattr(torch, dtype)
        disable_tf32()
        a = torch.randn((size, size), generator=gen).to(dev, dt)
        b = torch.randn((size, size), generator=gen).to(dev, dt)

        def fn():
            return a @ b
    s = _timeit(fn, dev, iters=iters)
    return ProbeResult(f"matmul_{dtype}", 2 * size**3 / s / 1e9, "GFLOP/s")


def probe_copy_bandwidth(mbytes: int = 64, device=None) -> ProbeResult:
    """Streaming bandwidth of ``x + 1`` over ``mbytes`` of fp32 (read and
    write), GB/s."""
    dev = _device(device)
    n = mbytes * 2**20 // 4
    x = torch.zeros((n,), dtype=torch.float32, device=dev)
    s = _timeit(lambda: x + 1.0, dev)
    return ProbeResult("copy_bw", 2 * n * 4 / s / 1e9, "GB/s")


def probe_elementwise_latency(device=None) -> ProbeResult:
    """The time of one tiny elementwise launch, microseconds."""
    dev = _device(device)
    x = torch.zeros((8,), dtype=torch.float32, device=dev)
    s = _timeit(lambda: x * 2.0, dev, iters=20, warmup=5)
    return ProbeResult("dispatch_latency", s * 1e6, "us")


# --- interconnect probes --------------------------------------------------

_LANES = 128


def _world() -> int:
    """Ranks of the default process group (1 when none is initialised)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size()


def _net_device(device) -> torch.device:
    """The probe tensors' device: the process group's (the rank's card
    under NCCL, the CPU under gloo) unless the caller names one."""
    import torch.distributed as dist
    if device is not None:
        return _device(device)
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _net_timeit(fn, dev: torch.device, iters: int, warmup: int = 2) -> float:
    """``_timeit`` with a barrier first, so no rank's clock starts while
    another is still behind."""
    import torch.distributed as dist
    dist.barrier()
    return _timeit(fn, dev, iters=iters, warmup=warmup)


def probe_all_gather(mbytes: int = 4, iters: int = 5,
                     device=None) -> ProbeResult:
    """Per-rank ``all_gather`` receive bandwidth over the process group."""
    s = _world()
    if s < 2:
        return ProbeResult("all_gather_bw", 0.0, "GB/s (uncalibrated)")
    import torch.distributed as dist
    dev = _net_device(device)
    rows = max(1, mbytes * 2**20 // (4 * _LANES * s))
    x = torch.zeros((rows, _LANES), dtype=torch.float32, device=dev)
    outs = [torch.empty_like(x) for _ in range(s)]
    t = _net_timeit(lambda: dist.all_gather(outs, x), dev, iters)
    recv = (s - 1) * rows * _LANES * 4  # bytes each rank receives
    return ProbeResult("all_gather_bw", recv / t / 1e9, "GB/s")


def probe_all_to_all(mbytes: int = 4, iters: int = 5,
                     device=None) -> ProbeResult:
    """Per-rank ``all_to_all`` exchange bandwidth over the process group."""
    s = _world()
    if s < 2:
        return ProbeResult("all_to_all_bw", 0.0, "GB/s (uncalibrated)")
    import torch.distributed as dist
    dev = _net_device(device)
    per = max(1, mbytes * 2**20 // (4 * _LANES * s))  # rows to each peer
    x = torch.zeros((s * per, _LANES), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    t = _net_timeit(lambda: dist.all_to_all_single(out, x), dev, iters)
    moved = (s - 1) * per * _LANES * 4  # bytes each rank sends
    return ProbeResult("all_to_all_bw", moved / t / 1e9, "GB/s")


def probe_psum(mbytes: int = 4, iters: int = 5, device=None) -> ProbeResult:
    """Per-rank all-reduce (``psum``) bandwidth over the process group."""
    s = _world()
    if s < 2:
        return ProbeResult("psum_bw", 0.0, "GB/s (uncalibrated)")
    import torch.distributed as dist
    dev = _net_device(device)
    rows = max(1, mbytes * 2**20 // (4 * _LANES * s))
    x = torch.zeros((rows, _LANES), dtype=torch.float32, device=dev)
    t = _net_timeit(lambda: dist.all_reduce(x), dev, iters)
    # A ring all-reduce moves about 2 (s - 1) / s of the payload.
    moved = 2 * (s - 1) * rows * _LANES * 4 / s
    return ProbeResult("psum_bw", moved / t / 1e9, "GB/s")


def probe_collective_latency(iters: int = 20, device=None) -> ProbeResult:
    """Launch latency of a tiny all-reduce: the fixed cost a collective
    adds to its bytes in the mesh cost model, microseconds."""
    s = _world()
    if s < 2:
        return ProbeResult("collective_latency", 0.0, "us (uncalibrated)")
    import torch.distributed as dist
    dev = _net_device(device)
    x = torch.zeros((8 * s,), dtype=torch.float32, device=dev)
    t = _net_timeit(lambda: dist.all_reduce(x), dev, iters, warmup=5)
    return ProbeResult("collective_latency", t * 1e6, "us")


def characterize(machine: MachineModel = DEFAULT_MACHINE, *,
                 size: int = 512, mbytes: int = 64,
                 device=None) -> Dict[str, ProbeResult]:
    """Run every probe on ``device``, each beside the machine model's
    pinned constant (``target_*``).  A matmul probe the device cannot run
    (fp8 off the card) reports 0 with its error as the unit, which
    ``from_probes`` ignores."""
    dev = _device(device)
    out = {}
    dtypes = ["float32", "bfloat16", "int8"]
    if dev.type == "cuda":
        dtypes.append("float8_e4m3")
    for dtype in dtypes:
        try:
            r = probe_matmul_flops(dtype, size=size, device=dev)
        except (RuntimeError, ValueError) as e:
            r = ProbeResult(f"matmul_{dtype}", 0.0, f"GFLOP/s (failed: {e})")
        out[r.name] = r
        out[f"target_peak_{dtype}"] = ProbeResult(
            f"target_peak_{dtype}", machine.peak(dtype) / 1e9, "GFLOP/s")
    r = probe_copy_bandwidth(mbytes=mbytes, device=dev)
    out[r.name] = r
    out["target_hbm_bw"] = ProbeResult("target_hbm_bw",
                                       machine.hbm_bw / 1e9, "GB/s")
    r = probe_elementwise_latency(device=dev)
    out[r.name] = r
    # The collective probes are always present: 0 "(uncalibrated)" below
    # two ranks rather than absent.
    net_mb = min(mbytes, 4)
    for r in (probe_all_gather(mbytes=net_mb), probe_all_to_all(mbytes=net_mb),
              probe_psum(mbytes=net_mb), probe_collective_latency()):
        out[r.name] = r
    out["target_ici_bw"] = ProbeResult(
        "target_ici_bw", machine.ici_bw_per_link / 1e9, "GB/s")
    return out


def calibrate(base: MachineModel = DEFAULT_MACHINE, *, size: int = 512,
              mbytes: int = 64, name: str = "calibrated_host",
              refit: Optional[str] = None, device=None) -> MachineModel:
    """Probe the device and return ``base`` with the measured constants
    (the constants the probes do not measure -- legality, tile palettes --
    stay ``base``'s).  ``refit`` overlays a refit-model JSON
    (``tools/tune_torch.py refit``) on the probed model; a bad file warns
    and leaves it probed."""
    probes = characterize(base, size=size, mbytes=mbytes, device=device)
    model = MachineModel.from_probes(probes, base=base, name=name)
    if refit:
        from .machine import load_refit_model
        model = load_refit_model(refit, base=model)
    return model
