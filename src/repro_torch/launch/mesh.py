"""Device meshes over ``torch.distributed``, with the reference's named axes.

Axis semantics (the reference's):
  * "pod"   -- cross-pod data parallelism (gradient all-reduce only)
  * "data"  -- in-pod data parallelism and the FSDP storage axis
  * "model" -- tensor / expert parallelism

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over the
initialised default process group, one rank per mesh position.  The mesh
builders are functions, never module constants, so importing this module
touches no process group.  Every entry point takes the device policy of
the port: the mesh's device type is ``"cuda"`` unless the caller asks for
``"cpu"``, and :func:`init_ranks` picks NCCL on the card and gloo on the
CPU unless the caller names a backend.

:func:`run_ranks` spawns one process per rank (the ``spawn`` start method:
CUDA cannot fork), initialises each one's process group through a
``file://`` store with a timeout, runs a function in it and joins every
process within a time limit, terminating them all past it.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import time
import traceback
from typing import Optional, Sequence

import torch

DEFAULT_TIMEOUT_S = 300.0


def _device_type(device=None) -> str:
    from repro_torch.core.config import resolve_device
    return resolve_device(device).type


def default_backend(device=None) -> str:
    """NCCL for a mesh on the card, gloo for one on the CPU."""
    return "nccl" if _device_type(device) == "cuda" else "gloo"


def init_ranks(rank: int, world_size: int, init_method: str, *,
               device=None, backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Initialise this process's default process group as ``rank`` of
    ``world_size`` (``init_method`` e.g. ``file:///tmp/x/init`` or
    ``tcp://localhost:PORT``), with a timeout on every collective.  On the
    card the rank's device is ``rank % device_count``.  Returns the
    backend."""
    import torch.distributed as dist
    dev_type = _device_type(device)
    backend = backend or default_backend(dev_type)
    kw = {}
    if dev_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev  # binds the rank to its card
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return backend


def _make_mesh(shape: Sequence[int], axes: Sequence[str], device=None):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh needs the process group initialised "
                           "first (repro_torch.launch.mesh.init_ranks)")
    size = 1
    for s in shape:
        size *= s
    if size != dist.get_world_size():
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {size} ranks, "
                         f"the process group has {dist.get_world_size()}")
    return init_device_mesh(_device_type(device), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production mesh: (data 16, model 16), or (pod 2,
    data 16, model 16) with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_test_mesh(data: int = 1, model: int = 1, *, device=None):
    """A (data, model) mesh over the ``data * model`` ranks of the process
    group (the unit tests' mesh)."""
    return _make_mesh((data, model), ("data", "model"), device)


def mesh_chips(mesh) -> int:
    """Ranks (devices) of a mesh."""
    return mesh.size()


# ---------------------------------------------------------------------------
# Spawned ranks
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world_size, init_method, device, backend,
               timeout_s, args):
    import torch.distributed as dist
    try:
        init_ranks(rank, world_size, init_method, device=device,
                   backend=backend, timeout_s=timeout_s)
        fn(rank, world_size, *args)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size: int, args: tuple = (), *, store_dir: str,
              device=None, backend: Optional[str] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes, each with its process group initialised (``init_ranks``)
    through a file store in ``store_dir``, which must not hold one yet.
    ``fn`` must be importable by the children (a module-level function).
    Every process is joined within ``timeout_s`` seconds in all; past it,
    or as soon as one rank fails, the others are terminated.  Raises if
    any rank failed or timed out."""
    if device is None or torch.device(device).type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(os.path.abspath(store_dir), "pg_init")
    if os.path.exists(store):
        raise FileExistsError(f"{store} exists: a file store is single use")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, rank, world_size, f"file://{store}",
                               device, backend, timeout_s, tuple(args)))
             for rank in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while time.monotonic() < deadline:
            alive = [p for p in procs if p.is_alive()]
            if not alive or any(p.exitcode for p in procs):
                break
            alive[0].join(0.2)
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.terminate()
        for p in hung:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(c for c in codes if c is not None and c > 0):
        raise RuntimeError(f"ranks exited with codes {codes}")
    if hung:
        raise TimeoutError(f"{len(hung)} of {world_size} ranks still ran "
                           f"after {timeout_s} s and were terminated")
    if any(codes):
        raise RuntimeError(f"ranks exited with codes {codes}")
