"""Build the CUDA kernels with nvcc and bind them with ctypes.

Every ``kernels/*/csrc/*.cu`` file is compiled, at the first CUDA launch
and never at import, into its own shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so <name>.cu

All sources are compiled in parallel, one nvcc each.  The output name
carries a hash of the source, every ``kernels/*/csrc/*.cuh`` header (a
header may be shared across families: ``gemm/csrc/quant_tile.cuh`` is
included by the quantized GEMM and grouped GEMM) and the flags, so an
edited source or header rebuilds and an unchanged one is reused.  A missing nvcc, a failed build or a
kernel that reports a launch error raises; nothing falls back.

The libraries go to ``$REPRO_TORCH_BUILD_DIR`` if it is set, else to
``build/repro_torch/`` in the source checkout the package runs from.
An installed package (no checkout around it) must set the variable.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_KERNELS_DIR = Path(__file__).resolve().parent

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
last_build_seconds = None


def sources() -> Dict[str, Path]:
    """Kernel sources by stem: ``{"gemm": .../gemm/csrc/gemm.cu, ...}``."""
    return {p.stem: p for p in sorted(_KERNELS_DIR.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return nvcc


def build_dir() -> Path:
    """Where the kernel libraries are written (see the module docstring)."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    checkout = _KERNELS_DIR.parents[2]  # <checkout>/src/repro_torch/kernels
    if _KERNELS_DIR.parents[1].name != "src" \
            or not (checkout / "pyproject.toml").is_file():
        raise RuntimeError(f"repro_torch at {_KERNELS_DIR.parent} is not in a "
                           f"source checkout; set REPRO_TORCH_BUILD_DIR to "
                           f"the directory the CUDA kernels are built into")
    return checkout / "build" / "repro_torch"


def _target(src: Path) -> Path:
    """The library's path, named by a hash of the source, the kernel
    headers and the flags."""
    blob = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(_KERNELS_DIR.glob("*/csrc/*.cuh")))
    digest = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"{src.stem}-{digest[:16]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile (in parallel) and load every kernel library; idempotent."""
    global last_build_seconds
    with _lock:
        srcs = sources()
        if all(name in _libs for name in srcs):
            return _libs
        t0 = time.perf_counter()
        build_dir().mkdir(parents=True, exist_ok=True)
        pending = {}
        for name, src in srcs.items():
            out = _target(src)
            if name in _libs or out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            pending[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        errors = []
        for name, (proc, tmp, out) in pending.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu "
                              f"(exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for name, src in srcs.items():
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(_target(src)))
        last_build_seconds = time.perf_counter() - t0
        return _libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``<name>.cu`` (building all on first
    use)."""
    return build_all()[name]


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def stream_ptr(tensor) -> int:
    """The current CUDA stream of ``tensor``'s device, as a pointer."""
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


def ptr(tensor) -> int:
    """Device pointer of a tensor, or NULL for ``None``."""
    return None if tensor is None else tensor.data_ptr()
