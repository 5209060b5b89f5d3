"""Warm start: descriptor manifests and operand synthesis.

A serving process pays its plan resolutions and kernel builds at the first
requests.  ``engine.warmup`` moves them before traffic: it replays a
recorded descriptor population, resolving each plan through the tuned
tier and running the family once on zero operands.  This module owns the
two pieces it needs, as the reference's does:

  * the **manifest** -- a versioned JSON list of descriptor cache keys
    (``engine.seen_descriptors()`` is what a process dispatched), read back
    through :func:`~repro_torch.core.descriptor.descriptor_from_cache_key`;
  * **operand synthesis** -- :func:`synth_operands` builds zero operands of
    the reference's shapes and dtypes for every family, on the configured
    device, enough to drive one ``execute()``.

A corrupt or stale manifest warns and gives an empty population (a cold
start, never a crash).
"""
from __future__ import annotations

import ast
import json
import os
import tempfile
import warnings
from typing import Iterable, List, Optional, Tuple

import torch

from .descriptor import (BIAS_EPILOGUES, FlashBwdDescriptor,
                         FlashDecodeDescriptor, FlashDescriptor,
                         GemmDescriptor, GroupedGemmBwdDescriptor,
                         GroupedGemmDescriptor, KernelDescriptor,
                         SsdChunkBwdDescriptor, SsdChunkDescriptor,
                         TransposeDescriptor, descriptor_from_cache_key)
from .machine import torch_dtype

MANIFEST_VERSION = 1


def save_manifest(path: str,
                  descriptors: Iterable[KernelDescriptor]) -> int:
    """Write a descriptor manifest (atomically); returns the entry count.
    Entries are the ``repr`` of each descriptor's ``cache_key()``, the
    tuning cache's encoding."""
    keys = sorted({repr(d.cache_key()) for d in descriptors})
    payload = {"version": MANIFEST_VERSION, "descriptors": keys}
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".manifest.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return len(keys)


def load_manifest(path: str) -> List[KernelDescriptor]:
    """The descriptors a manifest records.  A missing, corrupt or
    stale-version file warns and gives ``[]``; an entry that does not
    parse is skipped with a warning."""
    try:
        with open(path) as f:
            data = json.load(f)
        if (not isinstance(data, dict)
                or data.get("version") != MANIFEST_VERSION
                or not isinstance(data.get("descriptors"), list)):
            raise ValueError("not a descriptor manifest (or stale version)")
    except (OSError, json.JSONDecodeError, ValueError) as e:
        warnings.warn(f"ignoring warm-start manifest {path}: {e}")
        return []
    out: List[KernelDescriptor] = []
    for entry in data["descriptors"]:
        try:
            out.append(descriptor_from_cache_key(ast.literal_eval(entry)))
        except (ValueError, SyntaxError, TypeError) as e:
            warnings.warn(f"skipping manifest entry {entry!r}: {e}")
    return out


def _gemm_operands(desc: GemmDescriptor, z, ones) -> Tuple[tuple, dict]:
    a_dt = b_dt = torch_dtype(desc.in_dtype)
    kw = {}
    if desc.quant is not None:
        wire = torch_dtype(desc.quant.dtype)
        b_dt = wire
        kw["sb"] = ones((desc.n,), torch.float32)
        if not desc.quant.weight_only:
            a_dt = wire
            kw["sa"] = ones((desc.m,), torch.float32)
    lead = (desc.batch,) if desc.batch else ()
    if desc.epilogue in BIAS_EPILOGUES:
        kw["bias"] = z((desc.n,), torch.float32)
    if desc.accumulate:
        kw["c"] = z(lead + (desc.m, desc.n), torch_dtype(desc.out_dtype))
    b_shape = (desc.k, desc.n) if desc.layout == "nn" else (desc.n, desc.k)
    return (z(lead + (desc.m, desc.k), a_dt), z(lead + b_shape, b_dt)), kw


def _flash_operands(desc: FlashDescriptor, z) -> Tuple[tuple, dict]:
    dt = torch_dtype(desc.dtype)
    q = z((desc.batch_heads, desc.sq, desc.d), dt)
    kv = z((desc.batch_heads, desc.sk, desc.d), dt)
    if isinstance(desc, FlashBwdDescriptor):
        lse = z((desc.batch_heads, desc.sq), torch.float32)
        return (q, kv, kv, q, q, lse), {}
    return (q, kv, kv), {}


def _decode_operands(desc: FlashDecodeDescriptor, z) -> Tuple[tuple, dict]:
    dt = torch_dtype(desc.dtype)
    q = z((desc.num_seqs, desc.num_heads, desc.head_dim), dt)
    pool = z((desc.pages, desc.page_size, desc.num_kv_heads, desc.head_dim),
             dt)
    tables = z((desc.num_seqs, desc.max_blocks), torch.int32)
    lengths = z((desc.num_seqs,), torch.int32)
    return (q, pool, pool, tables, lengths), {}


def _grouped_operands(desc: GroupedGemmDescriptor, z,
                      ones) -> Tuple[tuple, dict]:
    dt = torch_dtype(desc.dtype)
    x_dt = w_dt = dt
    kw = {}
    if desc.quant is not None:
        wire = torch_dtype(desc.quant.dtype)
        w_dt = wire
        kw["sw"] = ones((desc.num_experts, desc.n), torch.float32)
        if not desc.quant.weight_only:
            x_dt = wire
            kw["sx"] = ones((desc.t,), torch.float32)
    if desc.epilogue in BIAS_EPILOGUES:
        kw["bias"] = z((desc.num_experts, desc.n), torch.float32)
    x = z((desc.t, desc.k), x_dt)
    w = z((desc.num_experts, desc.k, desc.n), w_dt)
    sizes = [desc.t // desc.num_experts] * desc.num_experts
    sizes[0] += desc.t - sum(sizes)
    group_sizes = torch.tensor(sizes, dtype=torch.int32, device=x.device)
    if isinstance(desc, GroupedGemmBwdDescriptor):
        # The backward's dY is the fp32 pre-epilogue cotangent.
        return (x, z((desc.t, desc.n), torch.float32), w, group_sizes), {}
    return (x, w, group_sizes), kw


def _ssd_operands(desc: SsdChunkDescriptor, z) -> Tuple[tuple, dict]:
    dt = torch_dtype(desc.dtype)
    g, q, n, p = desc.groups, desc.q, desc.n, desc.p
    if not desc.chunks:
        return (z((g, q, n), dt), z((g, q, n), dt), z((g, q, q), dt),
                z((g, q, p), dt)), {}
    nc = desc.chunks
    c = z((g, nc, q, n), dt)
    decay = z((g, nc, q), torch.float32)
    ops = (c, c, z((g, nc, q, q), dt), z((g, nc, q, p), dt), decay, decay)
    if isinstance(desc, SsdChunkBwdDescriptor):
        return ops + (z((g, nc, p, n), torch.float32),
                      z((g, nc, q, p), torch.float32),
                      z((g, p, n), torch.float32)), {}
    return ops + (z((g, p, n), torch.float32),), {}


def synth_operands(desc: KernelDescriptor, device
                   ) -> Optional[Tuple[tuple, dict]]:
    """Zero operands and keywords that drive one ``execute()`` of ``desc``
    on ``device``: the reference's shapes and dtypes (quantized wire
    operands with unit scales, zero biases and accumulators, a
    near-even split of the grouped rows, all-inactive decode slots).
    None for a mesh descriptor, whose execution needs the capacity-slot
    layout and a live process group: warmup then warms its plan only."""
    if getattr(desc, "mesh", None) is not None:
        return None
    device = torch.device(device)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(shape, dtype):
        return torch.ones(shape, dtype=dtype, device=device)

    if isinstance(desc, GemmDescriptor):
        return _gemm_operands(desc, z, ones)
    if isinstance(desc, FlashDescriptor):
        return _flash_operands(desc, z)
    if isinstance(desc, FlashDecodeDescriptor):
        return _decode_operands(desc, z)
    if isinstance(desc, GroupedGemmDescriptor):
        return _grouped_operands(desc, z, ones)
    if isinstance(desc, SsdChunkDescriptor):
        return _ssd_operands(desc, z)
    if isinstance(desc, TransposeDescriptor):
        shape = ((desc.batch, desc.rows, desc.cols) if desc.batch
                 else (desc.rows, desc.cols))
        return (z(shape, torch_dtype(desc.dtype)),), {}
    raise TypeError(f"no operand synthesis for {type(desc).__name__}")
