"""Input-shape suites and shape-only input specs.

Four shapes per architecture (40 cells in all), the reference's:

  * train_4k    -- seq 4096,   global batch 256  (train step)
  * prefill_32k -- seq 32768,  global batch 32   (prefill step)
  * decode_32k  -- seq 32768,  global batch 128  (serve step: one new
                   token against a seq_len-deep cache)
  * long_500k   -- seq 524288, global batch 1    (serve step; sub-quadratic
                   architectures only: full-attention ones are skips)

``input_specs`` gives every step input as an empty tensor on the meta
device (shape and dtype, no storage), for the dry-run; ``sample_batch``
draws small real batches for tests, with the reference's numpy draws in
the reference's order, so its arrays equal the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.config import resolve_device
from repro_torch.core.machine import torch_dtype


@dataclasses.dataclass(frozen=True)
class ShapeSuite:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSuite] = {
    "train_4k": ShapeSuite("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSuite("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSuite("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSuite("long_500k", 524288, 1, "decode"),
}


def shape_for(name: str) -> ShapeSuite:
    return SHAPES[name]


def cell_applicable(cfg: ModelConfig, shape: ShapeSuite) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the documented skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full quadratic attention: a 524288-token dense KV decode is "
                "the regime this arch does not support (DESIGN.md §4)")
    return None


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.modality == "vision":
        return seq_len - cfg.num_modality_tokens
    return seq_len


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSuite) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins for every step input (no allocation): the
    reference's keys, shapes and dtypes."""
    b, s = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    if shape.kind in ("train", "prefill"):
        st = _text_len(cfg, s)
        specs = {"tokens": _spec((b, st), i32)}
        if shape.kind == "train":
            specs["labels"] = _spec((b, st), i32)
        if cfg.modality == "vision":
            specs["modality_feats"] = _spec(
                (b, cfg.num_modality_tokens, cfg.modality_dim), f32)
        if cfg.encoder_decoder:
            specs["modality_feats"] = _spec((b, s, cfg.modality_dim), f32)
        return specs
    # decode: one token against a seq_len-capacity cache
    specs = {"tokens": _spec((b, 1), i32), "pos": _spec((), i32)}
    if cfg.encoder_decoder:
        specs["enc_out"] = _spec((b, s, cfg.d_model), torch_dtype(cfg.dtype))
    return specs


def sample_batch(cfg: ModelConfig, shape: ShapeSuite, seed: int = 0,
                 device=None) -> Dict[str, torch.Tensor]:
    """Small real tensors matching :func:`input_specs`, on ``device`` (the
    configured default, the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, spec in input_specs(cfg, shape).items():
        if not spec.dtype.is_floating_point:
            hi = cfg.vocab_size if k in ("tokens", "labels") \
                else max(2, shape.seq_len)
            arr = rng.integers(0, hi, size=tuple(spec.shape), dtype=np.int64)
        else:
            arr = rng.standard_normal(tuple(spec.shape))
        out[k] = torch.as_tensor(arr).to(device=dev, dtype=spec.dtype)
    return out
