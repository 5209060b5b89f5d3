"""Modality frontends.  As in the reference, the transformer backbone is
real and the feature extractors are stubs: the caller supplies
precomputed embeddings, and a learned projection maps them into the
model's width.

  * vision (internvl2): ViT patch embeddings ``(b, n_img, modality_dim)``
    through ``proj1`` (bias, with the gelu in the GEMM's epilogue) and
    ``proj2`` (bias), prepended to the token embeddings by
    :class:`~repro_torch.models.lm.LanguageModel`;
  * audio (seamless): fbank frame embeddings ``(b, s_enc, modality_dim)``
    through ``adapter`` (bias) into the encoder's width
    (:class:`~repro_torch.models.encdec.EncoderDecoderModel`).

The features are cast to ``cfg.dtype`` first.
"""
from __future__ import annotations

from torch import nn

from repro_torch.core.machine import torch_dtype
from repro_torch.models.common import Init, Linear


class Frontend(nn.Module):
    def __init__(self, cfg, init: Init):
        super().__init__()
        self.cfg = cfg
        if cfg.modality == "vision":
            self.proj1 = Linear(cfg.modality_dim, cfg.d_model, init, bias=True)
            self.proj2 = Linear(cfg.d_model, cfg.d_model, init, bias=True)
        elif cfg.modality == "audio":
            self.adapter = Linear(cfg.modality_dim, cfg.d_model, init,
                                  bias=True)
        else:
            raise ValueError(f"unknown modality {cfg.modality!r}")

    def forward(self, feats):
        """feats: (b, n, modality_dim) -> (b, n, d_model) in ``cfg.dtype``."""
        dt = torch_dtype(self.cfg.dtype)
        feats = feats.to(dt)
        if self.cfg.modality == "vision":
            h = self.proj1(feats, epilogue="gelu", compute_dtype=dt)
            return self.proj2(h, compute_dtype=dt)
        return self.adapter(feats, compute_dtype=dt)
