"""Parameter conversion from the reference package's layout.

``params_from_jax_numpy(tree, cfg, device)`` takes the reference's
``LanguageModel.init`` pytree as nested dicts (and lists) of numpy arrays
-- a caller holding JAX arrays passes ``jax.tree.map(np.asarray, params)``
-- and returns the port's state dict for ``LanguageModel(cfg)``.

The reference stacks each layer group's parameters on a leading axis
(``params["blocks"]["groups"]``, built with ``jax.vmap``) and keeps any
remainder layers in ``params["blocks"]["rem"]``; the port has one module
per layer, so the stack is unstacked into ``blocks.<i>``.  Weight layouts
are kept as they are (``(d_in, d_out)`` linears, ``(vocab, d)`` table),
so the port plans the same GEMM descriptors as the reference.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.config import resolve_device


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for key, value in tree.items():
            _flatten(value, f"{prefix}{key}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def params_from_jax_numpy(tree, cfg, device=None) -> Dict[str, torch.Tensor]:
    """The port's ``LanguageModel`` state dict from a reference pytree of
    numpy arrays, on ``device`` (the configured default if None)."""
    dev = resolve_device(device)
    pat = cfg.block_pattern
    flat: Dict[str, np.ndarray] = {}
    for key in ("embed", "final_norm", "lm_head"):
        if key in tree:
            _flatten(tree[key], f"{key}.", flat)
    groups = tree["blocks"]["groups"]
    n_groups = cfg.num_layers // len(pat)
    if groups is not None:
        for i in range(len(pat)):
            stacked: Dict[str, np.ndarray] = {}
            _flatten(groups[f"b{i}"], "", stacked)
            for name, arr in stacked.items():
                if arr.shape[0] != n_groups:
                    raise ValueError(f"blocks.groups.b{i}.{name}: leading "
                                     f"axis {arr.shape[0]}, expected "
                                     f"{n_groups} layer groups")
                for g in range(n_groups):
                    flat[f"blocks.{g * len(pat) + i}.{name}"] = arr[g]
    for j, block in enumerate(tree["blocks"]["rem"]):
        _flatten(block, f"blocks.{n_groups * len(pat) + j}.", flat)
    return {name: torch.from_numpy(np.array(arr, dtype=np.float32)).to(dev)
            for name, arr in flat.items()}
