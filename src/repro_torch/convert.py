"""Conversion from the reference package's parameter layout.

``params_from_jax_numpy(tree, cfg, device)`` takes the reference's
``LanguageModel.init`` pytree as nested dicts (and lists) of numpy arrays
-- a caller holding JAX arrays passes ``jax.tree.map(np.asarray, params)``
-- and returns the port's state dict for ``LanguageModel(cfg)``.  Any
tree shaped like the parameters converts the same way (gradients), and
``opt_state_from_jax_numpy`` converts the reference's AdamW state
``{"m": tree, "v": tree}``.  ``reference_ndims`` gives each of the port's
parameters the rank it has in the reference, which decides weight decay.

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


def opt_state_from_jax_numpy(state, cfg, device=None):
    """The port's AdamW state from the reference's ``{"m": tree, "v":
    tree}`` (numpy leaves), unstacked like the parameters."""
    return {k: params_from_jax_numpy(state[k], cfg, device)
            for k in ("m", "v")}


def reference_ndims(cfg, model) -> Dict[str, int]:
    """Each parameter's rank as the reference holds it: one more than the
    port's for layers in a scanned group (the reference stacks them on a
    leading layer axis), the port's own for remainder layers and the rest.
    ``model`` is a ``LanguageModel`` or a dict of its named tensors."""
    named = model.items() if isinstance(model, dict) \
        else model.named_parameters()
    stacked = (cfg.num_layers // len(cfg.block_pattern)) \
        * len(cfg.block_pattern)
    out = {}
    for name, p in named:
        parts = name.split(".")
        scanned = parts[0] == "blocks" and int(parts[1]) < stacked
        out[name] = p.ndim + int(scanned)
    return out
