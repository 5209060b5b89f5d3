"""Conversion from the reference package's parameter layout.

``params_from_jax_numpy(tree, cfg, device)`` takes the reference's
``LanguageModel.init`` (or ``EncoderDecoderModel.init``) pytree as nested
dicts (and lists) of numpy arrays -- a caller holding JAX arrays passes
``jax.tree.map(np.asarray, params)`` -- and returns the port's state dict
for ``LanguageModel(cfg)`` (``EncoderDecoderModel(cfg)``).  Any
tree shaped like the parameters converts the same way (gradients), and
``opt_state_from_jax_numpy`` converts the reference's optimizer state:
AdamW's ``{"m": tree, "v": tree}`` and ``scalable_adamw``'s, whose ``m``
is bf16 (and kept so) or absent, and whose factored second-moment leaves
are ``{"r", "c"}`` pairs.  ``reference_ndims`` and ``reference_shapes``
give each of the port's parameters the rank and shape it has in the
reference, which decide weight decay and which leaves ``scalable_adamw``
factors.

The reference stacks each layer group's parameters on a leading axis
(``params["blocks"]["groups"]``, built with ``jax.vmap``) and keeps any
remainder layers in ``params["blocks"]["rem"]``; the port has one module
per layer, so the stack is unstacked into ``blocks.<i>``.  An
encoder-decoder's ``decoder`` unstacks the same way into ``decoder.<i>``,
and its ``encoder`` (every layer stacked on one leading axis) into
``encoder.<i>``.  Weight layouts
are kept as they are (``(d_in, d_out)`` linears, ``(vocab, d)`` table),
so the port plans the same GEMM descriptors as the reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.config import resolve_device


def _is_factored(tree) -> bool:
    return isinstance(tree, dict) and set(tree) == {"r", "c"}


def _flatten(tree, prefix: str, out: Dict[str, object]) -> None:
    """Leaves by dotted path; a factored ``{"r", "c"}`` pair stays one
    leaf (a dict of two arrays)."""
    if _is_factored(tree):
        out[prefix[:-1]] = {k: np.asarray(v) for k, v in tree.items()}
    elif isinstance(tree, dict):
        for key, value in tree.items():
            _flatten(value, f"{prefix}{key}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def _layer(leaf, g: int):
    return {k: v[g] for k, v in leaf.items()} if isinstance(leaf, dict) \
        else leaf[g]


def _split_stack(stacked: Dict[str, object], n: int, where: str,
                 names) -> Dict[str, object]:
    """Leaves stacked on a leading axis of ``n`` layers, split: the leaf
    ``name`` of layer ``g`` goes to ``names(g, name)``."""
    out: Dict[str, object] = {}
    for name, leaf in stacked.items():
        lead = {(v.shape[0] if v.ndim else None) for v in (
            leaf.values() if isinstance(leaf, dict) else [leaf])}
        if lead != {n}:
            raise ValueError(f"{where}.{name}: leading axis {lead}, expected "
                             f"{n} layers")
        for g in range(n):
            out[names(g, name)] = _layer(leaf, g)
    return out


def _unstacked(tree, cfg) -> Dict[str, object]:
    """The reference tree's leaves under the port's parameter names, each
    scanned group's stack split into its layers: ``blocks`` (or an
    encoder-decoder's ``decoder``) in groups of ``len(block_pattern)``
    layers plus remainder layers, and an encoder-decoder's ``encoder``,
    stacked by ``jax.vmap`` over all ``num_encoder_layers`` layers."""
    pat = cfg.block_pattern
    flat: Dict[str, object] = {}
    for key in ("embed", "final_norm", "lm_head", "frontend", "enc_norm"):
        if tree.get(key) is not None:
            _flatten(tree[key], f"{key}.", flat)
    if "encoder" in tree:
        stacked: Dict[str, object] = {}
        _flatten(tree["encoder"], "", stacked)
        flat.update(_split_stack(stacked, cfg.num_encoder_layers, "encoder",
                                 lambda g, name: f"encoder.{g}.{name}"))
    stack = "decoder" if cfg.encoder_decoder else "blocks"
    groups = tree[stack]["groups"]
    n_groups = cfg.num_layers // len(pat)
    if groups is not None:
        for i in range(len(pat)):
            stacked = {}
            _flatten(groups[f"b{i}"], "", stacked)
            flat.update(_split_stack(
                stacked, n_groups, f"{stack}.groups.b{i}",
                lambda g, name, i=i: f"{stack}.{g * len(pat) + i}.{name}"))
    for j, block in enumerate(tree[stack]["rem"]):
        _flatten(block, f"{stack}.{n_groups * len(pat) + j}.", flat)
    return flat


def _tensor(arr: np.ndarray, dev, keep_bf16: bool) -> torch.Tensor:
    """fp32 on ``dev``; a bf16 array stays bf16 with ``keep_bf16`` (the
    fp32 detour is exact both ways)."""
    t = torch.from_numpy(np.array(arr, dtype=np.float32)).to(dev)
    return t.to(torch.bfloat16) if keep_bf16 and arr.dtype.name == \
        "bfloat16" else t


def params_from_jax_numpy(tree, cfg, device=None) -> Dict[str, torch.Tensor]:
    """The port model's state dict from a reference pytree of
    numpy arrays, on ``device`` (the configured default if None)."""
    dev = resolve_device(device)
    return {name: _tensor(arr, dev, False)
            for name, arr in _unstacked(tree, cfg).items()}


def opt_state_from_jax_numpy(state, cfg, device=None):
    """The port's optimizer state from the reference's (numpy leaves),
    unstacked like the parameters: ``m`` (fp32 for AdamW, bf16 for
    ``scalable_adamw``, which may have none) keeps its dtype, and a
    factored ``v`` leaf stays an ``{"r", "c"}`` pair, each unstacked per
    layer."""
    dev = resolve_device(device)
    out = {}
    for key in ("m", "v"):
        if key not in state:
            continue
        out[key] = {}
        for name, leaf in _unstacked(state[key], cfg).items():
            out[key][name] = {k: _tensor(v, dev, True)
                              for k, v in leaf.items()} \
                if isinstance(leaf, dict) else _tensor(leaf, dev, True)
    return out


def reference_shapes(cfg, model) -> Dict[str, Tuple[int, ...]]:
    """Each parameter's shape as the reference holds it: a layer in a
    scanned group of ``blocks`` (an encoder-decoder's ``decoder``) is
    stacked on a leading axis of ``num_layers // len(block_pattern)``
    groups, an ``encoder`` layer on one of ``num_encoder_layers`` (so a
    stacked norm scale is 2-D there, decayed and factored as such);
    remainder layers and the rest keep the port's shape.  ``model`` is a
    ``LanguageModel``, an ``EncoderDecoderModel`` or a dict of its named
    tensors."""
    named = model.items() if isinstance(model, dict) \
        else model.named_parameters()
    groups = cfg.num_layers // len(cfg.block_pattern)
    stacked = groups * len(cfg.block_pattern)
    out = {}
    for name, p in named:
        parts = name.split(".")
        if parts[0] == "encoder":
            lead = (cfg.num_encoder_layers,)
        elif parts[0] in ("blocks", "decoder") and int(parts[1]) < stacked:
            lead = (groups,)
        else:
            lead = ()
        out[name] = lead + tuple(p.shape)
    return out


def reference_ndims(cfg, model) -> Dict[str, int]:
    """Each parameter's rank as the reference holds it: one more than the
    port's for layers in a scanned group (the reference stacks them on a
    leading layer axis), the port's own for remainder layers and the rest.
    ``model`` is a ``LanguageModel`` or a dict of its named tensors."""
    return {name: len(shape)
            for name, shape in reference_shapes(cfg, model).items()}
