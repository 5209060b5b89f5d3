"""Sharding policy: the reference's placement rules for parameters,
optimizer state, decode caches and batches, per (architecture x mesh).

Each rule returns a spec: a tuple with one entry per tensor dim, each
None, a mesh axis name or a tuple of names (the reference's
``PartitionSpec`` as a plain tuple).  Conventions (the reference's):

  * "data" is data parallelism plus FSDP: parameters and optimizer state
    are stored sharded on it;
  * "model" is tensor / expert parallelism: column- and row-parallel
    linears, experts when E divides the axis, vocab-parallel embeddings;
  * "pod" is cross-pod data parallelism only: parameters replicate across
    pods, batches shard over (pod, data);
  * every spec is sanitized: an axis is dropped from a dim it does not
    divide, so one rule set serves every architecture on any mesh.

The port's parameters are named by dotted path (``blocks.3.ff.w_up.w``),
one module per layer; a rule matches the path with ``/`` for ``.`` as the
reference matches its pytree path.  A spec covers the trailing dims of a
leaf, so the port's per-layer leaf gets the reference's spec for its
stacked leaf less the leading layer axis.  :func:`to_named` turns specs
into :class:`~repro_torch.runtime.shardlib.NamedSharding` (DTensor
placements on a ``DeviceMesh``).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Sequence, Tuple

from repro_torch.models.attention import KVCache
from repro_torch.models.rglru import RecurrentState
from repro_torch.models.ssd import SSMState
from repro_torch.runtime.shardlib import (NamedSharding, axis_size,
                                          axis_sizes, fit_axis)

BATCH_AXES = ("pod", "data")


# ---------------------------------------------------------------------------
# sanitation
# ---------------------------------------------------------------------------

def sanitize(mesh, spec: Sequence, shape: Tuple[int, ...]) -> Tuple:
    """Drop axes that are not on the mesh or do not divide their dim; a
    spec shorter than the shape is left-padded (stacked leading dims), a
    longer one keeps its trailing entries."""
    spec = tuple(spec)
    if len(spec) < len(shape):
        spec = (None,) * (len(shape) - len(spec)) + spec
    spec = spec[-len(shape):] if shape else ()
    out = []
    for dim, axis in zip(shape, spec):
        axis = fit_axis(mesh, dim, axis)
        if isinstance(axis, tuple) and len(axis) == 1:
            axis = axis[0]
        out.append(axis)
    return tuple(out)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

# (path regex, spec of the trailing dims); the first match wins.  "F" is
# the FSDP axis, "M" the tensor-parallel axis.
_PARAM_RULES = [
    (r"embed/table$", ("M", None)),                # (V, D) vocab-parallel
    (r"lm_head/w$", ("F", "M")),                   # (D, V)
    (r"(wq|wk|wv)/w$", ("F", "M")),                # column-parallel
    (r"wo/w$", ("M", "F")),                        # row-parallel
    (r"(w_gate|w_up)/w$", ("F", "M")),             # (d, f) or (E, d, f)
    (r"w_down/w$", ("M", "F")),                    # (f, d) or (E, f, d)
    (r"router/w$", ("F", None)),
    (r"(lin_y|lin_x|gate_a|gate_x)/w$", ("F", "M")),
    (r"lin_out/w$", ("M", "F")),
    (r"in_proj/w$", ("F", "M")),
    (r"out_proj/w$", ("M", "F")),
    (r"conv_w$", (None, "M")),
    (r"lambda$", ("M",)),
    (r"(proj1|proj2|adapter)/w$", ("F", "M")),
    (r"(A_log|D|dt_bias|conv_b)$", (None,)),
    (r"(scale|bias)$", (None,)),
    (r"/b$", ("M",)),                              # biases follow out dim
]


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf) if isinstance(leaf, (tuple, list)) \
        else tuple(leaf.shape)


def param_pspec(path: str, shape: Tuple[int, ...], cfg, mesh, *,
                fsdp: bool = True) -> Tuple:
    """The spec of one parameter (``path`` dotted or ``/``-separated)."""
    path = path.replace(".", "/")
    fs = "data" if fsdp else None
    is_expert = bool(re.search(r"(w_gate|w_up|w_down)/w$", path)) \
        and cfg.num_experts > 0
    for pattern, spec in _PARAM_RULES:
        if re.search(pattern, path):
            spec = tuple({"F": fs, "M": "model"}.get(s, s)
                         if isinstance(s, str) else s for s in spec)
            if is_expert:
                msize = axis_size(mesh, "model")
                if msize > 1 and cfg.num_experts % msize == 0:
                    # expert parallelism: E on "model", FSDP on d / f
                    spec = ("model", fs, None)
                else:
                    spec = (None,) + spec
            return sanitize(mesh, spec, shape)
    return sanitize(mesh, (None,) * len(shape), shape)


def _named(params) -> Dict[str, Any]:
    """``{name: leaf}`` of a module or a dict of named leaves."""
    if hasattr(params, "named_parameters"):
        return dict(params.named_parameters())
    return dict(params)


def param_pspecs(params, cfg, mesh, *, fsdp: bool = True) -> Dict[str, Tuple]:
    """``{name: spec}`` for a model (its named parameters) or a dict of
    named leaves: tensors, arrays or shapes."""
    return {name: param_pspec(name, _shape(leaf), cfg, mesh, fsdp=fsdp)
            for name, leaf in _named(params).items()}


# ---------------------------------------------------------------------------
# optimizer state: mirrors the parameter spec; a factored leaf drops a dim
# ---------------------------------------------------------------------------

def _factored(x) -> bool:
    return isinstance(x, dict) and set(x) == {"r", "c"}


def opt_pspecs(opt_state, params, cfg, mesh, *, fsdp: bool = True):
    """Specs of an optimizer state ``{"m": {name: leaf}, "v": {name: leaf
    or {"r", "c"}}}``: each leaf its parameter's spec; a factored second
    moment ``r`` (the row means) the spec less its last dim, ``c`` less
    its second-to-last."""
    pspecs = param_pspecs(params, cfg, mesh, fsdp=fsdp)

    def mirror(ps, leaf):
        if _factored(leaf):
            return {"r": ps[:-1] if ps else (),
                    "c": ps[:-2] + ps[-1:] if len(ps) >= 2 else ()}
        return ps

    return {key: {name: mirror(pspecs[name], leaf)
                  for name, leaf in sub.items()}
            for key, sub in opt_state.items()}


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------

def _batch_axes(mesh):
    bd = tuple(a for a in BATCH_AXES if a in axis_sizes(mesh))
    return bd if bd else None


def cache_pspecs(cache, cfg, mesh):
    """Specs shaped like a decode cache (``model.init_cache``'s list of
    per-layer states, or any nesting of them): KV heads on "model" when
    they divide it, else the sequence (split-K decode); the recurrent and
    SSM states on their width / heads."""
    bd = _batch_axes(mesh)
    msize = axis_size(mesh, "model")
    heads_divisible = msize > 1 and cfg.num_kv_heads % msize == 0

    def kv_component(x, role):
        # (b, S, hkv, hd), or (b, S) for pos
        if role == "pos":
            return sanitize(mesh, (bd, None), _shape(x))
        if heads_divisible:
            return sanitize(mesh, (bd, None, "model", None), _shape(x))
        return sanitize(mesh, (bd, "model", None, None), _shape(x))

    def walk(node):
        if isinstance(node, KVCache):
            return KVCache(k=kv_component(node.k, "k"),
                           v=kv_component(node.v, "v"),
                           pos=kv_component(node.pos, "pos"))
        if isinstance(node, RecurrentState):
            return RecurrentState(
                h=sanitize(mesh, (bd, "model"), _shape(node.h)),
                conv=sanitize(mesh, (bd, None, "model"), _shape(node.conv)))
        if isinstance(node, SSMState):
            return SSMState(
                conv=sanitize(mesh, (bd, None, "model"), _shape(node.conv)),
                s=sanitize(mesh, (bd, "model", None, None), _shape(node.s)))
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if node is None:
            return None
        shape = _shape(node)
        return sanitize(mesh, (None,) * len(shape), shape)

    return walk(cache)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def batch_pspecs(batch, mesh) -> Dict[str, Tuple]:
    """``{key: spec}`` of a batch dict: the leading dim over the batch
    axes, a scalar ``()``."""
    bd = _batch_axes(mesh)
    out = {}
    for key, leaf in batch.items():
        shape = _shape(leaf)
        out[key] = () if not shape else \
            sanitize(mesh, (bd,) + (None,) * (len(shape) - 1), shape)
    return out


def to_named(mesh, spec_tree):
    """Every spec of a tree (dicts and lists of specs, cache states) as a
    :class:`NamedSharding` on ``mesh``; a plain tuple is a spec."""
    def walk(node):
        if isinstance(node, KVCache):
            return KVCache(k=walk(node.k), v=walk(node.v), pos=walk(node.pos))
        if isinstance(node, (RecurrentState, SSMState)):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if node is None:
            return None
        return NamedSharding(mesh, tuple(node))

    return walk(spec_tree)
