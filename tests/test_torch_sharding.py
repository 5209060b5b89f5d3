"""The port's placement rules against the reference's, case by case as
tests/test_sharding.py runs them, as tuples of axis names.

The port names a parameter by dotted path, one module per layer, where
the reference stacks each scanned layer group on a leading axis: the
port's spec of a layer's leaf must be the reference's spec of the stacked
leaf less the leading layer axis, which the reference leaves unsharded.
Full-size shapes come from the reference's ``eval_shape`` trees; their
leaves are unstacked into the port's names by ``repro_torch.convert``
over zero-stride arrays, each filled with its reference leaf's index, so
no parameter is ever allocated.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.runtime import sharding as jshd
from repro.runtime.steps import cache_shapes, param_shapes

from repro_torch.configs import get_config
from repro_torch.convert import _unstacked
from repro_torch.models.attention import KVCache
from repro_torch.models.rglru import RecurrentState
from repro_torch.models.ssd import SSMState
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.shardlib import (NamedSharding, activation_spec,
                                          named_sharding, shard_activation,
                                          use_mesh)


class FakeMesh:
    """Shape-only mesh stand-in (the reference test's), read by both
    packages."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


FM = FakeMesh(data=16, model=16)


def _t(spec):
    return tuple(spec)


def _id_tree(tree):
    """``tree``'s leaves replaced by zero-stride int64 arrays of the same
    shapes, each holding its leaf's index in ``jax.tree.leaves`` order."""
    leaves, treedef = jax.tree.flatten(tree)
    return jax.tree.unflatten(treedef, [
        np.broadcast_to(np.int64(i), leaf.shape)
        for i, leaf in enumerate(leaves)])


def _leaf_id(arr) -> int:
    return int(np.asarray(arr).reshape(-1)[0])


def _assert_trailing(port, ref, where):
    """The port's spec is the trailing part of the reference's, whose
    leading (stacked) entries are unsharded."""
    port, ref = _t(port), _t(ref)
    lead = len(ref) - len(port)
    assert lead >= 0 and ref[lead:] == port, (where, port, ref)
    assert all(a is None for a in ref[:lead]), (where, port, ref)


def test_sanitize_drops_nondividing_axis():
    for spec, shape, want in ((("data", "model"), (48, 512), ("data", "model")),
                              (("data", "model"), (7, 512), (None, "model")),
                              (("data", "model"), (48, 9), ("data", None))):
        assert shd.sanitize(FM, spec, shape) == want
        assert _t(jshd.sanitize(FM, spec, shape)) == want


def test_sanitize_left_pads_stacked_dims():
    assert shd.sanitize(FM, ("data", "model"), (12, 64, 128)) == \
        (None, "data", "model") == _t(jshd.sanitize(
            FM, ("data", "model"), (12, 64, 128)))


def test_sanitize_composite_fallback():
    fm = FakeMesh(pod=2, data=16, model=16)
    for shape in ((32, 8), (16, 8), (6, 8)):
        assert shd.sanitize(fm, (("pod", "data"), None), shape) == \
            _t(jshd.sanitize(fm, (("pod", "data"), None), shape))
    assert shd.sanitize(fm, (("pod", "data"), None), (32, 8)) == \
        (("pod", "data"), None)


def _port_params(arch):
    """The port's leaves (zero-stride arrays holding their reference
    leaf's index) by name, their port specs by name, and the reference's
    specs in leaf order, on ``FM``."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    shapes = param_shapes(jcfg)
    ref = jax.tree.leaves(jshd.param_pspecs(shapes, jcfg, FM),
                          is_leaf=lambda x: isinstance(x, P))
    named = _unstacked(_id_tree(shapes), cfg)
    return named, shd.param_pspecs(named, cfg, FM), ref


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "grok-1-314b",
                                  "recurrentgemma-9b", "mamba2-130m",
                                  "seamless-m4t-large-v2"])
def test_param_specs_equal_reference(arch):
    named, specs, ref = _port_params(arch)
    assert set(specs) == set(named)
    seen = set()
    for name, arr in named.items():
        i = _leaf_id(arr)
        seen.add(i)
        _assert_trailing(specs[name], ref[i], name)
        for dim, axis in zip(arr.shape, specs[name]):
            if axis is not None:
                size = 1
                for a in ([axis] if isinstance(axis, str) else axis):
                    size *= FM.shape[a]
                assert dim % size == 0, (arch, name, arr.shape, axis)
    assert seen == set(range(len(ref))), "every reference leaf is a port leaf"


def test_expert_parallel_vs_tp_fallback():
    named, specs, ref = _port_params("phi3.5-moe-42b")  # E=16 == model: EP
    up = specs["blocks.0.ff.w_up.w"]
    assert up[-3] == "model"
    _assert_trailing(up, ref[_leaf_id(named["blocks.0.ff.w_up.w"])], "up")
    named8, specs8, ref8 = _port_params("grok-1-314b")  # E=8 < 16: TP-f
    up8 = specs8["blocks.0.ff.w_up.w"]
    assert up8[-3] is None and up8[-1] == "model"
    _assert_trailing(up8, ref8[_leaf_id(named8["blocks.0.ff.w_up.w"])], "up8")


_PORT_STATES = {"KVCache": KVCache, "RecurrentState": RecurrentState,
                "SSMState": SSMState}


def _unstack_state(node):
    """A reference cache state of stacked shapes as the port's state of
    one layer, over zero-stride arrays."""
    return _PORT_STATES[type(node).__name__](*[
        np.broadcast_to(np.int8(0), leaf.shape[1:]) for leaf in node])


def _port_cache(jcfg, batch, capacity):
    """The reference's stacked cache shapes as the port's per-layer list
    (zero-stride arrays), and the reference's specs by (group, b, layer)."""
    cshapes = cache_shapes(jcfg, batch=batch, capacity=capacity)
    cspecs = jshd.cache_pspecs(cshapes, jcfg, FM)

    pat, groups = jcfg.block_pattern, jcfg.num_layers // len(jcfg.block_pattern)
    port, ref = [], []
    for g in range(groups):
        for i in range(len(pat)):
            port.append(_unstack_state(cshapes["groups"][f"b{i}"]))
            ref.append(cspecs["groups"][f"b{i}"])
    return port, ref


@pytest.mark.parametrize("arch,dim,want", [
    ("grok-1-314b", 1, "model"),       # kv 8 < 16: the sequence sharded
    ("phi3-mini-3.8b", 2, "model"),    # kv 32 divisible: the heads
])
def test_cache_specs_seq_shard_fallback_for_gqa(arch, dim, want):
    jcfg = j_get_config(arch)
    port, ref = _port_cache(jcfg, batch=128, capacity=32768)
    specs = shd.cache_pspecs(port, get_config(arch), FM)
    assert isinstance(specs, list) and len(specs) == len(port)
    for got, exp in zip(specs, ref):
        assert isinstance(got, KVCache)
        for f in ("k", "v", "pos"):
            _assert_trailing(getattr(got, f), getattr(exp, f), f)
    assert specs[0].k[dim] == want


def test_cache_specs_for_recurrent_and_ssm_states():
    fm = FakeMesh(data=2, model=4)
    for arch in ("recurrentgemma-9b", "mamba2-130m"):
        jcfg = j_get_config(arch)
        cfg = get_config(arch)
        cshapes = cache_shapes(jcfg, batch=8, capacity=64)
        cspecs = jshd.cache_pspecs(cshapes, jcfg, fm)
        pat = jcfg.block_pattern
        for i in range(len(pat)):
            port = _unstack_state(cshapes["groups"][f"b{i}"])
            got = shd.cache_pspecs([port], cfg, fm)[0]
            exp = cspecs["groups"][f"b{i}"]
            assert type(got) is type(port)
            for f in ("k", "v", "pos") if isinstance(got, KVCache) \
                    else got._fields:
                _assert_trailing(getattr(got, f), getattr(exp, f), f)


def test_opt_specs_mirror_params_and_factored():
    """Full-size shapes, so that ``scalable_adamw`` factors leaves."""
    from repro.optim import scalable_adamw
    jcfg, cfg = j_get_config("qwen3-0.6b"), get_config("qwen3-0.6b")
    shapes = param_shapes(jcfg)
    oshapes = jax.eval_shape(scalable_adamw(1e-3).init, shapes)
    ref = jshd.opt_pspecs(oshapes, shapes, jcfg, FM)
    assert "m" in ref and "v" in ref
    params = _unstacked(_id_tree(shapes), cfg)
    state, ref_leaves = {}, {}
    for key in ("m", "v"):
        ref_leaves[key] = jax.tree.leaves(
            ref[key], is_leaf=lambda x: isinstance(x, P))
        state[key] = _unstacked(_id_tree(oshapes[key]), cfg)
    specs = shd.opt_pspecs(state, params, cfg, FM)
    assert set(specs) == {"m", "v"}
    factored = 0
    for key in ("m", "v"):
        assert set(specs[key]) == set(params)
        for name, leaf in state[key].items():
            got = specs[key][name]
            if isinstance(leaf, dict):
                factored += 1
                for part in ("r", "c"):
                    _assert_trailing(got[part], ref_leaves[key][
                        _leaf_id(leaf[part])], (key, name, part))
            else:
                _assert_trailing(got, ref_leaves[key][_leaf_id(leaf)],
                                 (key, name))
    assert factored


def test_batch_specs():
    batch = {"tokens": (256, 4096), "pos": ()}
    out = shd.batch_pspecs(batch, FM)
    assert out["tokens"] == ("data", None)
    assert out["pos"] == ()
    jout = jshd.batch_pspecs(
        {"tokens": jax.ShapeDtypeStruct((256, 4096), jnp.int32),
         "pos": jax.ShapeDtypeStruct((), jnp.int32)}, FM)
    assert {k: _t(v) for k, v in jout.items()} == out
    fm = FakeMesh(pod=2, data=16, model=16)
    assert shd.batch_pspecs(batch, fm)["tokens"] == \
        _t(jshd.batch_pspecs({"tokens": jax.ShapeDtypeStruct(
            (256, 4096), jnp.int32)}, fm)["tokens"])


def test_to_named_gives_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard
    fm = FakeMesh(pod=2, data=4, model=4)
    named = shd.to_named(fm, {"w": ("data", "model"),
                              "x": (("pod", "data"), None),
                              "b": ()})
    assert isinstance(named["w"], NamedSharding)
    assert named["w"].placements == [Replicate(), Shard(0), Shard(1)]
    assert named["x"].placements == [Shard(0), Shard(0), Replicate()]
    assert named["b"].placements == [Replicate()] * 3
    assert named_sharding(fm, "data", "expert").spec == ("data", None)


def test_shard_activation_checks_and_keeps_values():
    import torch
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert shard_activation(x, ("bogus",) * 9) is x  # off-mesh: identity
    fm = FakeMesh(data=2, model=4)
    with use_mesh(fm):
        assert shard_activation(x, (("pod", "data"), "model", None)) is x
        with pytest.raises(ValueError):
            shard_activation(x, (None,) * 4)
        with pytest.raises(ValueError):
            shard_activation(x, (1, None, None))
    # the reference's filtering: absent axes dropped, non-dividing too
    assert activation_spec((2, 3, 4), (("pod", "data"), "model", None),
                           fm) == (("data",), None, None)
    assert activation_spec((2, 8), ("data", "model"), fm) == \
        ("data", "model")
