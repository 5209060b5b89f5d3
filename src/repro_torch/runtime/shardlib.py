"""Activation-sharding hooks.

Model code calls :func:`shard_activation` at block boundaries with the
mesh axes the reference constrains each activation to.  Outside
:func:`use_mesh` it is the identity.  Under a mesh the port runs eagerly
and keeps every activation replicated on every rank (only the
expert-parallel grouped GEMM splits work across ranks, inside one call),
so the hook changes no value: it checks the axes against the tensor and
returns it.  :func:`activation_spec` gives the placement the reference
would constrain it to, after the reference's filtering: axes absent from
the mesh are dropped, and so are axes that do not divide their dim (a
composite axis falls back to the first of its axes that divides).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or any stand-in
with a ``shape`` dict and ``axis_names`` (the shape-only meshes of the
tests).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Sequence, Tuple, Union

_state = threading.local()

AxisName = Union[None, str, Sequence[str]]


def current_mesh():
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` current for the block (None: no mesh)."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh or a shape-only stand-in."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def axis_size(mesh, axis: AxisName) -> int:
    """Extent of one axis (1 if absent), a composite axis's product."""
    if axis is None:
        return 1
    if isinstance(axis, str):
        return axis_sizes(mesh).get(axis, 1)
    n = 1
    for a in axis:
        n *= axis_size(mesh, a)
    return n


def filter_axes(mesh, axes: Sequence[AxisName]) -> Tuple:
    """``axes`` with every name absent from the mesh dropped."""
    names = set(axis_sizes(mesh))

    def keep(a: AxisName):
        if a is None:
            return None
        if isinstance(a, str):
            return a if a in names else None
        kept = tuple(x for x in a if x in names)
        return kept if kept else None

    return tuple(keep(a) for a in axes)


def fit_axis(mesh, dim: int, axis: AxisName) -> AxisName:
    """``axis`` for a tensor dim of extent ``dim``: its names absent from
    the mesh dropped, then None unless it divides ``dim`` (a composite
    axis falls back to the first of its names that divides)."""
    axis, = filter_axes(mesh, (axis,))
    if axis is None or dim % axis_size(mesh, axis) == 0:
        return axis
    if isinstance(axis, str):
        return None
    return next((a for a in axis if dim % axis_size(mesh, a) == 0), None)


def _check_axes(axes) -> None:
    for a in axes:
        if a is None or isinstance(a, str):
            continue
        if not (isinstance(a, (tuple, list))
                and all(isinstance(x, str) for x in a)):
            raise ValueError(f"a mesh axis is None, a name or a tuple of "
                             f"names, got {a!r}")


def activation_spec(shape: Sequence[int], axes: Sequence[AxisName],
                    mesh=None) -> Tuple:
    """The reference's cleaned constraint for a tensor of ``shape``: one
    entry per dim (a shorter ``axes`` is right-padded with None)."""
    mesh = current_mesh() if mesh is None else mesh
    _check_axes(axes)
    if len(axes) > len(shape):
        raise ValueError(f"{len(axes)} sharding axes for a tensor of rank "
                         f"{len(shape)}")
    axes = tuple(axes) + (None,) * (len(shape) - len(axes))
    return tuple(fit_axis(mesh, dim, axis) for dim, axis in zip(shape, axes))


def shard_activation(x, axes: Sequence[AxisName]):
    """The identity off-mesh; under a mesh, ``x`` checked against the
    constraint ``axes`` and returned unchanged (activations stay
    replicated on every rank)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    activation_spec(tuple(x.shape), axes, mesh)
    return x


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec of axis names per tensor dim: the reference's
    ``NamedSharding``.  ``placements`` gives the DTensor form."""

    mesh: object
    spec: Tuple

    @property
    def placements(self) -> list:
        """One ``Shard(dim)`` or ``Replicate()`` per mesh dimension."""
        return placements(self.mesh, self.spec)


def placements(mesh, spec: Sequence[AxisName]) -> list:
    """DTensor placements of ``spec`` on ``mesh``: mesh dimension ``a`` is
    ``Shard(i)`` when tensor dim ``i`` is sharded over ``a`` (alone or in
    a composite axis), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_sizes(mesh):
        dim = next((i for i, a in enumerate(spec)
                    if a == name or (isinstance(a, tuple) and name in a)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def named_sharding(mesh, *axes: AxisName) -> NamedSharding:
    """``axes`` (absent names dropped) as a :class:`NamedSharding`."""
    return NamedSharding(mesh, filter_axes(mesh, axes))
