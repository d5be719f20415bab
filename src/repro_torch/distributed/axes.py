"""Mesh axes: names, sizes, the FSDP axes, a device-less mesh, and the
ambient mesh that ``layers.constrain``, the MoE aux losses and the decode
core read.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names ``("pod", "data", "model")``, or an
:class:`AbstractMesh` (names and sizes only, for planning shardings).
This is the lowest layer that knows of meshes: the sharding rules and the
models read it, and ``launch.mesh`` builds meshes on top of it and
re-exports it.  Importing this module touches no process group and no
device.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Iterator, Sequence, Tuple


@dataclass(frozen=True)
class AbstractMesh:
    """A device-less mesh: axis names and sizes only."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(axis_sizes: Sequence[int],
                  axis_names: Sequence[str]) -> AbstractMesh:
    """A mesh of these axis sizes and names, with no devices behind it."""
    return AbstractMesh(tuple(int(s) for s in axis_sizes),
                        tuple(axis_names))


def axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names or ())


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an
    :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def mesh_size(mesh) -> int:
    n = 1
    for s in axis_sizes(mesh).values():
        n *= s
    return n


def fsdp_axes(mesh) -> Tuple[str, ...]:
    """The axes a parameter's 'replicated' dimension is sharded over."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


# -- the ambient mesh -----------------------------------------------------------

# a stack shared by every thread: autograd runs a CUDA backward on a thread
# of its own
_AMBIENT: list = []


def current_mesh():
    """The mesh made ambient by :func:`set_mesh`, or ``None``."""
    return _AMBIENT[-1] if _AMBIENT else None


@contextlib.contextmanager
def set_mesh(mesh) -> Iterator:
    """Make ``mesh`` ambient for ``layers.constrain``, the MoE aux losses
    and the decode core while the block runs."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()
