"""Meshes: the production layout, a host mesh over the caller's process
group, and the roofline's H100 figures.

The port of the reference package's ``launch/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names.  Axis semantics:

  * ``pod``   — data parallelism across groups of nodes (the gradient
                all-reduce crosses the slowest links; compression lives
                here)
  * ``data``  — FSDP/data parallelism
  * ``model`` — tensor/expert parallelism, kept inside one 8-GPU NVLink
                domain (the highest-bandwidth axis)

The production meshes are laid out for H100 nodes of 8 GPUs: ``("data",
"model") = (32, 8)`` for 256 GPUs, ``("pod", "data", "model") = (2, 32,
8)`` for 512.  Building one needs a default process group of that world
size (the dry run's fake group); :func:`abstract_mesh` describes a mesh
without any group, for planning shardings.  The axis helpers and the
ambient mesh (:func:`set_mesh`, :func:`current_mesh`) live in
``distributed.axes`` and are re-exported here.

Importing this module touches no process group and no device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..distributed.axes import (AbstractMesh, abstract_mesh,  # noqa: F401
                                axis_names, axis_sizes, current_mesh,
                                fsdp_axes, mesh_size, set_mesh)

PRODUCTION_SHAPE = {False: ((32, 8), ("data", "model")),
                    True: ((2, 32, 8), ("pod", "data", "model"))}


def _checked(device_type: str) -> None:
    """Raise where ``device_type`` is ``"cuda"`` and there is no GPU: a
    mesh is never moved to the CPU behind its caller's back."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a GPU, and there is none; "
                           "pass device_type='cpu' for a mesh on the host")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production H100 mesh (one or two groups of 32 nodes), over the
    default process group, whose world size must be 256 or 512; on the
    GPUs unless ``device_type`` says otherwise (``"cpu"``: the dry run's
    fake group)."""
    from torch.distributed.device_mesh import init_device_mesh
    _checked(device_type)
    shape, names = PRODUCTION_SHAPE[bool(multi_pod)]
    want = 1
    for s in shape:
        want *= s
    world = dist.get_world_size()
    if world != want:
        raise ValueError(f"the production mesh {dict(zip(names, shape))} "
                         f"needs a world of {want}, the process group has "
                         f"{world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_host_mesh(model_axis: int = 1, *, device_type: str = "cuda"):
    """A ``("data", "model")`` mesh over the caller's process group (NCCL
    on the card, gloo on the CPU with ``device_type="cpu"``): ``world //
    model_axis`` by ``model_axis``.  Raises where ``device_type`` is
    ``"cuda"`` and there is no GPU."""
    from torch.distributed.device_mesh import init_device_mesh
    _checked(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialized process "
                           "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"world size {world} is not a multiple of "
                         f"model_axis {model_axis}")
    return init_device_mesh(device_type, (world // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


# -- roofline constants ----------------------------------------------------------
# NVIDIA H100 SXM5 80GB at its 700 W limit (the data sheet's dense figures)
PEAK_BF16_FLOPS = 989e12          # FLOP/s, bf16 on the tensor cores
HBM_BW = 3.35e12                  # bytes/s
NVLINK_BW = 450e9                 # bytes/s per direction (the model axis)
# one 400 Gb/s NIC per GPU between nodes (the data and pod axes)
INTER_NODE_BW = 50e9              # bytes/s per GPU
# the roofline's collective term: the data and pod axes' gathers and
# reductions leave the node, so the slower link bounds them
LINK_BW = INTER_NODE_BW
