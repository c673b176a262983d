"""Mesh construction of the port (the reference's ``repro/launch/mesh.py``):
``torch.distributed`` device meshes with named dims.

Functions, not module-level constants: importing this module never touches
the process group. The caller initialises ``torch.distributed`` first
(``init_process_group`` with its own address, world size and rank); a mesh
covers the whole world. The reference's ``use_mesh(mesh)`` is the mesh's
own context here: ``with mesh: ...``.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import resolve_device
from repro_torch.models.context import axis_sizes

__all__ = ["AXES_MULTI", "AXES_SINGLE", "dp_axes", "make_debug_mesh", "make_production_mesh"]

AXES_SINGLE = ("data", "model")
AXES_MULTI = ("pod", "data", "model")


def _mesh(shape: tuple, axes: tuple, device):
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = 1
    for s in shape:
        n *= s
    if world != n:
        raise ValueError(f"a {shape} mesh over {axes} needs a world of {n} processes; the "
                         f"process group has world size {world}")
    return init_device_mesh(resolve_device(device).type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``, on the card unless ``device`` says
    otherwise. Raises unless the process group has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return _mesh(shape, AXES_MULTI if multi_pod else AXES_SINGLE, device)


def make_debug_mesh(shape=(2, 2), axes=AXES_SINGLE, device=None):
    """A small mesh for tests (a world of prod(shape) ranks)."""
    return _mesh(tuple(shape), tuple(axes), device)


def dp_axes(mesh) -> tuple[str, ...]:
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)

