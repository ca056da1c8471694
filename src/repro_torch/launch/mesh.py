"""Mesh construction.  Counterpart of src/repro/launch/mesh.py.

A single pod is 16 x 16 devices with axes ("data", "model"); two pods are
2 x 16 x 16 with a leading "pod" axis.  The launchers build their
(data, model) mesh with `make_mesh` over the ranks of the default process
group.  Every mesh is made by a function call, so importing this module
touches no device and no process group.
"""
from __future__ import annotations

from typing import Dict, Tuple

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The 16 x 16 (or 2 x 16 x 16) mesh over the ranks of the default
    process group, which must hold 256 (512) of them."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_mesh(dp: int, mp: int, device_type: str = "cuda"):
    """A (data, model) mesh of dp x mp ranks; rank r sits at data index
    r // mp and model index r % mp, so a model group is mp consecutive
    ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (dp, mp),
                            mesh_dim_names=("data", "model"))


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh (or of anything with `axis_names`
    and a `devices` array, as the reference's mesh has)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes the global batch shards over (pod + data when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh_axis_sizes(mesh))
