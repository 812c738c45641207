"""Production meshes (``repro.launch.mesh``), as ``DeviceMesh``es over the
default process group.

``make_production_mesh`` is a FUNCTION (not a module-level constant) so
that importing this module never touches a process group: the dry run
joins its fake group of 256 or 512 ranks first and only then builds the
mesh.

Single pod : (16, 16)    axes ("data", "model")        = 256 ranks
Multi-pod  : (2, 16, 16) axes ("pod", "data", "model") = 512 ranks;
             the "pod" axis is an extra data-parallel dimension whose
             collectives cross the slower boundary between pods —
             exactly the traffic SketchDP compresses (DESIGN.md §3.1).
"""
from __future__ import annotations


def _mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, *,
                    device_type: str = "cpu"):
    """Small mesh for CPU tests (a group of ``n_data * n_model`` ranks)."""
    return _mesh(device_type, (n_data, n_model), ("data", "model"))
