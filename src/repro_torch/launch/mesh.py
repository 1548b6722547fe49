"""Meshes: the production meshes by name and size, and a small device mesh
over the current process group.

Counterpart of ``repro/launch/mesh.py``. ``make_production_mesh`` returns an
``AbstractMesh`` — axis names and sizes, no process group — because the
production meshes (16 x 16 and 2 x 16 x 16) have more ranks than a host
holds, and the dry run and ``Partitioner`` need only names and sizes.
``make_host_mesh`` builds a 2-D ``DeviceMesh`` named ``("data", "model")``
over the world of the initialised ``torch.distributed`` group, on the card
unless ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh that holds no devices."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} sizes for {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of an ``AbstractMesh`` or a named ``DeviceMesh``,
    in the mesh's dim order."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the DeviceMesh needs mesh_dim_names")
    return {n: int(mesh.size(i)) for i, n in enumerate(names)}


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, *, device="cuda"):
    """A ``(data, model)`` DeviceMesh over every rank of the initialised
    process group; ``data * model`` must be its world size. On the card
    each rank takes the card of its local rank."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised "
                           "torch.distributed process group")
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} ranks, "
                         f"the process group has {world}")
    device = torch.device(device).type
    if device == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device: pass device='cpu' for a CPU "
                               "mesh")
        torch.cuda.set_device(dist.get_rank() % n)
    return init_device_mesh(device, (data, model),
                            mesh_dim_names=("data", "model"))
