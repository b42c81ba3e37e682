"""Production mesh construction: port of ``repro.launch.mesh``.

The production meshes are :class:`AbstractMesh` es (axis names and sizes,
no devices): the dry run traces its cells on the meta device against them,
so nothing about a cluster has to exist.  ``make_host_mesh`` builds a
``DeviceMesh`` over the ranks of the initialised process group."""

from __future__ import annotations

from ..device import DeviceLike, resolve_device
from ..distrib.sharding import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The JAX package's pod meshes, 256 devices per pod (16×16), 2 pods =
    512.  Axes: "data" carries FSDP+DP, "model" carries TP/EP; the
    multi-pod run adds a leading "pod" axis (DP across pods — the slow
    inter-node dimension)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(axes, shape)


def make_host_mesh(*, device: DeviceLike = None):
    """A ("data", "model") ``DeviceMesh`` over every rank of the initialised
    process group (tests / examples), on ``device``'s type (the GPU unless
    ``"cpu"``): "model" 2 where 2 divides the ranks, else 1; "data" the
    rest."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    model = 2 if n % 2 == 0 else 1
    return init_device_mesh(resolve_device(device).type, (n // model, model),
                            mesh_dim_names=("data", "model"))
