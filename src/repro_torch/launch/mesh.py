"""Mesh construction over the default process group.

Counterpart of ``repro.launch.mesh``.  Functions, never module-level
constants: importing this module touches no process group.  The caller
starts the group (``torch.distributed.init_process_group``, with its
address, world size and rank); the mesh's devices are the group's ranks
in row-major order, as ``jax.make_mesh`` lays them out (rank =
data * model_size + model on a (data, model) mesh).  The reference's
hardware constants belong to its accelerator and are not carried here.
"""

from __future__ import annotations

from typing import Optional, Tuple

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default group,
    whose world size must be the mesh's size (else :class:`ValueError`).
    ``device_type`` defaults to ``cuda`` under an NCCL group, else ``cpu``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    size = 1
    for n in shape:
        size *= int(n)
    world = dist.get_world_size()
    if world != size:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {size} ranks; the group has {world}")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} differ in length")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(int(n) for n in shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's deployment mesh: (data=16, model=16), or
    (pod=2, data=16, model=16) with ``multi_pod``."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_mesh(shape, axes)
