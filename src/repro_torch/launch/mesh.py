"""Mesh construction over the default process group.

Counterpart of ``repro.launch.mesh``.  Functions, never module-level
constants: importing this module touches no process group.  The caller
starts the group (``torch.distributed.init_process_group``, with its
address, world size and rank); the mesh's devices are the group's ranks
in row-major order, as ``jax.make_mesh`` lays them out (rank =
data * model_size + model on a (data, model) mesh).  The hardware
constants below are one NVIDIA H100 SXM's, in place of the reference's
TPU v5e figures, for ``launch.roofline``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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


# --- hardware constants (one NVIDIA H100 SXM) -- launch.roofline ----------
# NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense (no sparsity), at
# the 700 W limit:
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12        # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12              # bytes/s, HBM3
# Fourth-generation NVLink: 900 GB/s a GPU both directions together, 450
# GB/s a direction, within a node of 8 GPUs (DGX H100 / HGX H100):
NVLINK_BW = 450e9             # bytes/s a direction
GPUS_PER_NODE = 8
# Between nodes: one 400 Gb/s InfiniBand NDR adapter a GPU (DGX H100's
# ConnectX-7 ports), 50 GB/s a direction:
IB_BW = 50e9                  # bytes/s a direction


def axis_crosses_nodes(mesh_shape: Dict[str, int], axis: str) -> bool:
    """Whether a group along ``axis`` of a row-major mesh (rank = index
    in ``mesh_shape``'s order, ``GPUS_PER_NODE`` consecutive ranks a node)
    spans more than one node."""
    names = list(mesh_shape)
    stride = 1
    for a in names[names.index(axis) + 1:]:
        stride *= int(mesh_shape[a])
    span = stride * int(mesh_shape[axis])
    return not (span <= GPUS_PER_NODE and GPUS_PER_NODE % span == 0)


def axis_bandwidth(mesh_shape: Dict[str, int], axis: str) -> float:
    """Bytes/s a GPU of a group along ``axis``: NVLink within a node,
    InfiniBand across nodes."""
    return IB_BW if axis_crosses_nodes(mesh_shape, axis) else NVLINK_BW
