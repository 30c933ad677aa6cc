"""CUDA MAP step: ``csrc/map_step.cu`` bound through ``ctypes``.

Counterpart of ``repro.kernels.map_step.fused_map_step_pallas``: given each
element's neighbourhood label counts, it computes the K label energies,
the per-element min/argmin, the per-hood energy sums and the (label,
vertex) votes, in three launches on the current stream.  The hood sums
are order-free (``csrc/segsum.cuh``): the same bit for bit from call to
call and whatever the order of the elements.  It is the kernel of the
sharded static-pallas route, where the counts before it and the sums
after it cross shards.
``ref.fused_map_step`` is its plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

#: Launches of the kernel in this process (``ops.launch_counts``).
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [
    _P, _P, _P, _P, _P, _P,        # y, w, cnt, nall, xf, valid
    _P, _P, _P, _P, _P,            # hood_id, vertex, mu, sigma, beta
    ctypes.c_longlong, _I, _I, _I,  # n, n_labels, n_hoods, n_vertices
    _P, _P, _P, _P,                # min_e, arg, hood_e, votes
    _P, _P,                        # workspace, stream
]
_WORKSPACE_FLOATS = 4  # per hood: the order-free hood sum's int64 sum, exponent key, flags
_kernel = None

_require = functools.partial(_build.require, "fused_map_step_cuda")


def _bind():
    global _kernel
    if _kernel is None:
        _kernel = _build.function("map_step", "repro_fused_map_step", _ARGTYPES)
    return _kernel


def fused_map_step_cuda(
    y: torch.Tensor,
    w: torch.Tensor,
    cnt_e: torch.Tensor,
    nall_e: torch.Tensor,
    xf: torch.Tensor,
    valid: torch.Tensor,
    hood_id: torch.Tensor,
    vertex: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    beta,
    *,
    n_hoods: int,
    n_vertices: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the step; returns ``(min_e, arg, hood_e, votes)`` like
    ``ref.fused_map_step``.

    Element arrays are contiguous (H,) float32 (int32 for ``hood_id`` and
    ``vertex``) in any order, ``cnt_e`` is (K, H) float32, ``mu`` and
    ``sigma`` (K,).  Lanes with ``valid == 0`` and ids outside
    ``[0, n_hoods)`` / ``[0, n_vertices)`` add to no sum.
    """
    global launches
    if not y.is_cuda:
        raise ValueError(f"fused_map_step_cuda needs CUDA tensors, got {y.device}")
    dev = y.device
    n_labels = int(mu.shape[0])
    h = int(y.shape[0])
    f32, i32 = torch.float32, torch.int32
    for name, t in (("y", y), ("w", w), ("nall_e", nall_e), ("xf", xf), ("valid", valid)):
        _require(t, name, f32, (h,), dev)
    _require(cnt_e, "cnt_e", f32, (n_labels, h), dev)
    _require(hood_id, "hood_id", i32, (h,), dev)
    _require(vertex, "vertex", i32, (h,), dev)
    _require(mu, "mu", f32, (n_labels,), dev)
    _require(sigma, "sigma", f32, (n_labels,), dev)
    beta_t = torch.as_tensor(beta, dtype=f32, device=dev).reshape(1).contiguous()

    min_e = torch.empty((h,), dtype=f32, device=dev)
    arg = torch.empty((h,), dtype=i32, device=dev)
    hood_e = torch.empty((n_hoods,), dtype=f32, device=dev)
    ws_len = _WORKSPACE_FLOATS * n_hoods
    zeroed = torch.zeros((ws_len + n_labels * n_vertices,), dtype=f32, device=dev)  # one memset
    votes = zeroed[ws_len:].view(n_labels, n_vertices)
    kernel = _bind()
    with torch.cuda.device(dev):
        kernel(
            y.data_ptr(), w.data_ptr(), cnt_e.data_ptr(), nall_e.data_ptr(),
            xf.data_ptr(), valid.data_ptr(), hood_id.data_ptr(), vertex.data_ptr(),
            mu.data_ptr(), sigma.data_ptr(), beta_t.data_ptr(),
            h, n_labels, n_hoods, n_vertices,
            min_e.data_ptr(), arg.data_ptr(), hood_e.data_ptr(), votes.data_ptr(),
            zeroed.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    launches += 1
    return min_e, arg, hood_e, votes
