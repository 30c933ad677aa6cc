"""CUDA ReduceByKey: ``csrc/segment_reduce.cu`` bound through ``ctypes``.

Counterpart of ``repro.kernels.segment_reduce.segment_reduce_pallas``.
The kernel is one atomic per element (see the note in the source);
``ref.segment_reduce`` is its plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_OPS = {"add": 0, "min": 1}

#: Launches of the kernel in this process (``ops.launch_counts``).
launches = 0


_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P]
_kernel = None


def _bind():
    global _kernel
    if _kernel is None:
        _kernel = _build.function("segment_reduce", "repro_segment_reduce_f32", _ARGTYPES)
    return _kernel


def segment_reduce_cuda(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, op: str = "add"
) -> torch.Tensor:
    """Launch the kernel on ``values``' device and current stream.

    ``values`` is a contiguous (n,) float32 CUDA tensor and ``segment_ids``
    a contiguous (n,) int32 tensor on the same device; anything else raises.
    """
    global launches
    if op not in _OPS:
        raise ValueError(f"unknown segment_reduce op {op!r}; have {tuple(_OPS)}")
    if not values.is_cuda or segment_ids.device != values.device:
        raise ValueError(
            "segment_reduce_cuda needs values and segment_ids on one CUDA device, "
            f"got {values.device} and {segment_ids.device}"
        )
    if values.dtype != torch.float32 or segment_ids.dtype != torch.int32:
        raise TypeError(
            "segment_reduce_cuda takes float32 values and int32 ids, got "
            f"{values.dtype} and {segment_ids.dtype}"
        )
    if values.dim() != 1 or segment_ids.shape != values.shape:
        raise ValueError(
            f"segment_reduce_cuda takes two (n,) tensors, got {tuple(values.shape)} "
            f"and {tuple(segment_ids.shape)}"
        )
    if not (values.is_contiguous() and segment_ids.is_contiguous()):
        raise ValueError("segment_reduce_cuda takes contiguous tensors")
    if num_segments < 0 or num_segments > 2**31 - 1:
        raise ValueError(f"num_segments out of range: {num_segments}")
    fill = 0.0 if op == "add" else float("inf")
    out = torch.full((num_segments,), fill, dtype=torch.float32, device=values.device)
    kernel = _bind()
    with torch.cuda.device(values.device):
        kernel(
            values.data_ptr(), segment_ids.data_ptr(), out.data_ptr(),
            values.numel(), num_segments, _OPS[op],
            torch.cuda.current_stream().cuda_stream,
        )
    launches += 1
    return out
