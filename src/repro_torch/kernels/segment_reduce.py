"""CUDA ReduceByKey: ``csrc/segment_reduce.cu`` bound through ``ctypes``.

Counterpart of ``repro.kernels.segment_reduce.segment_reduce_pallas``.
Float ``add`` is order-free: the kernel sums on a fixed-point grid per
segment with integer atomics (``csrc/segsum.cuh``), so its result is the
same bit for bit whatever order the ids come in;
``repro_torch.testing.segsum`` models it.  ``ordered=True`` sums each
segment in element order instead (a warp per segment, one lane at a time:
``csrc/plainsum.cuh``), the order of the plain version on the CPU, bit for
bit.  ``min`` lets a NaN win.  ``ref.segment_reduce`` is the plain
version.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from repro_torch.kernels import _build

_OPS = {"add": 0, "min": 1}

#: Launches of the kernel in this process (``ops.launch_counts``), and the
#: shares of the element-order ``add`` and of ``min`` in them.  A launch
#: inside a CUDA graph is counted by the kernel on the device
#: (:func:`counting_on_device`) and added here when the graph's words are
#: read (:func:`count_device`).
launches = 0
launches_ordered = 0
launches_min = 0
#: Address of three device int32 words (order-free add, ordered add, min)
#: that the launches count themselves into, or None (counted here).
_device_words = None


_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P, _P, _P]
_ORDERED_ARGTYPES = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P, _P, _P]
_WORKSPACE_BYTES = 16  # per segment, for ``add``: int64 sum, exponent key, flags
_ORDERED_WORKSPACE_BYTES = 8  # per segment, for the ordered ``add``: first and last index
_kernel = None
_ordered_kernel = None


def _bind():
    global _kernel
    if _kernel is None:
        _kernel = _build.function("segment_reduce", "repro_segment_reduce_f32", _ARGTYPES)
    return _kernel


def _bind_ordered():
    global _ordered_kernel
    if _ordered_kernel is None:
        _ordered_kernel = _build.function(
            "segment_reduce", "repro_segment_reduce_ordered_f32", _ORDERED_ARGTYPES)
    return _ordered_kernel


@contextlib.contextmanager
def counting_on_device(words: int):
    """Within the block, each launch adds one to its variant's word of the
    three device int32 words at address ``words`` (order-free ``add``,
    ordered ``add``, ``min``) instead of to this module's counts: the
    launches a graph captures, which the kernel counts on every replay."""
    global _device_words
    saved, _device_words = _device_words, words
    try:
        yield
    finally:
        _device_words = saved


def count_device(add: int, ordered: int, minimum: int) -> None:
    """Add launches the kernel counted on the device (read from the words
    of :func:`counting_on_device`) to this module's counts."""
    global launches, launches_ordered, launches_min
    launches += add + ordered + minimum
    launches_ordered += ordered
    launches_min += minimum


def _count(variant: int):
    """The count word of ``variant`` (0 add, 1 ordered add, 2 min) while
    counting on the device, else None after counting the launch here."""
    global launches, launches_ordered, launches_min
    if _device_words is not None:
        return _device_words + 4 * variant
    launches += 1
    launches_ordered += variant == 1
    launches_min += variant == 2
    return None


def segment_reduce_cuda(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, op: str = "add",
    *, ordered: bool = False,
) -> torch.Tensor:
    """Launch the kernel on ``values``' device and current stream.

    ``values`` is a contiguous (n,) float32 CUDA tensor and ``segment_ids``
    a contiguous (n,) int32 tensor on the same device; anything else raises.
    ``ordered=True`` (``add`` only) sums each segment in element order.
    """
    if op not in _OPS:
        raise ValueError(f"unknown segment_reduce op {op!r}; have {tuple(_OPS)}")
    if ordered and op != "add":
        raise ValueError("ordered=True applies to add; min is order-free")
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
    dev = values.device
    if ordered:
        if values.numel() > 2**31 - 1:
            raise ValueError(f"the ordered add takes fewer than 2**31 elements, got {values.numel()}")
        out = torch.empty((num_segments,), dtype=torch.float32, device=dev)
        workspace = torch.empty((num_segments * _ORDERED_WORKSPACE_BYTES,), dtype=torch.uint8,
                                device=dev)
        kernel = _bind_ordered()
        with torch.cuda.device(dev):
            kernel(values.data_ptr(), segment_ids.data_ptr(), out.data_ptr(), values.numel(),
                   num_segments, workspace.data_ptr(), _count(1),
                   torch.cuda.current_stream().cuda_stream)
        return out
    if op == "add":
        out = torch.empty((num_segments,), dtype=torch.float32, device=dev)
        workspace = torch.empty((num_segments * _WORKSPACE_BYTES,), dtype=torch.uint8, device=dev)
        ws_ptr = workspace.data_ptr()
    else:
        out = torch.full((num_segments,), float("inf"), dtype=torch.float32, device=dev)
        ws_ptr = None
    kernel = _bind()
    with torch.cuda.device(dev):
        kernel(
            values.data_ptr(), segment_ids.data_ptr(), out.data_ptr(),
            values.numel(), num_segments, _OPS[op], ws_ptr, _count(2 if op == "min" else 0),
            torch.cuda.current_stream().cuda_stream,
        )
    return out
