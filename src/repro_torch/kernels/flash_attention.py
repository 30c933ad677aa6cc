"""CUDA flash attention: ``csrc/flash_attention.cu`` bound through ``ctypes``.

Counterpart of ``repro.kernels.flash_attention.flash_attention_pallas``:
online-softmax attention with the GQA head map and an optional causal
mask, one launch per call.  ``ref.flash_attention`` is its plain version.

The source holds two kernels and its C entry point chooses between them
by (dtype, head dim): bfloat16 at D = 64 or 128 runs on the tensor cores
(wgmma, TMA), everything else on the CUDA cores in float32.  It reports
its choice, and the wrapper counts it in :data:`launches_tc`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

#: Launches of the kernel in this process (``ops.launch_counts``), and of
#: those the launches that the C entry point sent to the tensor-core kernel.
launches = 0
launches_tc = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [
    _P, _P, _P, _P,                # q, k, v, out
    _I, _I, _I, _I, _I,            # b, hq, hkv, s, d
    ctypes.c_float, _I, _I,        # scale, causal, dtype
    _P,                            # stream
    ctypes.POINTER(_I),            # out: 1 if the tensor-core kernel ran
]
_kernel = None

_require = functools.partial(_build.require, "flash_attention_cuda")


def _bind():
    global _kernel
    if _kernel is None:
        _kernel = _build.function("flash_attention", "repro_flash_attention", _ARGTYPES)
    return _kernel


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the kernel; returns ``(B, Hq, S, D)`` in q's dtype like
    ``ref.flash_attention``.

    q is a contiguous ``(B, Hq, S, D)`` and k, v contiguous ``(B, Hkv, S,
    D)`` tensors of one dtype (float32 or bfloat16) on one CUDA device,
    with Hq a multiple of Hkv and D a multiple of 16 in [16, 256]; anything
    else raises.  The C entry point sends bfloat16 at D = 64 or 128 to the
    tensor-core kernel (its operands must be 16-byte aligned, as TMA reads
    them), and float32 at any D, and bfloat16 at any other D, to the
    CUDA-core kernel.  That is a choice by shape and type, made before the
    launch: a failed build or launch raises, whichever kernel it is.
    """
    global launches, launches_tc
    if q.dim() != 4:
        raise ValueError(f"flash_attention_cuda: q must be (B, Hq, S, D), got shape {tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_cuda: q is {q.dtype}, expected float32 or bfloat16")
    b, hq, s, d = (int(x) for x in q.shape)
    hkv = int(k.shape[1]) if k.dim() == 4 else 0
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention_cuda: {hq} q heads do not split into {hkv} kv heads")
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"flash_attention_cuda: head dim {d} is not a multiple of 16 in [16, 256]")
    if s < 1 or b < 1:
        raise ValueError(f"flash_attention_cuda: empty input of shape {tuple(q.shape)}")
    dev = q.device
    _require(q, "q", q.dtype, (b, hq, s, d), dev)
    _require(k, "k", q.dtype, (b, hkv, s, d), dev)
    _require(v, "v", q.dtype, (b, hkv, s, d), dev)
    if not q.is_cuda:
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)

    out = torch.empty_like(q)
    tensor_cores = _I(0)
    kernel = _bind()
    with torch.cuda.device(dev):
        kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, s, d, float(scale), int(bool(causal)), _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream, ctypes.byref(tensor_cores),
        )
    launches += 1
    launches_tc += tensor_cores.value
    return out
