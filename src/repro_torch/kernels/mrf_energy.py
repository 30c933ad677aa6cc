"""CUDA binary MRF energy: ``csrc/mrf_energy.cu`` bound through ``ctypes``.

Counterpart of ``repro.kernels.mrf_energy.mrf_min_energy_pallas``: both
label energies of every element and their minimum, in one elementwise
launch.  ``ref.mrf_min_energy`` is its plain version.
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
_ARGTYPES = [
    _P, _P, _P, _P, _P,            # y, w, n1, nall, xf
    _P, _P, _P, ctypes.c_float,    # mu, sigma, beta (a pointer, or None and the value)
    ctypes.c_longlong,             # n
    _P, _P,                        # min_e, arg
    _P,                            # stream
]
_kernel = None

_require = functools.partial(_build.require, "mrf_min_energy_cuda")


def _bind():
    global _kernel
    if _kernel is None:
        _kernel = _build.function("mrf_energy", "repro_mrf_min_energy", _ARGTYPES)
    return _kernel


def _output(n: int, dtype: torch.dtype, like: torch.Tensor) -> torch.Tensor:
    """An uninitialised (n,) tensor whose data starts at ``like``'s offset
    within 16 bytes, so that one scalar head brings every operand of the
    kernel to a 16-byte boundary (a view when ``like`` is one)."""
    skip = like.data_ptr() % 16 // like.element_size()
    out = torch.empty((n + skip,), dtype=dtype, device=like.device)
    return out[skip:] if skip else out


def mrf_min_energy_cuda(
    y: torch.Tensor,
    w: torch.Tensor,
    n1_e: torch.Tensor,
    nall_e: torch.Tensor,
    xf: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    beta,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel; returns ``(min_e, arg)`` like
    ``ref.mrf_min_energy``.  Element arrays are contiguous (H,) float32 on
    one CUDA device (views with a storage offset too), ``mu`` and ``sigma``
    (2,) float32.  ``beta`` is a number or a host tensor, passed by value,
    or a one-element float32 tensor on the same device, which the kernel
    reads.  When ``y`` does not start on a 16-byte boundary, ``min_e`` and
    ``arg`` are views with a storage offset of up to three elements into a
    buffer that much longer (:func:`_output`), not fresh tensors."""
    global launches
    if not y.is_cuda:
        raise ValueError(f"mrf_min_energy_cuda needs CUDA tensors, got {y.device}")
    dev = y.device
    h = int(y.shape[0])
    f32 = torch.float32
    for name, t in (("y", y), ("w", w), ("n1_e", n1_e), ("nall_e", nall_e), ("xf", xf)):
        _require(t, name, f32, (h,), dev)
    _require(mu, "mu", f32, (2,), dev)
    _require(sigma, "sigma", f32, (2,), dev)
    beta_ptr, beta_value = None, 0.0
    if isinstance(beta, torch.Tensor) and beta.is_cuda:
        _require(beta.reshape(1), "beta", f32, (1,), dev)
        beta_ptr = beta.data_ptr()
    else:
        beta_value = float(beta)

    min_e = _output(h, f32, y)
    arg = _output(h, torch.int32, y)
    if h == 0:
        return min_e, arg
    kernel = _bind()
    with torch.cuda.device(dev):
        kernel(
            y.data_ptr(), w.data_ptr(), n1_e.data_ptr(), nall_e.data_ptr(), xf.data_ptr(),
            mu.data_ptr(), sigma.data_ptr(), beta_ptr, beta_value, h,
            min_e.data_ptr(), arg.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    launches += 1
    return min_e, arg
