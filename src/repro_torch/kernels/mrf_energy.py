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
    _P, _P, _P,                    # mu, sigma, beta
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
    one CUDA device, ``mu`` and ``sigma`` (2,) float32."""
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
    beta_t = torch.as_tensor(beta, dtype=f32, device=dev).reshape(1).contiguous()

    min_e = torch.empty((h,), dtype=f32, device=dev)
    arg = torch.empty((h,), dtype=torch.int32, device=dev)
    kernel = _bind()
    with torch.cuda.device(dev):
        kernel(
            y.data_ptr(), w.data_ptr(), n1_e.data_ptr(), nall_e.data_ptr(), xf.data_ptr(),
            mu.data_ptr(), sigma.data_ptr(), beta_t.data_ptr(), h,
            min_e.data_ptr(), arg.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    launches += 1
    return min_e, arg
