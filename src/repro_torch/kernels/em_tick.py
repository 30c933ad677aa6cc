"""CUDA EM tick: ``csrc/em_tick.cu`` bound through ``ctypes``.

Counterpart of ``repro.kernels.em_tick.fused_em_tick_pallas``: the whole
tick of the static-pallas route (counts, energies, min/argmin, hood sums,
votes, labels, M-step sums, convergence flag) in two launches on the
current stream.  The kernel walks each hood as a contiguous run of the
(hood, vertex)-sorted element arrays, so besides the JAX signature it
takes ``offsets``, the (n_hoods + 1,) run boundaries (``Hoods.offsets``).
``ref.fused_em_tick`` is its plain version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

MAX_LABELS = 8  # the kernel is instantiated for K = 2 .. MAX_LABELS

#: Launches of the kernel in this process (``ops.launch_counts``).
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [
    _P, _P, _P, _P, _P, _P, _P,    # y, w, nall, xf, valid, vertex, offsets
    _P, _P, _P, _I,                # region_mean, region_weight, hist, hist_rows
    _P, _P, _P,                    # mu, sigma, beta
    _I, _I, _I, _I, ctypes.c_float,  # n_hoods, n_vertices, n_labels, bf16, conv_tol
    _P, _P, _P, _P, _P,            # labels, hood_e, votes, stats, conv
    _P,                            # stream
]
_kernel = None


def _bind():
    global _kernel
    if _kernel is None:
        _kernel = _build.function("em_tick", "repro_fused_em_tick", _ARGTYPES)
    return _kernel


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"fused_em_tick_cuda: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"fused_em_tick_cuda: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"fused_em_tick_cuda: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"fused_em_tick_cuda: {name} is not contiguous")


def fused_em_tick_cuda(
    y: torch.Tensor,
    w: torch.Tensor,
    nall_e: torch.Tensor,
    xf: torch.Tensor,
    valid: torch.Tensor,
    hood_id: torch.Tensor,
    vertex: torch.Tensor,
    region_mean: torch.Tensor,
    region_weight: torch.Tensor,
    hist: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    beta,
    *,
    offsets: torch.Tensor,
    n_hoods: int,
    n_vertices: int,
    precision: str = "f32",
    conv_tol: float = 1.0e-4,
) -> Tuple[torch.Tensor, ...]:
    """Launch the tick; returns ``(labels, hood_e, votes, conv, sum_w,
    sum_wy, sum_wyy)`` like ``ref.fused_em_tick``.

    Element arrays are (H,) float32 (int32 for ``hood_id``/``vertex``),
    sorted so that hood ``h`` owns elements ``offsets[h]:offsets[h+1]``
    (``offsets`` int32, non-decreasing, within ``[0, H]``).  ``hood_id`` is
    checked but not read: the run boundaries carry the hood of each element.
    """
    global launches
    if precision not in ("f32", "bf16"):
        raise ValueError(f"unknown precision {precision!r}; have ('f32', 'bf16')")
    if not y.is_cuda:
        raise ValueError(f"fused_em_tick_cuda needs CUDA tensors, got {y.device}")
    dev = y.device
    n_labels = int(mu.shape[0])
    if not 2 <= n_labels <= MAX_LABELS:
        raise ValueError(f"fused_em_tick_cuda takes 2..{MAX_LABELS} labels, got {n_labels}")
    h = int(y.shape[0])
    f32, i32 = torch.float32, torch.int32
    for name, t in (("y", y), ("w", w), ("nall_e", nall_e), ("xf", xf), ("valid", valid)):
        _require(t, name, f32, (h,), dev)
    _require(hood_id, "hood_id", i32, (h,), dev)
    _require(vertex, "vertex", i32, (h,), dev)
    _require(offsets, "offsets", i32, (n_hoods + 1,), dev)
    _require(region_mean, "region_mean", f32, (n_vertices,), dev)
    _require(region_weight, "region_weight", f32, (n_vertices,), dev)
    if hist.dim() != 2 or hist.shape[0] < 2:
        raise ValueError(f"fused_em_tick_cuda: hist must be (rows >= 2, n_hoods), got {tuple(hist.shape)}")
    _require(hist, "hist", f32, (hist.shape[0], n_hoods), dev)
    _require(mu, "mu", f32, (n_labels,), dev)
    _require(sigma, "sigma", f32, (n_labels,), dev)
    beta_t = torch.as_tensor(beta, dtype=f32, device=dev).reshape(1).contiguous()

    labels = torch.empty((n_vertices,), dtype=i32, device=dev)
    hood_e = torch.empty((n_hoods,), dtype=f32, device=dev)
    votes = torch.zeros((n_labels, n_vertices), dtype=f32, device=dev)
    stats = torch.empty((3, n_labels), dtype=f32, device=dev)
    conv = torch.empty((1,), dtype=i32, device=dev)
    kernel = _bind()
    with torch.cuda.device(dev):
        kernel(
            y.data_ptr(), w.data_ptr(), nall_e.data_ptr(), xf.data_ptr(),
            valid.data_ptr(), vertex.data_ptr(), offsets.data_ptr(),
            region_mean.data_ptr(), region_weight.data_ptr(), hist.data_ptr(),
            int(hist.shape[0]), mu.data_ptr(), sigma.data_ptr(), beta_t.data_ptr(),
            n_hoods, n_vertices, n_labels, int(precision == "bf16"), float(conv_tol),
            labels.data_ptr(), hood_e.data_ptr(), votes.data_ptr(),
            stats.data_ptr(), conv.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    launches += 1
    return labels, hood_e, votes, conv[0] != 0, stats[0], stats[1], stats[2]
