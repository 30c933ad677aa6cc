"""Kernel dispatch: every caller reaches a kernel through this module.

Counterpart of ``repro.kernels.ops``.  The route follows the tensor, with
one explicit override:

* ``backend=None`` / ``"auto"``: a CUDA tensor goes to the CUDA kernel, a
  CPU tensor to the plain PyTorch version in ``ref``;
* ``backend="torch"``: the plain version on any device.  It is the one way
  to run the plain version on the card (used to hold the kernels to it).

There is no fallback: a CUDA tensor that reaches a kernel that fails to
build or launch raises.  Each kernel module counts its launches;
:func:`launch_counts` reads the counts and :func:`reset_launch_counts`
zeroes them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import em_tick as _em_tick
from repro_torch.kernels import ref
from repro_torch.kernels import segment_reduce as _segment_reduce

BACKENDS = ("auto", "torch")


def _use_kernel(backend: Optional[str], tensor: torch.Tensor) -> bool:
    """True when a call on ``tensor`` with ``backend`` goes to the kernel."""
    if backend in (None, "auto"):
        if tensor.device.type == "cuda":
            return True
        if tensor.device.type == "cpu":
            return False
        raise ValueError(
            f"no route for a tensor on {tensor.device}: the kernels are CUDA "
            "and the plain path runs on the CPU or with backend='torch'"
        )
    if backend == "torch":
        return False
    raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far in this process, by kernel name."""
    return {
        "fused_em_tick": _em_tick.launches,
        "segment_reduce": _segment_reduce.launches,
    }


def reset_launch_counts() -> None:
    _em_tick.launches = 0
    _segment_reduce.launches = 0


def segment_reduce(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    op: str = "add",
    *,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """1-D ReduceByKey (``add`` or ``min``) into ``num_segments`` buckets;
    ids outside ``[0, num_segments)`` are ignored."""
    if _use_kernel(backend, values):
        return _segment_reduce.segment_reduce_cuda(values, segment_ids, num_segments, op)
    return ref.segment_reduce(values, segment_ids, num_segments, op)


def fused_em_tick(
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
    n_hoods: int,
    n_vertices: int,
    offsets: Optional[torch.Tensor] = None,
    precision: str = "f32",
    conv_tol: float = 1.0e-4,
    backend: Optional[str] = None,
) -> Tuple[torch.Tensor, ...]:
    """One EM tick: ``(labels, hood_e, votes, conv, sum_w, sum_wy,
    sum_wyy)``.  The kernel needs ``offsets`` (the hoods' run boundaries in
    the sorted element arrays); the plain version ignores it."""
    if _use_kernel(backend, y):
        if offsets is None:
            raise ValueError("the fused_em_tick kernel needs the hoods' offsets")
        return _em_tick.fused_em_tick_cuda(
            y, w, nall_e, xf, valid, hood_id, vertex, region_mean, region_weight,
            hist, mu, sigma, beta, offsets=offsets, n_hoods=n_hoods,
            n_vertices=n_vertices, precision=precision, conv_tol=conv_tol,
        )
    return ref.fused_em_tick(
        y, w, nall_e, xf, valid, hood_id, vertex, region_mean, region_weight,
        hist, mu, sigma, beta, n_hoods=n_hoods, n_vertices=n_vertices,
        precision=precision, conv_tol=conv_tol,
    )
