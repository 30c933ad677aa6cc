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
zeroes them (``flash_attention.launches_tc`` too, the tensor-core share
of the flash launches).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import em_tick as _em_tick
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import map_step as _map_step
from repro_torch.kernels import mrf_energy as _mrf_energy
from repro_torch.kernels import ref
from repro_torch.kernels import segment_reduce as _segment_reduce

BACKENDS = ("auto", "torch")
FLAG_CONVERGED, FLAG_DIVERGED = ref.FLAG_CONVERGED, ref.FLAG_DIVERGED


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
        "flash_attention": _flash_attention.launches,
        "fused_em_tick": _em_tick.launches,
        "fused_map_step": _map_step.launches,
        "mrf_min_energy": _mrf_energy.launches,
        "segment_reduce": _segment_reduce.launches,
    }


def reset_launch_counts() -> None:
    for module in (_em_tick, _flash_attention, _map_step, _mrf_energy, _segment_reduce):
        module.launches = 0
    _flash_attention.launches_tc = 0


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


def tick_workspace(
    hoods,
    model,
    *,
    precision: str = "f32",
    conv_tol: float = 1.0e-4,
    window: int = 3,
    backend: Optional[str] = None,
):
    """The single-device EM driver's MAP-iteration workspace for a plan's
    ``hoods`` and energy ``model``: :class:`em_tick.TickWorkspace` (one
    kernel launch per MAP iteration) for CUDA tensors, else
    :class:`ref.PlainTickWorkspace` (``ref.fused_map_iteration``)."""
    cls = _em_tick.TickWorkspace if _use_kernel(backend, hoods.vertex) else ref.PlainTickWorkspace
    return cls(hoods, model, precision=precision, conv_tol=conv_tol, window=window)


def map_step_workspace(
    hoods,
    model,
    *,
    rank: int = 0,
    n_shards: int = 1,
    conv_tol: float = 1.0e-4,
    window: int = 3,
    backend: Optional[str] = None,
):
    """The sharded EM driver's MAP-iteration workspace for rank ``rank`` of
    a partition (``distributed.partition_hoods(hoods, n_shards)``):
    :class:`map_step.MapStepWorkspace` (one kernel launch per MAP
    iteration) for CUDA tensors, else :class:`ref.PlainMapStepWorkspace`."""
    cls = _map_step.MapStepWorkspace if _use_kernel(backend, hoods.vertex) else ref.PlainMapStepWorkspace
    return cls(hoods, model, rank=rank, n_shards=n_shards, conv_tol=conv_tol, window=window)


def fused_map_step(
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
    backend: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One MAP step from per-element label counts ``cnt_e`` (K, H):
    ``(min_e, arg, hood_e, votes)`` with ``votes`` (K, n_vertices)."""
    if _use_kernel(backend, y):
        return _map_step.fused_map_step_cuda(
            y, w, cnt_e, nall_e, xf, valid, hood_id, vertex, mu, sigma, beta,
            n_hoods=n_hoods, n_vertices=n_vertices,
        )
    return ref.fused_map_step(
        y, w, cnt_e, nall_e, xf, valid, hood_id, vertex, mu, sigma, beta,
        n_hoods=n_hoods, n_vertices=n_vertices,
    )


def mrf_min_energy(
    y: torch.Tensor,
    w: torch.Tensor,
    n1_e: torch.Tensor,
    nall_e: torch.Tensor,
    xf: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    beta,
    *,
    backend: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary energies and their per-element minimum: ``(min_e, arg)``."""
    if _use_kernel(backend, y):
        return _mrf_energy.mrf_min_energy_cuda(y, w, n1_e, nall_e, xf, mu, sigma, beta)
    return ref.mrf_min_energy(y, w, n1_e, nall_e, xf, mu, sigma, beta)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Attention ``softmax(scale * Q K^T) V`` with the GQA head map: q
    ``(B, Hq, S, D)``, k/v ``(B, Hkv, S, D)``; output in q's dtype."""
    if _use_kernel(backend, q):
        return _flash_attention.flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    return ref.flash_attention(q, k, v, causal=causal, scale=scale)
