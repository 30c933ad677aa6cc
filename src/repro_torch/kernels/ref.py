"""Plain PyTorch versions of the CUDA kernels.

Each function here is the contract its kernel is held to, and the path a
CPU tensor takes through ``ops``.  The keyed reductions use
``index_add_``, which on the CPU accumulates in element order, the order
``jax.ops.segment_sum`` uses on the CPU; so on the host these functions
agree with ``repro.kernels.ref`` bit for bit wherever the elementwise
arithmetic does.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def _spare_bucket(keys: Tensor, num_segments: int) -> Tensor:
    """``keys`` as int64, with those outside ``[0, num_segments)`` sent to
    one spare bucket ``num_segments`` that the caller drops."""
    keys = keys.long()
    return torch.where((keys >= 0) & (keys < num_segments), keys, num_segments)


def keyed_sum(values: Tensor, keys: Tensor, num_segments: int) -> Tensor:
    """Segment sum into ``num_segments`` buckets (any dtype); keys outside
    ``[0, num_segments)`` are dropped."""
    out = torch.zeros(num_segments + 1, dtype=values.dtype, device=values.device)
    return out.index_add_(0, _spare_bucket(keys, num_segments), values)[:num_segments]


def segment_reduce(
    values: Tensor, segment_ids: Tensor, num_segments: int, op: str = "add"
) -> Tensor:
    """1-D ReduceByKey.  Ids outside ``[0, num_segments)`` are ignored;
    empty segments give 0 (``add``) or +inf (``min``)."""
    if op == "add":
        return keyed_sum(values, segment_ids, num_segments)
    if op == "min":
        out = torch.full(
            (num_segments + 1,), float("inf"), dtype=values.dtype, device=values.device
        )
        ids = _spare_bucket(segment_ids, num_segments)
        return out.scatter_reduce_(0, ids, values, "amin", include_self=True)[:num_segments]
    raise ValueError(f"unknown segment_reduce op {op!r}; have ('add', 'min')")


def label_energies_blocked(
    y: Tensor,
    w: Tensor,
    cnt: Tensor,
    nall: Tensor,
    xf: Tensor,
    valid: Tensor,
    mu: Tensor,
    sig: Tensor,
    beta,
    *,
    precision: str = "f32",
) -> Tensor:
    """(K, N) label energies from label-blocked inputs.

    The op order of the JAX helper it mirrors, one PyTorch op per JAX op:
    ``w*(d*d/(2*sig*sig) + log sig) + beta*max((nall-cnt)-(1-eq),0)/denom*valid``
    with ``denom = max(nall-1, 1)``.  ``precision="bf16"`` casts every
    operand to bfloat16, so each op rounds to bfloat16; callers cast the
    result back to float32 before accumulating.
    """
    cd = torch.bfloat16 if precision == "bf16" else torch.float32
    y = y.to(cd)
    w = w.to(cd)
    nall = nall.to(cd)
    xf = xf.to(cd)
    valid = valid.to(cd)
    cnt = cnt.to(cd)
    mu = mu.to(cd)[:, None]
    sig = sig.to(cd)[:, None]
    beta = torch.as_tensor(beta, device=y.device).to(cd)
    labf = torch.arange(cnt.shape[0], device=y.device, dtype=torch.float32).to(cd)[:, None]
    denom = torch.clamp_min(nall - 1.0, 1.0)
    d = y[None, :] - mu
    eq = (xf[None, :] == labf).to(cd)
    return w[None, :] * (d * d / (2.0 * sig * sig) + torch.log(sig)) + beta * torch.clamp_min(
        (nall[None, :] - cnt) - (1.0 - eq), 0.0
    ) / denom[None, :] * valid[None, :]


def fused_em_tick(
    y: Tensor,
    w: Tensor,
    nall_e: Tensor,
    xf: Tensor,
    valid: Tensor,
    hood_id: Tensor,
    vertex: Tensor,
    region_mean: Tensor,
    region_weight: Tensor,
    hist: Tensor,
    mu: Tensor,
    sigma: Tensor,
    beta,
    *,
    n_hoods: int,
    n_vertices: int,
    precision: str = "f32",
    conv_tol: float = 1.0e-4,
) -> Tuple[Tensor, ...]:
    """One EM tick: per-(hood, label) counts, K energies, per-element
    min/argmin (ties to the lowest label), per-hood energy sums, votes,
    plurality labels (sentinel vertex ``n_vertices - 1`` set to 0), the
    M-step sums and the convergence-window flag over ``hist``.

    Returns ``(labels, hood_e, votes, conv, sum_w, sum_wy, sum_wyy)``.
    The CUDA kernel's ``offsets`` layout argument has no counterpart here:
    this version reads the hood of each element from ``hood_id``.
    """
    n_labels = int(mu.shape[0])
    seg_h = torch.where(valid > 0, hood_id.long(), n_hoods)
    xi = torch.clamp(xf.to(torch.int32), 0, n_labels - 1).long()
    counts = keyed_sum(
        valid, seg_h * n_labels + xi, (n_hoods + 1) * n_labels
    ).reshape(n_hoods + 1, n_labels)
    cnt_e = counts[torch.clamp(hood_id.long(), 0, n_hoods - 1)].T  # (K, H)

    energies = label_energies_blocked(
        y, w, cnt_e, nall_e, xf, valid, mu, sigma, beta, precision=precision
    )
    min_e, arg = torch.min(energies, dim=0)  # first minimum on ties
    min_e = min_e.to(torch.float32)

    hood_e = keyed_sum(min_e * valid, seg_h, n_hoods + 1)[:n_hoods]
    seg_v = torch.where(valid > 0, vertex.long(), n_vertices)
    votes = (
        keyed_sum(valid, seg_v * n_labels + arg, (n_vertices + 1) * n_labels)
        .reshape(n_vertices + 1, n_labels)
        .T[:, :n_vertices]
    )
    labels = torch.argmax(votes, dim=0).to(torch.int32)  # first maximum on ties
    labels[n_vertices - 1] = 0

    lab = labels.long()
    sum_w = keyed_sum(region_weight, lab, n_labels)
    sum_wy = keyed_sum(region_weight * region_mean, lab, n_labels)
    sum_wyy = keyed_sum(region_weight * region_mean * region_mean, lab, n_labels)

    scale = torch.clamp_min(torch.abs(hood_e), 1.0)
    ok = torch.abs(hood_e - hist[0, :n_hoods]) < conv_tol * scale
    for r in range(int(hist.shape[0]) - 2):
        ok = ok & (torch.abs(hist[r, :n_hoods] - hist[r + 1, :n_hoods]) < conv_tol * scale)
    conv = torch.all(ok)
    return labels, hood_e, votes.contiguous(), conv, sum_w, sum_wy, sum_wyy
