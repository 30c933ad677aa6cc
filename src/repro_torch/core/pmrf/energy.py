"""MRF energy model and the static-pallas EM tick (paper §3.2.2, Alg. 2).

Counterpart of the parts of ``repro.core.pmrf.energy`` that the
static-pallas route runs.  The energy of giving label ``l`` to hood
element ``e`` (vertex v) is

    E(e, l) = w_v * [ (y_v - mu_l)^2 / (2 sigma_l^2) + log(sigma_l) ]
            + beta * #{ u in hood(e), u != e : x_u != l } / max(|hood|-1, 1)

with y_v the region mean intensity, w_v the region pixel count normalized
to unit mean and x the current label field.  One MAP iteration of the
static-pallas route is one ``fused_em_tick`` launch; everything that does
not change across iterations lives in a :class:`StaticMapContext` built
once per solve.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dpp
from repro_torch.core.pmrf.hoods import Hoods
from repro_torch.kernels import ops as kops

Tensor = torch.Tensor


class EnergyModel(NamedTuple):
    """Static per-problem arrays consumed by the EM loop.

    Region arrays are extended by one sentinel lane (index n_regions)
    holding zeros, so gathers by padding lanes stay in bounds.
    """

    region_mean: Tensor    # (V+1,) float32, sentinel 0
    region_weight: Tensor  # (V+1,) float32, unit-mean pixel counts, sentinel 0
    beta: Tensor           # () float32 smoothness weight
    sigma_min: Tensor      # () float32 lower bound on sigma
    reseed_mu: Tensor      # (K,) float32 data quantiles over [q10, q90]: the
                           # re-seed target of a label whose cluster dies
    reseed_sigma: Tensor   # () float32

    @property
    def n_labels(self) -> int:
        return int(self.reseed_mu.shape[0])


def make_energy_model(
    region_mean: Tensor,
    region_size: Tensor,
    *,
    beta: float = 0.75,
    sigma_min: float = 2.0,
    n_labels: int = 2,
) -> EnergyModel:
    if n_labels < 2:
        raise ValueError(f"n_labels must be >= 2, got {n_labels}")
    y = region_mean.to(torch.float32)
    dev = y.device
    zero = torch.zeros((1,), dtype=torch.float32, device=dev)
    w = region_size.to(torch.float32)
    w = w / torch.clamp_min(w.mean(), 1e-6)
    # np.linspace pins the endpoints, so K=2 asks for exactly 0.10 / 0.90.
    qs = np.linspace(0.10, 0.90, n_labels)
    return EnergyModel(
        region_mean=torch.cat([y, zero]),
        region_weight=torch.cat([w, zero]),
        beta=torch.tensor(beta, dtype=torch.float32, device=dev),
        sigma_min=torch.tensor(sigma_min, dtype=torch.float32, device=dev),
        reseed_mu=torch.stack([torch.quantile(y, float(q)) for q in qs]),
        reseed_sigma=torch.clamp_min(y.std(correction=0) / 2.0, sigma_min),
    )


class StaticMapContext(NamedTuple):
    """EM-invariant per-element arrays, built once per solve."""

    y: Tensor       # (H,) gathered region mean per hood element
    w: Tensor       # (H,) gathered region weight, 0 on padding
    validf: Tensor  # (H,) 1.0/0.0 validity mask
    nall_e: Tensor  # (H,) neighborhood size per element


def make_static_context(
    hoods: Hoods, model: EnergyModel, *, backend: Optional[str] = None
) -> StaticMapContext:
    """Gather the region statistics per element and count each hood's
    size (one ``segment_reduce`` launch on the CUDA route)."""
    v = hoods.vertex.long()
    validf = hoods.valid.to(torch.float32)
    nall = dpp.reduce_by_key(
        hoods.hood_id, validf, hoods.n_hoods + 1, op="add", backend=backend
    )
    return StaticMapContext(
        y=model.region_mean[v],
        w=model.region_weight[v] * validf,
        validf=validf,
        nall_e=nall[hoods.hood_id.long()],
    )


def em_tick_fused(
    hoods: Hoods,
    model: EnergyModel,
    sctx: StaticMapContext,
    labels: Tensor,
    mu: Tensor,
    sigma: Tensor,
    hist: Tensor,
    *,
    backend: Optional[str] = None,
    precision: str = "f32",
    conv_tol: float = 1.0e-4,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """One whole EM tick in one kernel call: counts, energies, hood sums,
    votes, new labels, M-step sums and the window predicate over ``hist``
    (the ring before this iteration's roll).

    Returns ``(labels, hood_e, conv, sum_w, sum_wy, sum_wyy)``.
    """
    x = labels[hoods.vertex.long()]
    xf = x.to(torch.float32) * sctx.validf
    sig = torch.maximum(sigma, model.sigma_min)
    new_labels, hood_e, _votes, conv, sum_w, sum_wy, sum_wyy = kops.fused_em_tick(
        sctx.y,
        sctx.w,
        sctx.nall_e,
        xf,
        sctx.validf,
        hoods.hood_id,
        hoods.vertex,
        model.region_mean,
        model.region_weight,
        hist,
        mu,
        sig,
        model.beta,
        n_hoods=hoods.n_hoods,
        n_vertices=hoods.n_regions + 1,
        offsets=hoods.offsets,
        precision=precision,
        conv_tol=conv_tol,
        backend=backend,
    )
    return new_labels, hood_e, conv, sum_w, sum_wy, sum_wyy


def params_from_stats(
    model: EnergyModel, sum_w: Tensor, sum_wy: Tensor, sum_wyy: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """The M-step's closed form from its three per-label accumulators,
    with cluster-death re-seeding: a label that captured (almost) no mass
    goes back to its data quantile.  Returns ``(mu, sigma, sum_w)``."""
    safe_w = torch.clamp_min(sum_w, 1e-6)
    mu = sum_wy / safe_w
    # E[y^2] - mu^2 cancels badly, so it is formed with one rounding, as
    # the reference's compiled M-step forms it (XLA contracts it into a
    # fused multiply-add): float32 operands are exact in float64.
    var = (sum_wyy / safe_w).double() - mu.double() * mu.double()
    var = torch.clamp_min(var.float(), 0.0)
    sigma = torch.maximum(torch.sqrt(var), model.sigma_min)
    dead = sum_w < 1e-3 * torch.sum(sum_w)
    mu = torch.where(dead, model.reseed_mu, mu)
    sigma = torch.where(dead, model.reseed_sigma, sigma)
    return mu, sigma, sum_w
