"""MRF energy model and the static-pallas EM tick (paper §3.2.2, Alg. 2).

Counterpart of the parts of ``repro.core.pmrf.energy`` that the
static-pallas route runs.  The energy of giving label ``l`` to hood
element ``e`` (vertex v) is

    E(e, l) = w_v * [ (y_v - mu_l)^2 / (2 sigma_l^2) + log(sigma_l) ]
            + beta * #{ u in hood(e), u != e : x_u != l } / max(|hood|-1, 1)

with y_v the region mean intensity, w_v the region pixel count normalized
to unit mean and x the current label field.  Everything that does not
change across iterations lives in a :class:`StaticMapContext` built once
per solve.  One MAP iteration of the static-pallas route is

* on one device, one ``fused_em_tick`` launch on the plan's workspace
  (``kernels.ops.tick_workspace``): the label gather, the history ring
  and the flag are in the kernel, which also yields the M-step sums;
* sharded, one ``fused_map_step`` launch on the rank's workspace
  (``kernels.ops.map_step_workspace``: the last step's labels and tests,
  this step's label counts over whole hood runs, energies, hood sums and
  votes) and one all-reduce of its hood sums and votes; the M-step is then
  :func:`update_parameters_stats`.

:func:`map_step_operands` and :func:`map_step_fused` are the sharded MAP
step as a composition of separate operations (counts by a keyed reduction
and an all-reduce, the JAX-signature kernel, two all-reduces, the argmax),
which the workspace replaced on the route; the tests and ``chip_smoke.py``
hold the workspace to them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dpp
from repro_torch.core.pmrf.collectives import LOCAL, ReduceCtx
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
        return int(self.reseed_mu.shape[-1])


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
    hoods: Hoods,
    model: EnergyModel,
    *,
    backend: Optional[str] = None,
    ctx: ReduceCtx = LOCAL,
) -> StaticMapContext:
    """Gather the region statistics per element and count each hood's
    size (one ``segment_reduce`` launch on the CUDA route, all-reduced
    when sharded)."""
    v = hoods.vertex.long()
    validf = hoods.valid.to(torch.float32)
    nall = ctx.segment_sum(hoods.hood_id, validf, hoods.n_hoods + 1, backend=backend)
    return StaticMapContext(
        y=model.region_mean[v],
        w=model.region_weight[v] * validf,
        validf=validf,
        nall_e=nall[hoods.hood_id.long()],
    )


def map_step_operands(
    hoods: Hoods,
    model: EnergyModel,
    sctx: StaticMapContext,
    labels: Tensor,
    mu: Tensor,
    sigma: Tensor,
    *,
    backend: Optional[str] = None,
    ctx: ReduceCtx = LOCAL,
) -> Tuple[tuple, dict]:
    """The ``fused_map_step`` call of one MAP iteration, as ``(args,
    kwargs)``: the per-(hood, label) counts are one keyed reduction (K
    folded into the key space), all-reduced across ranks when sharded,
    and gathered per element into the kernel's (K, H) layout."""
    n_labels = int(mu.shape[0])
    x = labels[hoods.vertex.long()]
    xf = x.to(torch.float32) * sctx.validf
    key = dpp.compound_key(hoods.hood_id, x, n_labels, major_span=hoods.n_hoods + 1)
    counts = ctx.segment_sum(
        key, sctx.validf, (hoods.n_hoods + 1) * n_labels, backend=backend
    ).reshape(hoods.n_hoods + 1, n_labels)
    cnt_e = counts[hoods.hood_id.long()].T.contiguous()
    sig = torch.maximum(sigma, model.sigma_min)
    args = (sctx.y, sctx.w, cnt_e, sctx.nall_e, xf, sctx.validf, hoods.hood_id,
            hoods.vertex, mu, sig, model.beta)
    return args, dict(n_hoods=hoods.n_hoods, n_vertices=hoods.n_regions + 1)


def map_step_fused(
    hoods: Hoods,
    model: EnergyModel,
    sctx: StaticMapContext,
    labels: Tensor,
    mu: Tensor,
    sigma: Tensor,
    *,
    backend: Optional[str] = None,
    ctx: ReduceCtx = LOCAL,
) -> Tuple[Tensor, Tensor]:
    """One MAP iteration of the sharded static-pallas route as separate
    operations: ``(new labels, hood sums)``.

    The global label counts come first (:func:`map_step_operands`); the
    kernel then runs on this rank's elements, and its hood sums and
    (K, V+1) votes are all-reduced after it: the collectives stay outside
    the launch.  Votes are integer-valued, so every rank takes the same
    plurality labels (ties to the lowest label; the sentinel vertex 0).
    """
    args, kw = map_step_operands(
        hoods, model, sctx, labels, mu, sigma, backend=backend, ctx=ctx
    )
    _min_e, _arg, hood_e, votes = kops.fused_map_step(*args, **kw, backend=backend)
    hood_e = ctx.psum(hood_e)
    votes = ctx.psum(votes)
    new = torch.argmax(votes, dim=0).to(torch.int32)  # first maximum on ties
    new[hoods.n_regions] = 0
    return new, hood_e


def update_parameters_stats(
    model: EnergyModel, labels: Tensor, mode: str, *, backend: Optional[str] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """M-step from the labels: per-label weighted region sums (three
    ReduceByKey launches), then :func:`params_from_stats`.  ``faithful``
    groups the regions by SortByKey(label) first, as the paper does; the
    other modes key by label directly.  Returns ``(mu, sigma, sum_w)``.
    """
    n_labels = model.n_labels
    y, w = model.region_mean, model.region_weight  # sentinel lane has weight 0
    if mode == "faithful":
        seg, y, w = dpp.sort_by_key(labels, y, w)
    else:
        seg = labels
    sum_w = dpp.reduce_by_key(seg, w, n_labels, op="add", backend=backend)
    sum_wy = dpp.reduce_by_key(seg, w * y, n_labels, op="add", backend=backend)
    sum_wyy = dpp.reduce_by_key(seg, w * y * y, n_labels, op="add", backend=backend)
    return params_from_stats(model, sum_w, sum_wy, sum_wyy)


#: Label counts up to which :func:`label_total` adds the labels one by one.
SEQUENTIAL_LABELS = 8


def label_total(sum_w: Tensor) -> Tensor:
    """The total mass over the labels (last axis, kept), the same bits
    whatever the batch shape: up to ``SEQUENTIAL_LABELS`` labels added one
    at a time in label order (K - 1 elementwise adds), above that summed in
    float64 and rounded once (a device reduction's order depends on the
    tensor's shape)."""
    n_labels = int(sum_w.shape[-1])
    if n_labels > SEQUENTIAL_LABELS:
        return torch.sum(sum_w, dim=-1, keepdim=True, dtype=torch.float64).to(torch.float32)
    total = sum_w[..., :1]
    for l in range(1, n_labels):
        total = total + sum_w[..., l:l + 1]
    return total


def params_from_stats(
    model: EnergyModel, sum_w: Tensor, sum_wy: Tensor, sum_wyy: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """The M-step's closed form from its three per-label accumulators,
    with cluster-death re-seeding: a label that captured (almost) no mass
    goes back to its data quantile.  Returns ``(mu, sigma, sum_w)``.
    Elementwise over any leading lane axis: for a stack, the accumulators
    are (B, K) and the model's tensors carry the lane axis."""
    safe_w = torch.clamp_min(sum_w, 1e-6)
    mu = sum_wy / safe_w
    # E[y^2] - mu^2 cancels badly, so it is formed with one rounding, as
    # the reference's compiled M-step forms it (XLA contracts it into a
    # fused multiply-add): float32 operands are exact in float64.
    var = (sum_wyy / safe_w).double() - mu.double() * mu.double()
    var = torch.clamp_min(var.float(), 0.0)
    sigma = torch.maximum(torch.sqrt(var), model.sigma_min[..., None])
    dead = sum_w < 1e-3 * label_total(sum_w)
    mu = torch.where(dead, model.reseed_mu, mu)
    sigma = torch.where(dead, model.reseed_sigma[..., None], sigma)
    return mu, sigma, sum_w


def make_static_context_batched(
    hoods: Hoods, model: EnergyModel, *, backend: Optional[str] = None
) -> StaticMapContext:
    """:func:`make_static_context` of a stack (``hoods`` and ``model`` with
    a leading lane axis): the neighbourhood sizes of every lane in one
    ``segment_reduce`` launch over lane-offset hood ids (integer-valued, so
    exact in any order)."""
    n_seg = hoods.n_hoods + 1
    batch = int(hoods.vertex.shape[0])
    v, hid = hoods.vertex.long(), hoods.hood_id.long()
    validf = hoods.valid.to(torch.float32)
    lane = torch.arange(batch, device=hid.device)[:, None] * n_seg
    keys = (hid + lane).to(torch.int32).reshape(-1)
    nall = kops.segment_reduce(validf.reshape(-1), keys, batch * n_seg, backend=backend)
    return StaticMapContext(
        y=torch.gather(model.region_mean, 1, v),
        w=torch.gather(model.region_weight, 1, v) * validf,
        validf=validf,
        nall_e=torch.gather(nall.reshape(batch, n_seg), 1, hid),
    )


#: Data-term sentinel of inert (padded) labels (mixed-K stacks): a label
#: with mu = INERT_MU is ~1e8 intensity units from any region mean, so it
#: never wins an argmin, collects no mass and re-seeds back to itself;
#: the real labels keep their natural-K trajectory.
INERT_MU = 1.0e8


def pad_model(model: EnergyModel, n_regions: int) -> EnergyModel:
    """Zero-extend the sentinel-extended region arrays to ``n_regions + 1``:
    the appended vertices have weight 0, so every weighted sum is unchanged
    (the tick adds them in vertex order as +0)."""
    cur = int(model.region_mean.shape[0]) - 1
    if n_regions < cur:
        raise ValueError(f"cannot shrink model from {cur} to {n_regions} regions")
    if n_regions == cur:
        return model
    z = model.region_mean.new_zeros((n_regions - cur,))
    return model._replace(
        region_mean=torch.cat([model.region_mean, z]),
        region_weight=torch.cat([model.region_weight, z]),
    )


def pad_model_labels(model: EnergyModel, n_labels: int) -> EnergyModel:
    """Extend the model's label axis to ``n_labels`` with inert labels: the
    padded re-seed targets are :data:`INERT_MU`."""
    cur = model.n_labels
    if n_labels < cur:
        raise ValueError(f"cannot shrink label axis from {cur} to {n_labels}")
    if n_labels == cur:
        return model
    pad = model.reseed_mu.new_full((n_labels - cur,), INERT_MU)
    return model._replace(reseed_mu=torch.cat([model.reseed_mu, pad]))


def pad_params_labels(mu0: Tensor, sigma0: Tensor, n_labels: int) -> Tuple[Tensor, Tensor]:
    """Extend initial ``(mu, sigma)`` to ``n_labels`` with inert labels (mu
    :data:`INERT_MU`, sigma 1), the companion of :func:`pad_model_labels`."""
    cur = int(mu0.shape[0])
    if n_labels < cur:
        raise ValueError(f"cannot shrink label axis from {cur} to {n_labels}")
    if n_labels == cur:
        return mu0, sigma0
    mu = torch.cat([mu0.to(torch.float32), mu0.new_full((n_labels - cur,), INERT_MU, dtype=torch.float32)])
    sigma = torch.cat([sigma0.to(torch.float32), sigma0.new_ones((n_labels - cur,), dtype=torch.float32)])
    return mu, sigma
