"""MRF energy model and the MAP/EM inner computations (paper §3.2.2, Alg. 2).

Counterpart of ``repro.core.pmrf.energy``.  The energy of giving label
``l`` to hood element ``e`` (vertex v) is

    E(e, l) = w_v * [ (y_v - mu_l)^2 / (2 sigma_l^2) + log(sigma_l) ]
            + beta * #{ u in hood(e), u != e : x_u != l } / max(|hood|-1, 1)

with y_v the region mean intensity, w_v the region pixel count normalized
to unit mean and x the current label field.  Everything that does not
change across iterations lives in a :class:`StaticMapContext` built once
per solve.

The modes ``static`` and ``faithful`` run one MAP iteration as the
paper's primitive sequence (``em.map_step``): :func:`hood_label_counts`
(ReduceByKey), :func:`label_energies` (Map), the per-element minimum
(:func:`min_energies_static`, an axis-min; or :func:`min_energies_faithful`,
Gather, SortByKey and ReduceByKey(Min)), :func:`hood_energy_sums`
(ReduceByKey in element order) and :func:`vote_labels` (Scatter).  One MAP
iteration of the static-pallas route is

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


def hood_label_counts(
    hoods: Hoods,
    labels: Tensor,
    n_labels: int,
    *,
    backend: Optional[str] = None,
    ctx: ReduceCtx = LOCAL,
) -> Tuple[Tensor, Tensor]:
    """Per-(hood, label) counts and per-hood sizes, collective touch point
    1: one keyed sum with K folded into the key (``dpp.compound_key``,
    key = hood_id * K + x) and one keyed sum by hood.  Integer-valued, so
    the order-free ``add`` and the all-reduce of rank partials are exact.
    Returns ``(counts, nall)``, (n_hoods + 1, K) and (n_hoods + 1,)."""
    x = labels[hoods.vertex.long()]
    ones = hoods.valid.to(torch.float32)
    key = dpp.compound_key(hoods.hood_id, x, n_labels, major_span=hoods.n_hoods + 1)
    counts = ctx.segment_sum(
        key, ones, (hoods.n_hoods + 1) * n_labels, backend=backend
    ).reshape(hoods.n_hoods + 1, n_labels)
    nall = ctx.segment_sum(hoods.hood_id, ones, hoods.n_hoods + 1, backend=backend)
    return counts, nall


def label_energies(
    hoods: Hoods,
    model: EnergyModel,
    labels: Tensor,
    mu: Tensor,
    sigma: Tensor,
    hood_counts: Optional[Tuple[Tensor, Tensor]] = None,
    *,
    backend: Optional[str] = None,
    log_sigma: Optional[Tensor] = None,
) -> Tensor:
    """The (K, H) energies of every candidate label, the Map of the paper's
    "Compute Energy Function" step, one PyTorch op per op of the
    reference in its order.  ``hood_counts`` is :func:`hood_label_counts`'s
    result (through the driver's collective context when sharded); without
    it the counts are taken here.  ``log_sigma`` (K,), when given, stands
    for the log of each clamped sigma: a step on the host can take the bits
    another device's ``log`` gave."""
    n_labels = int(mu.shape[0])
    v = hoods.vertex.long()
    validf = hoods.valid.to(torch.float32)
    y = model.region_mean[v]
    w = model.region_weight[v] * validf
    x = labels[v]
    sig = torch.maximum(sigma, model.sigma_min)
    if hood_counts is None:
        hood_counts = hood_label_counts(hoods, labels, n_labels, backend=backend)
    counts, nall = hood_counts
    hid = hoods.hood_id.long()
    cnt_e = counts[hid]
    nall_e = nall[hid]
    # Disagreements are normalised by the number of other elements of the
    # hood; every operand of the smoothness term is an integer-valued float.
    denom = torch.clamp_min(nall_e - 1.0, 1.0)

    def label_energy(l: int) -> Tensor:
        d = y - mu[l]
        log_s = torch.log(sig[l]) if log_sigma is None else log_sigma[l]
        data = w * (d * d / (2.0 * sig[l] * sig[l]) + log_s)
        eq = (x == l).to(torch.float32)
        others_diff = (nall_e - cnt_e[:, l]) - (1.0 - eq)
        return data + model.beta * torch.clamp_min(others_diff, 0.0) / denom * validf

    return torch.stack([label_energy(l) for l in range(n_labels)])


def min_energies_static(energies: Tensor) -> Tuple[Tensor, Tensor]:
    """Per element, the minimum over the labels and its label (the first on
    ties): an axis-min, no sort."""
    min_e, arg = torch.min(energies, dim=0)
    return min_e, arg.to(torch.int32)


#: The energy of an invalid replication lane (the reference's).
_BIG = 3.4e38


def min_energies_faithful(
    hoods: Hoods, energies: Tensor, *, backend: Optional[str] = None
) -> Tuple[Tensor, Tensor]:
    """The paper's per-element minimum: replicate each element's K label
    energies (Gather), SortByKey by element so that they are adjacent, and
    ReduceByKey(Min) over ``capacity + 1`` segments (the
    ``segment_reduce`` kernel's ``min`` on the card); then the label of the
    first energy equal to the minimum.

    K = 2 gathers through the plan's replication arrays
    (``Hoods.rep_old_index`` / ``rep_test_label`` / ``rep_valid``, the
    paper's layout, relocalised per rank by ``distributed.partition_hoods``);
    K > 2 tiles the (K, H) energies.  The minimum is one of its inputs'
    bits, so the match finds it and the result equals the static mode's."""
    n_labels = int(energies.shape[0])
    h_pad = hoods.capacity
    big = torch.tensor(_BIG, dtype=energies.dtype, device=energies.device)
    if n_labels == 2:
        rep_e = energies[hoods.rep_test_label.long(), hoods.rep_old_index.long()]
        rep_e = torch.where(hoods.rep_valid, rep_e, big)
        rep_key = torch.where(hoods.rep_valid, hoods.rep_old_index, h_pad).to(torch.int32)
    else:
        lane = torch.arange(h_pad, dtype=torch.int32, device=energies.device)
        rep_key = torch.where(hoods.valid, lane, h_pad).to(torch.int32).repeat(n_labels)
        rep_e = torch.where(hoods.valid[None, :], energies, big).reshape(-1)
    sk, se = dpp.sort_by_key(rep_key, rep_e)
    min_e = dpp.reduce_by_key(sk, se, h_pad + 1, op="min", backend=backend)[:h_pad]
    min_e = torch.where(hoods.valid, min_e, torch.zeros((), dtype=min_e.dtype, device=min_e.device))
    # The first label whose energy equals the minimum (ties to the lowest).
    arg = torch.argmax((energies == min_e[None, :]).to(torch.int32), dim=0)
    arg = torch.where(hoods.valid, arg, 0).to(torch.int32)
    return min_e, arg


def hood_energy_sums(
    hoods: Hoods,
    min_e: Tensor,
    *,
    backend: Optional[str] = None,
    ctx: ReduceCtx = LOCAL,
) -> Tensor:
    """Per-hood sums of the elements' minimum energies, collective touch
    point 2: ReduceByKey(Add) in element order (the ``segment_reduce``
    kernel's ordered ``add`` on the card, ``index_add_`` on the CPU: the
    reference's order), all-reduced when sharded.  (n_hoods,)."""
    vals = torch.where(hoods.valid, min_e, torch.zeros((), dtype=min_e.dtype, device=min_e.device))
    return ctx.segment_sum(
        hoods.hood_id, vals, hoods.n_hoods + 1, backend=backend, ordered=True
    )[: hoods.n_hoods]


def vote_labels(
    hoods: Hoods,
    arg: Tensor,
    n_regions: int,
    n_labels: int,
    *,
    ctx: ReduceCtx = LOCAL,
) -> Tensor:
    """Update Output Labels, the Scatter of the paper's step 3: each hood
    element votes for its argmin label at its vertex (key = vertex * K +
    arg, ``dpp.compound_key``), collective touch point 3 (integer votes,
    so the all-reduce is exact), and each vertex takes its plurality label
    (ties to the lowest).  The paper's racing scatters are resolved by the
    vote.  Returns (V+1,) int32 labels, the sentinel lane 0."""
    key = dpp.compound_key(
        hoods.vertex, torch.where(hoods.valid, arg, 0), n_labels, major_span=n_regions + 1
    )
    votes = ctx.vote_scatter(
        hoods.valid.to(torch.float32), key, (n_regions + 1) * n_labels
    ).reshape(n_regions + 1, n_labels)
    new = torch.argmax(votes, dim=1).to(torch.int32)  # first maximum on ties
    new[n_regions] = 0
    return new


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


def m_step_sums(
    model: EnergyModel, labels: Tensor, mode: str, *, backend: Optional[str] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """The M-step's per-label weighted region sums ``(sum_w, sum_wy,
    sum_wyy)``: three ReduceByKey launches in element order (the kernel's
    ordered ``add`` on the card, so they are the CPU's bits).  ``faithful``
    groups the regions by SortByKey(label) first, as the paper does, and
    sums in that (stable) order; the other modes key by label directly."""
    n_labels = model.n_labels
    y, w = model.region_mean, model.region_weight  # sentinel lane has weight 0
    if mode == "faithful":
        seg, y, w = dpp.sort_by_key(labels, y, w)
    else:
        seg = labels
    return tuple(dpp.reduce_by_key(seg, v, n_labels, op="add", backend=backend, ordered=True)
                 for v in (w, w * y, w * y * y))


def update_parameters_stats(
    model: EnergyModel, labels: Tensor, mode: str, *, backend: Optional[str] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """M-step from the labels: :func:`m_step_sums`, then
    :func:`params_from_stats`.  Returns ``(mu, sigma, sum_w)``."""
    return params_from_stats(model, *m_step_sums(model, labels, mode, backend=backend))


def update_parameters(model: EnergyModel, labels: Tensor, mode: str, *,
                      backend: Optional[str] = None) -> Tuple[Tensor, Tensor]:
    """M-step (the paper's step 4): per-label ``(mu, sigma)`` from the
    weighted region statistics (:func:`update_parameters_stats`)."""
    mu, sigma, _ = update_parameters_stats(model, labels, mode, backend=backend)
    return mu, sigma


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


# ---------------------------------------------------------------------------
# Lane-axis forms of the modes' MAP iteration and M-step
# ---------------------------------------------------------------------------
#
# One MAP iteration of every lane of a stack or pool as one flat DPP
# problem: ``hoods`` stacked (``hoods.stack_hoods``), the model's tensors,
# the labels (B, V+1) and mu and sigma (B, K) with a leading lane axis.
# Each keyed reduction runs once over all B lanes' elements, each lane's
# keys offset into a key range of its own (``dpp.lane_keys``).  Within a
# segment the elements keep the serial step's order, so the ordered ``add``
# gives each lane the serial bits, the integer counts are exact, and
# ``min`` is exact: lane b's rows are the serial functions' results on
# lane b's problem, bit for bit.


def check_lane_key_spaces(batch: int, capacity: int, n_hoods: int, n_vertices: int,
                          n_labels: int) -> None:
    """Raise ``ValueError`` when a stack or pool of ``batch`` lanes of one
    bucket would put a lane-offset key, or an element index of the flat
    step, past int32 (the ``segment_reduce`` kernel's id and index type)."""
    spaces = {
        "the (hood, label) counts": (n_hoods + 1) * n_labels,
        "the votes": n_vertices * n_labels,
        "the faithful minimum's elements": (capacity + 1) * max(n_labels, 2),
    }
    for what, per_lane in spaces.items():
        if batch * per_lane > dpp.INT32_MAX:
            raise ValueError(
                f"{batch} lanes of capacity {capacity}, {n_hoods} hoods, {n_vertices} "
                f"vertices and K = {n_labels} need {batch * per_lane} keys for {what}, past "
                f"int32; at most {dpp.INT32_MAX // per_lane} lanes fit")


def hood_label_counts_lanes(
    hoods: Hoods, labels: Tensor, n_labels: int, *, backend: Optional[str] = None
) -> Tuple[Tensor, Tensor]:
    """:func:`hood_label_counts` of every lane: keys ``(b * (n_hoods + 1)
    + hood_id) * K + x`` and ``b * (n_hoods + 1) + hood_id``, one
    order-free keyed sum each.  Returns (B, n_hoods + 1, K) and
    (B, n_hoods + 1)."""
    batch, n_seg = int(labels.shape[0]), hoods.n_hoods + 1
    x = torch.gather(labels, 1, hoods.vertex.long()).reshape(-1)
    ones = hoods.valid.to(torch.float32).reshape(-1)
    hid = dpp.lane_keys(hoods.hood_id, n_seg)
    key = dpp.compound_key(hid, x, n_labels, major_span=batch * n_seg)
    counts = dpp.reduce_by_key(key, ones, batch * n_seg * n_labels, op="add", backend=backend)
    nall = dpp.reduce_by_key(hid, ones, batch * n_seg, op="add", backend=backend)
    return counts.reshape(batch, n_seg, n_labels), nall.reshape(batch, n_seg)


def label_energies_lanes(
    hoods: Hoods,
    model: EnergyModel,
    labels: Tensor,
    mu: Tensor,
    sigma: Tensor,
    hood_counts: Tuple[Tensor, Tensor],
    *,
    log_sigma: Optional[Tensor] = None,
) -> Tensor:
    """:func:`label_energies` of every lane, (B, K, capacity): the serial
    form's operations in its order, each over every lane and label at
    once.  ``log_sigma`` (B, K) as the serial form's."""
    n_labels = int(mu.shape[-1])
    v = hoods.vertex.long()
    validf = hoods.valid.to(torch.float32)
    y = torch.gather(model.region_mean, 1, v)
    w = torch.gather(model.region_weight, 1, v) * validf
    x = torch.gather(labels, 1, v)
    sig = torch.maximum(sigma, model.sigma_min[:, None])
    counts, nall = hood_counts
    hid = hoods.hood_id.long()
    nall_e = torch.gather(nall, 1, hid)
    cnt_e = torch.gather(counts, 1, hid[..., None].expand(-1, -1, n_labels)).transpose(1, 2)
    denom = torch.clamp_min(nall_e - 1.0, 1.0)
    log_s = torch.log(sig) if log_sigma is None else log_sigma
    d = y[:, None, :] - mu[:, :, None]
    data = w[:, None, :] * (d * d / (2.0 * sig * sig)[:, :, None] + log_s[:, :, None])
    label = torch.arange(n_labels, device=x.device)[None, :, None]
    eq = (x[:, None, :] == label).to(torch.float32)
    others_diff = (nall_e[:, None, :] - cnt_e) - (1.0 - eq)
    return data + model.beta[:, None, None] * torch.clamp_min(others_diff, 0.0) / \
        denom[:, None, :] * validf[:, None, :]


def min_energies_static_lanes(energies: Tensor) -> Tuple[Tensor, Tensor]:
    """:func:`min_energies_static` of every lane: (B, capacity) minima and
    labels (the first on ties)."""
    min_e, arg = torch.min(energies, dim=1)
    return min_e, arg.to(torch.int32)


def min_energies_faithful_lanes(
    hoods: Hoods, energies: Tensor, *, backend: Optional[str] = None
) -> Tuple[Tensor, Tensor]:
    """:func:`min_energies_faithful` of every lane: each lane's replicated
    energies keyed ``b * (capacity + 1) + rep_key``, one stable SortByKey
    over all lanes and one ReduceByKey(Min) over ``B * (capacity + 1)``
    segments.  K = 2 gathers through each lane's replication arrays, K > 2
    tiles its energies (a K = 2 request in a K = 3 pool takes the tiled
    form: the minimum is one of its inputs' bits either way)."""
    batch, n_labels, h_pad = (int(s) for s in energies.shape)
    big = torch.tensor(_BIG, dtype=energies.dtype, device=energies.device)
    if n_labels == 2:
        index = hoods.rep_test_label.long() * h_pad + hoods.rep_old_index.long()
        rep_e = torch.gather(energies.reshape(batch, 2 * h_pad), 1, index)
        rep_e = torch.where(hoods.rep_valid, rep_e, big)
        rep_key = torch.where(hoods.rep_valid, hoods.rep_old_index, h_pad)
    else:
        lane = torch.arange(h_pad, dtype=torch.int32, device=energies.device)
        rep_key = torch.where(hoods.valid, lane, h_pad).repeat(1, n_labels)
        rep_e = torch.where(hoods.valid[:, None, :], energies, big).reshape(batch, -1)
    sk, se = dpp.sort_by_key(dpp.lane_keys(rep_key, h_pad + 1), rep_e.reshape(-1))
    min_e = dpp.reduce_by_key(sk, se, batch * (h_pad + 1), op="min", backend=backend)
    min_e = min_e.reshape(batch, h_pad + 1)[:, :h_pad]
    min_e = torch.where(hoods.valid, min_e, torch.zeros((), dtype=min_e.dtype, device=min_e.device))
    arg = torch.argmax((energies == min_e[:, None, :]).to(torch.int32), dim=1)
    arg = torch.where(hoods.valid, arg, 0).to(torch.int32)
    return min_e, arg


def hood_energy_sums_lanes(
    hoods: Hoods, min_e: Tensor, *, backend: Optional[str] = None
) -> Tensor:
    """:func:`hood_energy_sums` of every lane: one ordered keyed sum on
    keys ``b * (n_hoods + 1) + hood_id``.  (B, n_hoods)."""
    batch, n_seg = int(min_e.shape[0]), hoods.n_hoods + 1
    vals = torch.where(hoods.valid, min_e, torch.zeros((), dtype=min_e.dtype, device=min_e.device))
    sums = dpp.reduce_by_key(dpp.lane_keys(hoods.hood_id, n_seg), vals.reshape(-1),
                             batch * n_seg, op="add", backend=backend, ordered=True)
    return sums.reshape(batch, n_seg)[:, : hoods.n_hoods]


def vote_labels_lanes(hoods: Hoods, arg: Tensor, n_regions: int, n_labels: int) -> Tensor:
    """:func:`vote_labels` of every lane: one Scatter(Add) of the votes on
    keys ``(b * (V + 1) + vertex) * K + arg`` and each vertex's plurality
    label.  (B, V+1) int32, each lane's sentinel lane 0."""
    batch, n_vert = int(arg.shape[0]), n_regions + 1
    key = dpp.compound_key(dpp.lane_keys(hoods.vertex, n_vert),
                           torch.where(hoods.valid, arg, 0).reshape(-1), n_labels,
                           major_span=batch * n_vert)
    votes = dpp.scatter_(hoods.valid.to(torch.float32).reshape(-1), key,
                         batch * n_vert * n_labels, mode="add")
    new = torch.argmax(votes.reshape(batch, n_vert, n_labels), dim=2).to(torch.int32)
    new[:, n_regions] = 0
    return new


def m_step_sums_lanes(
    model: EnergyModel,
    labels: Tensor,
    mode: str,
    *,
    lanes: Optional[Tensor] = None,
    backend: Optional[str] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """:func:`m_step_sums` of every lane, or of the lanes where ``lanes``
    ((B,) bool) is set (the others' keys fall outside the key range and
    their rows are 0): three ordered keyed sums on keys ``b * K + label``,
    in ``faithful`` after one stable SortByKey of them, which keeps vertex
    order within each label as the serial form does.  Returns three
    (B, K)."""
    batch, n_labels = int(labels.shape[0]), model.n_labels
    seg = dpp.lane_keys(labels, n_labels).reshape(batch, -1)
    if lanes is not None:
        seg = torch.where(lanes[:, None], seg, batch * n_labels)
    seg, y, w = seg.reshape(-1), model.region_mean.reshape(-1), model.region_weight.reshape(-1)
    if mode == "faithful":
        seg, y, w = dpp.sort_by_key(seg, y, w)
    return tuple(dpp.reduce_by_key(seg, v, batch * n_labels, op="add", backend=backend,
                                   ordered=True).reshape(batch, n_labels)
                 for v in (w, w * y, w * y * y))


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
