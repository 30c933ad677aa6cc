"""EM / MAP optimization driver (paper Alg. 2, lines 6-12).

Counterpart of ``repro.core.pmrf.em`` for the ``static-pallas`` route.  An
outer EM loop (parameter estimation) wraps an inner MAP loop (label
inference).  Convergence follows §3.2.2: per-hood energy sums over the
last L=3 iterations, converged when every change is below 1e-4
(relative).

There is one driver for one problem (:func:`_em_driver`), parametrised by
a collective context (``collectives.ReduceCtx``): :func:`run_em` binds
the single-device context, where each MAP iteration is one
``fused_em_tick`` launch on a workspace of the problem's bucket (label
gather, history ring, convergence and finiteness flags, and in the
launch that stops the MAP loop the M-step sums, all in the kernel);
``distributed.run_em_sharded`` binds a sharded context, where each MAP
iteration is one ``fused_map_step`` launch on the rank's workspace (the
last step's labels and tests, this step's counts, energies, hood sums and
votes), one all-reduce of the step's hood sums and votes and, past the
window, the AND of the flag word; the launch that stops the MAP loop also
sums the M-step's per-label terms in vertex order (the keyed sums of
``energy.update_parameters_stats``).  Every convergence decision goes
through the context, so all ranks take the same trajectory.

:func:`run_em_batched` runs a stack of problems padded to one bucket in
lockstep, the reference's vmapped ``run_em``: per MAP iteration one
launch of the batched tick for every lane still running and one read of
the B flag words; per EM iteration one vectorised boundary and one host
read.  Each lane's result equals its own :func:`run_em`'s bit for bit.

:func:`run_em_ticked` advances a pool of slots (:class:`TickState`, on a
pool workspace) by micro-steps, each lane at its own MAP iteration, the
reference's continuous-batching driver: per micro-step one pool launch
and one read of the B flag words, and, only where some lane's MAP loop
stopped, the EM boundary of those lanes and one host read.  Each lane's
result equals its own :func:`run_em`'s bit for bit.

The JAX driver's ``while_loop``s are Python loops here.  The loop
conditions need the MAP ``done`` flag on the host, so each MAP iteration
reads one flag word from the device, and each EM boundary reads three.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.pmrf import collectives
from repro_torch.core.pmrf import energy as E
from repro_torch.core.pmrf.hoods import Hoods
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import TickShape

Tensor = torch.Tensor

CONV_TOL = 1.0e-4
WINDOW = 3  # the paper's L

MODES = ("faithful", "static", "static-pallas")
PRECISIONS = ("f32", "bf16")
#: Modes of the reference that this package does not run yet, and where
#: ROADMAP.md queues them.
UNPORTED_MODES = {
    "static": "ROADMAP.md Queue 1, 'Serial EM in modes static and faithful'",
    "faithful": "ROADMAP.md Queue 1, 'Serial EM in modes static and faithful'",
}

# Per-lane health lattice: priority DIVERGED > DEGENERATE > CONVERGED > MAX_ITERS.
STATUS_OK = 0          # still iterating (only seen mid-flight)
STATUS_CONVERGED = 1   # EM window converged
STATUS_MAX_ITERS = 2   # stopped at the EM iteration cap
STATUS_DIVERGED = 3    # non-finite energies or parameters
STATUS_DEGENERATE = 4  # empty real label with sigma pinned at sigma_min

STATUS_NAMES = {
    STATUS_OK: "running",
    STATUS_CONVERGED: "converged",
    STATUS_MAX_ITERS: "max_iters",
    STATUS_DIVERGED: "diverged",
    STATUS_DEGENERATE: "degenerate",
}

#: Data-term sentinel of inert (padded) labels (``energy.pad_model_labels``);
#: a label at INERT_MU is never a "real" label for DEGENERATE.
INERT_MU = E.INERT_MU


class EMConfig(NamedTuple):
    max_em_iters: int = 20
    max_map_iters: int = 10
    mode: str = "static-pallas"   # the one mode ported so far (MODES)
    beta: float = 0.75
    sigma_min: float = 2.0
    backend: str = "auto"         # kernel dispatch (kernels/ops.py BACKENDS)
    precision: str = "f32"        # fused-tick energy arithmetic: "f32" | "bf16";
                                  # the sharded route computes in f32, as the
                                  # reference's does


def validate_config(config: EMConfig) -> None:
    if config.mode not in MODES:
        raise ValueError(f"unknown mode {config.mode!r}; have {MODES}")
    if config.mode in UNPORTED_MODES:
        raise NotImplementedError(
            f"mode {config.mode!r} is not ported to repro_torch yet; it is "
            f"queued in {UNPORTED_MODES[config.mode]}"
        )
    if config.precision not in PRECISIONS:
        raise ValueError(f"unknown precision {config.precision!r}; have {PRECISIONS}")
    if config.backend not in kops.BACKENDS:
        raise ValueError(f"unknown backend {config.backend!r}; have {kops.BACKENDS}")


class EMResult(NamedTuple):
    labels: Tensor        # (V+1,) int32 (sentinel lane 0)
    mu: Tensor            # (K,)
    sigma: Tensor         # (K,)
    hood_energy: Tensor   # (n_hoods,) final per-neighborhood energy sums
    total_energy: Tensor  # () float32
    em_iters: int
    map_iters: int        # total inner iterations executed
    status: int           # STATUS_* health code


def init_params(
    gen: torch.Generator, n_regions: int, n_labels: int = 2
) -> Tuple[Tensor, Tensor, Tensor]:
    """Paper init: random labels, per-label mu in [0, 255] (sorted) and
    sigma in [10, 80], drawn from ``gen`` on its device."""
    dev = gen.device
    labels = torch.randint(
        0, n_labels, (n_regions + 1,), generator=gen, device=dev, dtype=torch.int32
    )
    labels[n_regions] = 0
    mu = torch.sort(torch.rand((n_labels,), generator=gen, device=dev) * 255.0).values
    sigma = 10.0 + torch.rand((n_labels,), generator=gen, device=dev) * 70.0
    return labels, mu, sigma


def quantile_init(
    region_mean: Tensor, n_regions: int, n_labels: int = 2
) -> Tuple[Tensor, Tensor, Tensor]:
    """Data-driven init: mu at K quantiles over [q25, q75], labels by
    nearest mu (ties to the lowest label), sigma = std/2 + 1."""
    y = region_mean.to(torch.float32)
    qs = np.linspace(0.25, 0.75, n_labels)
    mu = torch.stack([torch.quantile(y, float(q)) for q in qs])
    sigma = (y.std(correction=0) / 2.0 + 1.0).repeat(n_labels)
    labels = torch.argmin(torch.abs(y[:, None] - mu[None, :]), dim=1).to(torch.int32)
    labels = torch.cat([labels, torch.zeros((1,), dtype=torch.int32, device=y.device)])
    return labels, mu, sigma


def _total_energy(hood_energy: Tensor) -> Tensor:
    """The total of the hood energies (last axis), summed in float64 and
    rounded once: the same bits whatever the padding, the order or the
    batch shape of the device's reduction."""
    return torch.sum(hood_energy, dim=-1, dtype=torch.float64).to(torch.float32)


def _window_converged(hist: Tensor) -> Tensor:
    """True where the last WINDOW deltas of the ring (axis 0) are all below
    tolerance."""
    deltas = torch.abs(hist[:-1] - hist[1:])
    scale = torch.clamp_min(torch.abs(hist[0]), 1.0)
    return torch.all(deltas < CONV_TOL * scale, dim=0)


def _degenerate_components(model: E.EnergyModel, sigma: Tensor, sum_w: Tensor) -> Tensor:
    """A real label with (near-)zero mass whose sigma sits at sigma_min can
    never recapture mass (the collapsed-Gaussian hazard).  Per lane over a
    leading lane axis."""
    dead = sum_w < 1e-3 * E.label_total(sum_w)
    real = model.reseed_mu < INERT_MU
    return torch.any(dead & real & (sigma <= model.sigma_min[..., None]), dim=-1)


def _boundary_status(
    div: bool, deg: bool, finished: bool, em_conv: bool, em_i: int, max_em_iters: int
) -> int:
    if div:
        return STATUS_DIVERGED
    if finished and deg:
        return STATUS_DEGENERATE
    if em_conv:
        return STATUS_CONVERGED
    if em_i >= max_em_iters:
        return STATUS_MAX_ITERS
    return STATUS_OK


def make_workspace(shape: TickShape, config: EMConfig, *, device, batch=None, pool=False):
    """The MAP-iteration workspace for problems of ``shape`` under
    ``config`` (``kernels.ops.tick_workspace``): for :func:`run_em`, with
    ``batch=B`` for :func:`run_em_batched`, or with ``batch=B, pool=True``
    the slot pool of :func:`run_em_ticked`.  A session keeps one per bucket
    (and per pool) and every solve of the bucket reuses it
    (``workspace=``)."""
    return kops.tick_workspace(
        shape, device=device, batch=batch, pool=pool, max_map_iters=config.max_map_iters,
        precision=config.precision, conv_tol=CONV_TOL, window=WINDOW, backend=config.backend,
    )


def _check_workspace(ws, config: EMConfig, n_labels: int) -> None:
    if (ws.precision, ws.n_labels) != (config.precision, n_labels):
        raise ValueError(
            f"workspace built for precision {ws.precision!r} and K = {ws.n_labels}, "
            f"the solve has {config.precision!r} and K = {n_labels}"
        )


def _em_driver(
    hoods: Hoods,
    model: E.EnergyModel,
    labels0: Tensor,
    mu0: Tensor,
    sigma0: Tensor,
    config: EMConfig,
    ctx: collectives.ReduceCtx,
    workspace=None,
) -> EMResult:
    """The EM driver of both routes; only the collective context differs.

    When ``ctx`` is sharded, ``hoods`` is this rank's element block (with
    globally indexed ``vertex``/``hood_id``) while ``model``, ``labels0``,
    ``mu0`` and ``sigma0`` are the same on every rank, and so is all label
    and parameter state after each step; ``workspace`` is then the rank's
    ``kernels.ops.map_step_workspace`` (``distributed.make_workspace``).
    On one device each MAP iteration is ``workspace.step`` and one flag
    read, nothing else; sharded, one step, one flag read and one
    all-reduce, with the AND of the flag word past the window.
    """
    validate_config(config)
    backend = config.backend
    n_hoods = hoods.n_hoods
    dev = labels0.device
    f32 = torch.float32
    fused_tick = not ctx.sharded
    sctx = E.make_static_context(hoods, model, backend=backend, ctx=ctx)
    if fused_tick:
        ws = workspace if workspace is not None else make_workspace(
            TickShape.of(hoods, model), config, device=dev)
        _check_workspace(ws, config, model.n_labels)
        ws.start(hoods, model, sctx.y, sctx.w, sctx.nall_e, sctx.validf, labels0)
    else:
        if workspace is None:
            raise ValueError("the sharded route needs its rank's workspace (distributed.make_workspace)")
        ws = workspace
        if ws.n_labels != model.n_labels:
            raise ValueError(f"workspace built for K = {ws.n_labels}, the solve has K = {model.n_labels}")
        ws.start(sctx.y, sctx.w, sctx.nall_e, sctx.validf, labels0)

    mu, sigma = mu0, sigma0
    hood_energy = torch.zeros((n_hoods,), dtype=f32, device=dev)  # if max_em_iters == 0
    total_hist = torch.zeros((WINDOW + 1,), dtype=f32, device=dev)
    em_i = 0
    map_total = 0
    status = STATUS_OK
    done = False
    while em_i < config.max_em_iters and not done:
        i = 0
        flag = 0
        ws.begin_em(mu, torch.maximum(sigma, model.sigma_min))
        if fused_tick:
            # MAP loop: one launch and one flag read per iteration; the
            # launch that stops the loop takes the M-step sums.
            while i < config.max_map_iters and not flag:
                i += 1
                ws.step(i > WINDOW, i == config.max_map_iters)
                flag = ws.flag()
            if i:
                hood_energy, msums = ws.hood_e, ws.stats
            else:
                hood_energy = torch.zeros((n_hoods,), dtype=f32, device=dev)
                msums = torch.zeros((3, mu.shape[0]), dtype=f32, device=dev)
            mu, sigma, sum_w = E.params_from_stats(model, msums[0], msums[1], msums[2])
        else:
            # MAP loop: per iteration one launch (the head tests iteration
            # i, the step computes i + 1), the AND of the flag word past
            # the window, one flag read and one all-reduce of the step.  The
            # launch that stops the loop only tests: its step is dropped.
            while True:
                more = i < config.max_map_iters
                ws.step(i > WINDOW, step=more)
                if i > WINDOW:
                    # Every rank has the same i, so all skip or all join
                    # the collective.
                    ctx.and_flags(ws.flag_word)
                flag = ws.flag()
                if flag or not more:
                    break
                ctx.psum(ws.buffer)
                i += 1
            hood_energy = ws.hood_e if i else torch.zeros((n_hoods,), dtype=f32, device=dev)
            # M-step: the sums the stopping launch took of the labels,
            # which every rank holds, so they need no collective.
            mu, sigma, sum_w = E.params_from_stats(model, *ws.stats)
        map_div = bool(flag & kops.FLAG_DIVERGED)
        div_t = ~torch.all(torch.isfinite(mu)) | ~torch.all(torch.isfinite(sigma))
        deg_t = _degenerate_components(model, sigma, sum_w)
        total_hist = torch.cat([_total_energy(hood_energy)[None], total_hist[:-1]])
        em_i += 1
        if em_i > WINDOW:
            conv_t = ctx.all_converged(_window_converged(total_hist))
        else:
            conv_t = torch.zeros_like(div_t)
        div, deg, em_conv = (bool(v) for v in torch.stack([div_t, deg_t, conv_t]).tolist())
        div = div or map_div
        map_total += i
        finished = div or not (em_i < config.max_em_iters and not em_conv)
        done = em_conv or div
        status = _boundary_status(div, deg, finished, em_conv, em_i, config.max_em_iters)

    # The workspace's buffers belong to the plan.
    labels, hood_energy = ws.labels.clone(), hood_energy.clone()
    return EMResult(
        labels=labels,
        mu=mu,
        sigma=sigma,
        hood_energy=hood_energy,
        total_energy=_total_energy(hood_energy),
        em_iters=em_i,
        map_iters=map_total,
        status=status,
    )


def run_em(
    hoods: Hoods,
    model: E.EnergyModel,
    labels0: Tensor,
    mu0: Tensor,
    sigma0: Tensor,
    config: EMConfig = EMConfig(),
    *,
    workspace=None,
) -> EMResult:
    """EM on one problem, on the device its tensors live on.  ``workspace``
    (``make_workspace``) carries the MAP loop's buffers across solves of
    one bucket; without it the solve builds its own."""
    return _em_driver(hoods, model, labels0, mu0, sigma0, config, collectives.LOCAL, workspace)


class BatchedEMResult(NamedTuple):
    """:class:`EMResult` of a stack: tensors with a leading lane axis, the
    counts and status one int per lane (``lane(b)``: lane b's EMResult)."""

    labels: Tensor        # (B, V+1) int32
    mu: Tensor            # (B, K)
    sigma: Tensor         # (B, K)
    hood_energy: Tensor   # (B, n_hoods)
    total_energy: Tensor  # (B,) float32
    em_iters: Tuple[int, ...]
    map_iters: Tuple[int, ...]
    status: Tuple[int, ...]
    steps: int            # lockstep MAP iterations: launches of the batched tick

    def lane(self, b: int) -> EMResult:
        return EMResult(*(v[b] for v in self[:-1]))


def run_em_batched(
    hoods: Hoods,
    model: E.EnergyModel,
    labels0: Tensor,
    mu0: Tensor,
    sigma0: Tensor,
    config: EMConfig = EMConfig(),
    *,
    workspace=None,
) -> BatchedEMResult:
    """EM on a stack of B problems padded to one bucket, in lockstep: the
    counterpart of the reference's ``run_em_batched`` (``vmap`` of
    ``run_em``).  ``hoods`` (``hoods.stack_hoods``) and ``model`` carry a
    leading lane axis, ``labels0`` is (B, V+1), ``mu0`` and ``sigma0``
    (B, K).

    The EM loop runs while any lane runs, and each EM iteration's MAP loop
    while any lane's MAP loop runs; a lane whose MAP loop stopped is
    inactive until the next EM iteration, and a lane whose EM finished
    stays inactive.  Per MAP iteration: one batched tick launch for the
    running lanes and one read of the B flag words.  Per EM iteration: the
    boundary over every lane at once (``params_from_stats`` on (B, 3, K),
    the divergence and degeneracy tests, the total-energy rings) and one
    host read.  Each lane's result is its own :func:`run_em`'s bit for bit.
    ``workspace`` (``make_workspace(..., batch=B)``) carries the buffers
    across solves of one bucket and batch size.
    """
    validate_config(config)
    n_hoods = hoods.n_hoods
    batch, dev, f32 = int(labels0.shape[0]), labels0.device, torch.float32
    n_labels = model.n_labels
    sctx = E.make_static_context_batched(hoods, model, backend=config.backend)
    ws = workspace if workspace is not None else make_workspace(
        TickShape.of(hoods, model), config, device=dev, batch=batch)
    _check_workspace(ws, config, n_labels)
    if ws.batch != batch:
        raise ValueError(f"workspace built for {ws.batch} lanes, the stack has {batch}")
    ws.start(hoods, model, sctx.y, sctx.w, sctx.nall_e, sctx.validf, labels0)

    mu, sigma = mu0, sigma0
    hood_energy = torch.zeros((batch, n_hoods), dtype=f32, device=dev)
    total_hist = torch.zeros((batch, WINDOW + 1), dtype=f32, device=dev)
    zeros_stats = torch.zeros((batch, 3, n_labels), dtype=f32, device=dev)
    em_iters, map_iters = [0] * batch, [0] * batch
    status = [STATUS_OK] * batch
    running = [True] * batch   # lanes whose EM has not finished
    em_i = 0                   # every running lane is at the same EM iteration
    steps = 0
    while em_i < config.max_em_iters and any(running):
        lanes = list(running)
        ws.begin_em(mu, torch.maximum(sigma, model.sigma_min[:, None]), lanes)
        # MAP loop: per iteration one launch for the running lanes and one
        # read of their flag words; a lane's stopping launch takes its
        # M-step sums and retires it until the next EM iteration.
        in_map, flags, lane_map = list(lanes), [0] * batch, [0] * batch
        i = 0
        while i < config.max_map_iters and any(in_map):
            i += 1
            cap = i == config.max_map_iters
            ws.step(i > WINDOW, cap)
            steps += 1
            words = ws.flags()
            for b in range(batch):
                if in_map[b]:
                    lane_map[b], flags[b] = i, words[b]
                    in_map[b] = not (words[b] or cap)
        he, msums = (ws.hood_e, ws.stats) if i else (hood_energy.new_zeros(hood_energy.shape), zeros_stats)
        new_mu, new_sigma, sum_w = E.params_from_stats(model, msums[:, 0], msums[:, 1], msums[:, 2])
        div_t = ~torch.all(torch.isfinite(new_mu), dim=-1) | ~torch.all(torch.isfinite(new_sigma), dim=-1)
        deg_t = _degenerate_components(model, new_sigma, sum_w)
        new_hist = torch.cat([_total_energy(he)[:, None], total_hist[:, :-1]], dim=1)
        em_i += 1
        if em_i > WINDOW:
            conv_t = _window_converged(new_hist.T)
        else:
            conv_t = torch.zeros_like(div_t)
        on = torch.as_tensor(lanes, device=dev)[:, None]
        mu = torch.where(on, new_mu, mu)
        sigma = torch.where(on, new_sigma, sigma)
        hood_energy = torch.where(on, he, hood_energy)
        total_hist = torch.where(on, new_hist, total_hist)
        div_l, deg_l, conv_l = torch.stack([div_t, deg_t, conv_t]).tolist()
        for b in range(batch):
            if not lanes[b]:
                continue
            div = div_l[b] or bool(flags[b] & kops.FLAG_DIVERGED)
            em_conv = conv_l[b]
            em_iters[b] = em_i
            map_iters[b] += lane_map[b]
            finished = div or not (em_i < config.max_em_iters and not em_conv)
            running[b] = not (em_conv or div)
            status[b] = _boundary_status(div, deg_l[b], finished, em_conv, em_i,
                                         config.max_em_iters)

    labels, hood_energy = ws.labels.clone(), hood_energy.clone()
    return BatchedEMResult(
        labels=labels,
        mu=mu,
        sigma=sigma,
        hood_energy=hood_energy,
        total_energy=_total_energy(hood_energy),
        em_iters=tuple(em_iters),
        map_iters=tuple(map_iters),
        status=tuple(status),
        steps=steps,
    )


# ---------------------------------------------------------------------------
# Ticked EM: the continuous-batching serving driver
# ---------------------------------------------------------------------------
#
# ``run_em_batched`` runs every lane until the slowest converges.  The
# ticked driver keeps a fixed pool of slots whose lanes sit at different
# EM and MAP iterations, and advances it by micro-steps: one pool launch,
# in which each active lane runs its own next MAP iteration, and one read
# of the B flag words.  Where a lane's MAP loop stopped, the host runs that
# lane's EM boundary (as ``_em_driver`` does) and starts its next EM
# iteration, or marks it done.  Between calls the caller retires done
# lanes and admits new requests into the freed slots (``init_tick_lane``);
# the pool's buffers never change shape, so no workspace is built.


@dataclass(eq=False)
class TickState:
    """A slot pool's state (the reference's per-lane ``TickState`` for
    every slot).  The device half lives in ``workspace`` (a pool workspace,
    ``make_workspace(..., pool=True)``): each lane's labels, history ring,
    last hood energies, M-step sums, active word and MAP counter.  The
    rest is here: the EM-level parameters and total-energy rings (on the
    device, (B, K) and (B, WINDOW + 1)), the model terms the EM boundary
    reads (``sigma_min``, ``reseed_mu``, ``reseed_sigma``, with a lane
    axis), and on the host each lane's counters and health.

    Between micro-steps every lane that is not ``done`` is inside its MAP
    loop, about to run its next iteration, and active in the workspace; a
    ``done`` lane (finished, evicted, or an empty slot) is inactive and its
    buffers stay as they were."""

    workspace: object
    mu: Tensor               # (B, K) EM-level mu
    sigma: Tensor            # (B, K) EM-level sigma (unclamped)
    total_hist: Tensor       # (B, WINDOW + 1) outer convergence ring
    sigma_min: Tensor        # (B,)
    reseed_mu: Tensor        # (B, K)
    reseed_sigma: Tensor     # (B,)
    em_i: List[int] = field(default_factory=list)
    map_i: List[int] = field(default_factory=list)      # iterations of the current MAP loop
    map_total: List[int] = field(default_factory=list)  # MAP iterations of finished loops
    done: List[bool] = field(default_factory=list)
    status: List[int] = field(default_factory=list)

    @property
    def batch(self) -> int:
        return len(self.done)

    def model(self) -> E.EnergyModel:
        """The boundary's view of the lanes' models (the region arrays and
        ``beta`` are the workspace's)."""
        ws = self.workspace
        return E.EnergyModel(ws.region_mean, ws.region_weight, ws.beta, self.sigma_min,
                             self.reseed_mu, self.reseed_sigma)

    def begin(self, slots: Sequence[int]) -> None:
        """Start an EM iteration of ``slots`` on the workspace: their
        parameters, sigma clamped at their ``sigma_min``."""
        idx = torch.as_tensor(list(slots), dtype=torch.long, device=self.mu.device)
        sig = torch.maximum(self.sigma[idx], self.sigma_min[idx][:, None])
        self.workspace.begin_lanes(slots, self.mu[idx], sig)
        for b in slots:
            self.map_i[b] = 0

    def retire(self, slot: int) -> None:
        """Mark ``slot`` done and stop its lane (eviction, or an emptied
        slot); its state stays readable (``tick_result``)."""
        self.done[slot] = True
        self.workspace.retire(slot)

    def hold(self, slot: int, dmu) -> None:
        """Reset one lane's progress and add ``dmu`` ((K,), any array) to its
        EM-level mu (the chaos harness's never-converge hold): its EM counter
        and ring, and a new EM iteration from its current labels; no other
        lane moves."""
        self.mu[slot] += torch.as_tensor(dmu, dtype=torch.float32).to(self.mu.device)
        self.total_hist[slot] = 0.0
        self.em_i[slot], self.done[slot], self.status[slot] = 0, False, STATUS_OK
        self.begin([slot])


def blank_tick_state(workspace) -> TickState:
    """An all-empty slot pool on ``workspace``: every lane ``done`` and
    inactive, with benign parameters (sigma 1).  The workspace is taken
    over by the new state (``workspace.owner``, a weak reference, so that
    a pool dropped by its engine frees its pinned host words at once); a
    state that lost it may not step."""
    batch, k = workspace.batch, workspace.n_labels
    dev, f32 = workspace.mu.device, torch.float32
    for b in range(batch):
        workspace.retire(b)
    state = TickState(
        workspace=workspace,
        mu=torch.zeros((batch, k), dtype=f32, device=dev),
        sigma=torch.ones((batch, k), dtype=f32, device=dev),
        total_hist=torch.zeros((batch, WINDOW + 1), dtype=f32, device=dev),
        sigma_min=torch.ones((batch,), dtype=f32, device=dev),
        reseed_mu=torch.zeros((batch, k), dtype=f32, device=dev),
        reseed_sigma=torch.ones((batch,), dtype=f32, device=dev),
        em_i=[0] * batch, map_i=[0] * batch, map_total=[0] * batch,
        done=[True] * batch, status=[STATUS_OK] * batch,
    )
    workspace.owner = weakref.ref(state)
    return state


def init_tick_lane(
    state: TickState,
    slot: int,
    hoods: Hoods,
    model: E.EnergyModel,
    labels0: Tensor,
    mu0: Tensor,
    sigma0: Tensor,
    sctx: Optional[E.StaticMapContext] = None,
) -> None:
    """Admit one request into ``slot``: its padded problem (``hoods``,
    ``model`` of the pool's bucket and K), its initial parameters, and its
    element arrays (``sctx``, ``energy.make_static_context``, built here
    when not given).  The lane starts its first EM iteration, as
    ``run_em`` does; no other lane's buffers move."""
    if sctx is None:
        sctx = E.make_static_context(hoods, model)
    ws = state.workspace
    ws.admit(slot, hoods, model, sctx.y, sctx.w, sctx.nall_e, sctx.validf, labels0)
    state.mu[slot] = mu0
    state.sigma[slot] = sigma0
    state.total_hist[slot] = 0.0
    state.sigma_min[slot] = model.sigma_min
    state.reseed_mu[slot] = model.reseed_mu
    state.reseed_sigma[slot] = model.reseed_sigma
    state.em_i[slot] = state.map_total[slot] = 0
    state.done[slot], state.status[slot] = False, STATUS_OK
    state.begin([slot])


def tick_result(state: TickState, slot: int) -> EMResult:
    """Lane ``slot`` read out as the :class:`EMResult` ``run_em`` would
    have returned (copies: the slot may be refilled)."""
    ws = state.workspace
    hood_energy = ws.hood_e[slot].clone()
    return EMResult(
        labels=ws.labels[slot].clone(),
        mu=state.mu[slot].clone(),
        sigma=state.sigma[slot].clone(),
        hood_energy=hood_energy,
        total_energy=_total_energy(hood_energy),
        em_iters=state.em_i[slot],
        map_iters=state.map_total[slot],
        status=state.status[slot],
    )


def _tick_boundary(state: TickState, lanes: List[int], flags: List[int], config: EMConfig) -> None:
    """The EM boundary of the lanes whose MAP loop just stopped, vectorised
    over the pool as ``run_em_batched``'s (``params_from_stats``, the
    divergence and degeneracy tests, the total-energy rings) and selected
    into those lanes, then one host read; the lanes that go on start their
    next EM iteration."""
    ws, dev = state.workspace, state.mu.device
    msums = ws.stats
    model = state.model()
    new_mu, new_sigma, sum_w = E.params_from_stats(model, msums[:, 0], msums[:, 1], msums[:, 2])
    div_t = ~torch.all(torch.isfinite(new_mu), dim=-1) | ~torch.all(torch.isfinite(new_sigma), dim=-1)
    deg_t = _degenerate_components(model, new_sigma, sum_w)
    new_hist = torch.cat([_total_energy(ws.hood_e)[:, None], state.total_hist[:, :-1]], dim=1)
    conv_t = _window_converged(new_hist.T)
    on = torch.zeros((state.batch, 1), dtype=torch.bool)
    on[lanes] = True
    on = on.to(dev)
    state.mu = torch.where(on, new_mu, state.mu)
    state.sigma = torch.where(on, new_sigma, state.sigma)
    state.total_hist = torch.where(on, new_hist, state.total_hist)
    div_l, deg_l, conv_l = torch.stack([div_t, deg_t, conv_t]).tolist()
    go_on = []
    for b in lanes:
        em_i = state.em_i[b] + 1
        div = div_l[b] or bool(flags[b] & kops.FLAG_DIVERGED)
        em_conv = em_i > WINDOW and conv_l[b]
        state.em_i[b] = em_i
        state.map_total[b] += state.map_i[b]
        state.map_i[b] = 0
        finished = div or not (em_i < config.max_em_iters and not em_conv)
        state.status[b] = _boundary_status(div, deg_l[b], finished, em_conv, em_i,
                                           config.max_em_iters)
        if finished:
            state.done[b] = True
        else:
            go_on.append(b)
    if go_on:
        state.begin(go_on)


def _tick_micro(state: TickState, config: EMConfig) -> None:
    """One micro-step: one pool launch (every lane not done runs its next
    MAP iteration) and one read of the flag words; the host mirrors each
    lane's stopping rule (flag word set, or the cap), as the kernel applies
    it, and runs the EM boundary of the lanes that stopped."""
    ws = state.workspace
    ws.step()
    words = ws.flags()
    stopped = []
    for b in range(state.batch):
        if state.done[b]:
            continue
        state.map_i[b] += 1
        if words[b] or state.map_i[b] == config.max_map_iters:
            stopped.append(b)
    if stopped:
        _tick_boundary(state, stopped, words, config)


def run_em_ticked(
    state: TickState, config: EMConfig = EMConfig(), tick_iters: int = 8
) -> Tuple[TickState, int]:
    """Advance a slot pool by up to ``tick_iters`` micro-steps (one tick);
    returns ``(state, steps_executed)``.

    The tick exits early once every lane is done: the remaining
    micro-steps would change nothing, and the caller gets control back at
    the convergence boundary, so ``steps_executed`` (at most
    ``tick_iters``) counts the launches actually issued.  Between calls
    the caller retires done lanes (``TickState.retire``, or just reading
    them with :func:`tick_result`) and admits requests into free slots
    (:func:`init_tick_lane`) without disturbing the lanes in flight.  Each
    lane's trajectory is its own :func:`run_em`'s, bit for bit (labels,
    parameters, hood energies, counts, status), whatever the tick size and
    whatever shares its pool.  Mode ``static-pallas`` only; the reference's
    static-mode pool form waits for mode ``static`` (``UNPORTED_MODES``).
    """
    validate_config(config)
    if config.max_em_iters < 1 or config.max_map_iters < 1:
        raise ValueError("run_em_ticked requires max_em_iters/max_map_iters >= 1")
    if tick_iters < 1:
        raise ValueError(f"tick_iters must be >= 1, got {tick_iters}")
    ws = state.workspace
    if ws.owner is None or ws.owner() is not state:
        raise ValueError("the pool workspace belongs to another TickState (blank_tick_state)")
    if (ws.precision, ws.max_map_iters) != (config.precision, config.max_map_iters):
        raise ValueError(
            f"pool built for precision {ws.precision!r} and max_map_iters {ws.max_map_iters}, "
            f"the config has {config.precision!r} and {config.max_map_iters}")
    steps = 0
    while steps < tick_iters and not all(state.done):
        _tick_micro(state, config)
        steps += 1
    return state, steps
