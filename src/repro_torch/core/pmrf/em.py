"""EM / MAP optimization driver (paper Alg. 2, lines 6-12).

Counterpart of ``repro.core.pmrf.em``.  An outer EM loop (parameter
estimation) wraps an inner MAP loop (label inference).  Convergence
follows §3.2.2: per-hood energy sums over the last L=3 iterations,
converged when every change is below 1e-4 (relative).

The execution ``mode`` selects the MAP iteration.  ``static`` and
``faithful`` are the paper's primitive sequence (:func:`map_step`: counts,
energies, the per-element minimum by an axis-min or by the paper's
Gather / SortByKey / ReduceByKey(Min), hood sums, votes), each primitive
its own operation, with one host read of the iteration's convergence and
divergence; the EM boundary takes ``energy.update_parameters_stats``.  The
float sums of these modes go through ``segment_reduce``'s element-order
``add``, so on the card they are the CPU plain path's bits.
``static-pallas`` fuses the iteration into one kernel launch.

In mode ``static-pallas`` on one device :func:`run_em` and
:func:`run_em_batched` run the **compiled EM program** of the problem's
bucket (:func:`_run_program`), the reference's ``Segmenter.compile``
executable: a workspace built from the bucket's shapes and the EM limits
(``make_workspace``) holds, on the card, one CUDA graph of the whole
solve (the MAP loop's tick launches and the EM boundary kernel, each loop
a conditional node), so a solve is one graph launch and one host read of
its counters; on the CPU, or with ``backend="torch"``, the same control
structure runs as the plain program (``kernels.ref.run_program``).

The modes ``static`` and ``faithful``, and the sharded route, run one
driver for one problem (:func:`_em_driver`), parametrised by a
collective context (``collectives.ReduceCtx``): :func:`run_em` binds the
single-device context; ``distributed.run_em_sharded`` binds a sharded context,
where in mode ``static-pallas`` each MAP iteration is one
``fused_map_step`` launch on the rank's workspace (the
last step's labels and tests, this step's counts, energies, hood sums and
votes), one all-reduce of the step's hood sums and votes and, past the
window, the AND of the flag word; the launch that stops the MAP loop also
sums the M-step's per-label terms in vertex order (the keyed sums of
``energy.update_parameters_stats``).  Every convergence decision goes
through the context, so all ranks take the same trajectory.

:func:`run_em_batched` runs a stack of problems padded to one bucket in
lockstep, the reference's vmapped ``run_em``: in mode ``static-pallas``
the stack's compiled program (per lockstep MAP iteration one launch of
the tick's lane entry, per EM iteration one launch of the boundary's lane
form, one graph launch and one read per solve); in the modes per MAP
iteration one step of the stack's workspace for every lane still running
and one read of the B flag words, per EM iteration one vectorised
boundary and one host read.  :func:`run_em_ticked` advances a pool of slots (:class:`TickState`,
on a pool workspace) by micro-steps, each lane at its own MAP iteration,
the reference's continuous-batching driver: per micro-step one step of
the pool and one read of the B flag words, and, only where some lane's
MAP loop stopped, the EM boundary of those lanes (one launch of the
boundary kernel's lane form) and one host read.  In
both, each lane's result equals its own :func:`run_em`'s bit for bit.

In mode ``static-pallas`` a step is one launch of the tick's batched or
pool entry.  In the modes ``static`` and ``faithful`` it is one flat MAP
iteration of every lane (:func:`map_step_lanes`, on a
:class:`DppBatchWorkspace` or :class:`DppPoolWorkspace`): the paper's
primitive sequence once over all lanes' elements, each keyed reduction on
lane-offset keys, so its operation count does not grow with the lanes.
That is the flat counterpart of the reference's ``vmap`` of ``run_em``
and of its static pool micro-step (``_pool_tick_micro``).

Outside the compiled program the JAX driver's ``while_loop``s are Python
loops: their conditions need the MAP ``done`` flag on the host, so each
MAP iteration reads one flag word from the device, and each EM boundary
reads three.

Every driver marks its hot scopes for the auditor's census
(``repro_torch.analysis.census``): each MAP iteration and each EM
boundary.  A driver call reads ``census.ACTIVE`` once; with no census
taken the markers are tests of a local ``None``.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import census as _census
from repro_torch.core.pmrf import collectives
from repro_torch.core.pmrf import energy as E
from repro_torch.core.pmrf.hoods import Hoods
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import (ACTIVE, CTL_WORDS, EM_ITERS, MAP_ITERS, STATUS, BoundaryState,
                                     PlainPoolTickWorkspace, TickShape)

Tensor = torch.Tensor
_MAP, _EM, _SOLVE = _census.MAP_ITERATION, _census.EM_BOUNDARY, _census.SOLVE

CONV_TOL = 1.0e-4
WINDOW = 3  # the paper's L

MODES = ("faithful", "static", "static-pallas")
PRECISIONS = ("f32", "bf16")

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
    mode: str = "static-pallas"   # MODES: the fused route, or the paper's sequence
    beta: float = 0.75
    sigma_min: float = 2.0
    backend: str = "auto"         # kernel dispatch (kernels/ops.py BACKENDS)
    precision: str = "f32"        # fused-tick energy arithmetic: "f32" | "bf16";
                                  # the sharded route computes in f32, as the
                                  # reference's does


def validate_config(config: EMConfig) -> None:
    if config.mode not in MODES:
        raise ValueError(f"unknown mode {config.mode!r}; have {MODES}")
    if config.precision not in PRECISIONS:
        raise ValueError(f"unknown precision {config.precision!r}; have {PRECISIONS}")
    if config.precision == "bf16" and config.mode != "static-pallas":
        raise ValueError(
            "precision='bf16' is a fused-tick feature: it requires "
            f"mode='static-pallas', got mode={config.mode!r}"
        )
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
    ``config``, built from the shapes alone: in mode ``static-pallas``
    (``kernels.ops.tick_workspace``, with the compiled EM program of
    ``config``'s limits) for :func:`run_em`, with ``batch=B`` for
    :func:`run_em_batched`, or with ``batch=B, pool=True`` the slot
    pool of :func:`run_em_ticked`; in the modes ``static`` and
    ``faithful``, whose one-problem solve takes none, a
    :class:`DppBatchWorkspace` (``batch=B``) or a :class:`DppPoolWorkspace`
    (``batch=B, pool=True``).  A session keeps one per bucket (and per
    pool) and every solve of the bucket reuses it (``workspace=``);
    ``kernels.ops.WORKSPACE_BUILDS`` counts every build."""
    if config.mode == "static-pallas":
        return kops.tick_workspace(
            shape, device=device, batch=batch, pool=pool, max_map_iters=config.max_map_iters,
            max_em_iters=None if pool else config.max_em_iters, precision=config.precision,
            conv_tol=CONV_TOL, window=WINDOW, backend=config.backend,
        )
    if batch is None:
        raise ValueError(f"mode {config.mode!r} takes no workspace for one problem; "
                         "pass batch=B for a stack or a pool")
    cls = DppPoolWorkspace if pool else DppBatchWorkspace
    ws = cls(TickShape(*shape), batch, mode=config.mode, device=device, backend=config.backend,
             max_map_iters=config.max_map_iters)
    kops.count_workspace_build()
    return ws


def _check_workspace(ws, config: EMConfig, n_labels: int) -> None:
    if (ws.mode, ws.precision, ws.n_labels) != (config.mode, config.precision, n_labels):
        raise ValueError(
            f"workspace built for mode {ws.mode!r}, precision {ws.precision!r} and "
            f"K = {ws.n_labels}, the solve has {config.mode!r}, {config.precision!r} and "
            f"K = {n_labels}"
        )
    if config.mode == "static-pallas":
        limits = (getattr(ws, "max_em_iters", None), getattr(ws, "max_map_iters", None))
        if limits != (config.max_em_iters, config.max_map_iters):
            raise ValueError(
                f"workspace built with the EM program of (max_em_iters, max_map_iters) "
                f"{limits}, the solve has {(config.max_em_iters, config.max_map_iters)}")


def _run_program(hoods: Hoods, model: E.EnergyModel, labels0: Tensor, mu0: Tensor,
                 sigma0: Tensor, config: EMConfig, workspace, batch: Optional[int]):
    """The compiled EM program of mode ``static-pallas`` on one device:
    the element arrays (``energy.make_static_context``, one
    ``segment_reduce`` launch), ``start`` (the solve's arrays copied into
    the workspace), the program (on the card one graph launch, on the
    plain route the plain program) and one read of its counters; then the
    result, copied out of the workspace.  ``batch`` None for one problem,
    else the stack's lanes.  Returns ``(outputs, em_iters, map_iters,
    status, steps)``: ``outputs`` (labels, mu, sigma, hood energies,
    total energies) with a lane axis, the counts one int per lane."""
    validate_config(config)
    dev = labels0.device
    n_labels = model.n_labels
    ws = workspace if workspace is not None else make_workspace(
        TickShape.of(hoods, model), config, device=dev, batch=batch)
    _check_workspace(ws, config, n_labels)
    if batch is not None and ws.batch != batch:
        raise ValueError(f"workspace built for {ws.batch} lanes, the stack has {batch}")
    cen = _census.ACTIVE
    if cen is not None:
        cen.enter(_SOLVE)
    if batch is None:
        sctx = E.make_static_context(hoods, model, backend=config.backend)
    else:
        sctx = E.make_static_context_batched(hoods, model, backend=config.backend)
    ws.start(hoods, model, sctx.y, sctx.w, sctx.nall_e, sctx.validf, labels0, mu0, sigma0)
    ws.run_program(cen)
    em_iters, map_iters, status, steps = ws.program_result()
    labels, mu, sigma, hood_e, total_hist = ws.program_views()
    n_hoods = hood_e.shape[-1]
    # One copy of the float outputs out of the workspace (its buffers
    # belong to the bucket); the labels' gather is a copy of its own.
    flat = torch.cat([mu, sigma, hood_e, total_hist[:, :1]], dim=1)
    outputs = (labels, flat[:, :n_labels], flat[:, n_labels:2 * n_labels],
               flat[:, 2 * n_labels:2 * n_labels + n_hoods], flat[:, -1])
    if cen is not None:
        cen.leave(_SOLVE)
    return outputs, em_iters, map_iters, status, steps


def map_step(
    hoods: Hoods,
    model: E.EnergyModel,
    mode: str,
    labels: Tensor,
    mu: Tensor,
    sigma: Tensor,
    *,
    backend: Optional[str] = None,
    ctx: collectives.ReduceCtx = collectives.LOCAL,
    log_sigma: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """One MAP iteration of mode ``static`` or ``faithful`` (the non-fused
    branch of the reference's ``_map_step``): ``(new labels, hood sums)``.
    The counts, hood sums and votes go through ``ctx`` (all-reduced when
    sharded); the per-element minimum stays on this rank's elements.
    ``log_sigma`` as ``energy.label_energies``'s."""
    n_labels = int(mu.shape[0])
    counts = E.hood_label_counts(hoods, labels, n_labels, backend=backend, ctx=ctx)
    energies = E.label_energies(hoods, model, labels, mu, sigma, hood_counts=counts,
                                backend=backend, log_sigma=log_sigma)
    if mode == "faithful":
        min_e, arg = E.min_energies_faithful(hoods, energies, backend=backend)
    else:
        min_e, arg = E.min_energies_static(energies)
    hood_e = E.hood_energy_sums(hoods, min_e, backend=backend, ctx=ctx)
    new = E.vote_labels(hoods, arg, hoods.n_regions, n_labels, ctx=ctx)
    return new, hood_e


def _map_loop(hoods, model, labels, mu, sigma, config: EMConfig, ctx):
    """The MAP loop of modes ``static`` and ``faithful``: per iteration
    :func:`map_step`, the history ring, and one host read of the window
    test (past the window, through ``ctx``) and the finiteness of the hood
    sums.  Returns ``(labels, hood_energy, iterations, diverged)``."""
    n_hoods, dev = hoods.n_hoods, labels.device
    hist = torch.zeros((WINDOW + 1, n_hoods), dtype=torch.float32, device=dev)
    hood_energy = torch.zeros((n_hoods,), dtype=torch.float32, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    i, done, diverged = 0, False, False
    cen = _census.ACTIVE
    while i < config.max_map_iters and not done:
        if cen is not None:
            cen.enter(_MAP)
        labels, hood_energy = map_step(hoods, model, config.mode, labels, mu, sigma,
                                       backend=config.backend, ctx=ctx)
        hist = torch.cat([hood_energy[None], hist[:-1]])
        i += 1
        # Every rank has the same i, so all skip or all join the collective.
        conv = ctx.all_converged(_window_converged(hist)) if i > WINDOW else no
        div = ~torch.all(torch.isfinite(hood_energy))
        conv, diverged = torch.stack([conv, div]).tolist()
        done = conv or diverged
    if cen is not None:
        cen.leave(_MAP)
    return labels, hood_energy, i, diverged


def map_step_lanes(
    hoods: Hoods,
    model: E.EnergyModel,
    mode: str,
    labels: Tensor,
    mu: Tensor,
    sigma: Tensor,
    *,
    backend: Optional[str] = None,
    log_sigma: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """:func:`map_step` of every lane of a stack or pool at once (the
    ``energy`` module's lane-axis forms): ``hoods`` stacked, the model's
    tensors, ``labels`` (B, V+1), ``mu`` and ``sigma`` (B, K) with a
    leading lane axis.  One flat DPP problem over all lanes' elements, each
    keyed reduction on lane-offset keys: ``(new labels (B, V+1), hood sums
    (B, n_hoods))``, lane b's rows bit for bit :func:`map_step` on lane b.
    ``log_sigma`` (B, K) as :func:`map_step`'s."""
    n_labels = int(mu.shape[-1])
    counts = E.hood_label_counts_lanes(hoods, labels, n_labels, backend=backend)
    energies = E.label_energies_lanes(hoods, model, labels, mu, sigma, counts,
                                      log_sigma=log_sigma)
    if mode == "faithful":
        min_e, arg = E.min_energies_faithful_lanes(hoods, energies, backend=backend)
    else:
        min_e, arg = E.min_energies_static_lanes(energies)
    hood_e = E.hood_energy_sums_lanes(hoods, min_e, backend=backend)
    new = E.vote_labels_lanes(hoods, arg, hoods.n_regions, n_labels)
    return new, hood_e


class _DppLanes:
    """The state both workspaces of the modes ``static`` and ``faithful``
    keep per lane (labels, history ring, last hood sums, M-step sums,
    parameters, active word, flag word) and their step: one flat MAP
    iteration (:func:`map_step_lanes`) of every lane, then, per lane, the
    history ring, the window test past the gate and the finiteness test; a
    lane whose MAP loop stops (flag word set, or the cap) leaves the active
    lanes.  A lane that is not active is frozen bit for bit: its compute is
    thrown away.  The step's operation count does not depend on the lanes;
    its one host read is :meth:`flags`.

    :attr:`stats` holds the M-step sums of the lanes whose MAP loop
    stopped.  A stopped lane's labels stay as its last step left them, so
    its sums are taken when the driver reads them, at its EM boundary: one
    ``energy.m_step_sums_lanes`` (three ordered ``add`` launches) for every
    lane that stopped since the last read, however many there are
    (``m_steps`` counts them)."""

    precision = "f32"

    def __init__(self, shape: TickShape, batch: int, *, mode: str, device,
                 backend: Optional[str] = None, max_map_iters: int = 10):
        if mode not in ("static", "faithful"):
            raise ValueError(f"a DPP workspace runs mode 'static' or 'faithful', got {mode!r}")
        if batch < 1:
            raise ValueError(f"a DPP workspace needs batch >= 1, got {batch}")
        cap, n_hoods, n_vert, k = shape
        E.check_lane_key_spaces(batch, cap, n_hoods, n_vert, k)
        self.shape, self.batch, self.mode, self.backend = shape, batch, mode, backend
        self.n_labels, self.max_map_iters = k, max_map_iters
        self.device = dev = torch.device(device)
        f32 = torch.float32
        self.labels = torch.zeros((batch, n_vert), dtype=torch.int32, device=dev)
        self.ring = torch.zeros((batch, WINDOW + 1, n_hoods), dtype=f32, device=dev)
        self.hood_e = torch.zeros((batch, n_hoods), dtype=f32, device=dev)
        self.mu = torch.zeros((batch, k), dtype=f32, device=dev)
        self.sigma = torch.ones((batch, k), dtype=f32, device=dev)
        self.active = torch.zeros((batch,), dtype=torch.bool, device=dev)
        self._flags = torch.zeros((batch,), dtype=torch.int32, device=dev)
        self._stats = torch.zeros((batch, 3, k), dtype=f32, device=dev)
        self._stopped = torch.zeros((batch,), dtype=torch.bool, device=dev)  # sums not yet taken
        self._stale = False  # a step ran since the last read of ``stats``
        self.m_steps = 0     # M-step sums taken (``stats`` reads after a step)
        #: (B, K), or None: stands for ``torch.log`` of the clamped sigma
        #: (``energy.label_energies``'s ``log_sigma``).
        self.log_sigma = None

    def _step(self, hoods: Hoods, model: E.EnergyModel, gate, cap) -> None:
        """``gate`` and ``cap``: bools, or (B,) bool tensors."""
        act = self.active
        new, hood_e = map_step_lanes(hoods, model, self.mode, self.labels, self.mu, self.sigma,
                                     backend=self.backend, log_sigma=self.log_sigma)
        ring = torch.cat([hood_e[:, None], self.ring[:, :-1]], dim=1)
        conv = torch.all(_window_converged(ring.transpose(0, 1)), dim=1) & gate
        div = ~torch.all(torch.isfinite(hood_e), dim=1)
        flag = conv.to(torch.int32) * kops.FLAG_CONVERGED | div.to(torch.int32) * kops.FLAG_DIVERGED
        stop = act & ((flag != 0) | cap)
        self.labels = torch.where(act[:, None], new, self.labels)
        self.hood_e = torch.where(act[:, None], hood_e, self.hood_e)
        self.ring = torch.where(act[:, None, None], ring, self.ring)
        self._flags = torch.where(act, flag, 0)
        self.active = act & ~stop
        self._stopped = self._stopped | stop
        self._stale = True
        kops.count_lane_step()

    @property
    def stats(self) -> Tensor:
        """(B, 3, K): each stopped lane's M-step sums ``(sum_w, sum_wy,
        sum_wyy)`` of the labels its MAP loop stopped at; the first read
        after a step takes them for the lanes that stopped since the last
        one (their rows change, no other lane's)."""
        if self._stale:
            sums = E.m_step_sums_lanes(self._model, self.labels, self.mode, lanes=self._stopped,
                                       backend=self.backend)
            self._stats = torch.where(self._stopped[:, None, None], torch.stack(sums, dim=1),
                                      self._stats)
            self._stopped = torch.zeros_like(self._stopped)
            self._stale = False
            self.m_steps += 1
        return self._stats

    def flags(self) -> list:
        """The B flag words (``kernels.ops.FLAG_*``; 0 for a lane that was
        not active): the step's one host read."""
        return self._flags.tolist()


class DppBatchWorkspace(_DppLanes):
    """:func:`run_em_batched`'s workspace in the modes ``static`` and
    ``faithful`` (``make_workspace(..., batch=B)``), with the interface of
    the tick's ``BatchTickWorkspace``: :meth:`start` binds a stack,
    :meth:`begin_em` starts an EM iteration of the given lanes, each
    :meth:`step` is one flat MAP iteration of the active lanes, the
    iteration ``i`` of each (``gate``: ``i > WINDOW``; ``cap``: ``i ==
    max_map_iters``)."""

    def start(self, hoods: Hoods, model: E.EnergyModel, labels0: Tensor) -> None:
        if TickShape.of(hoods, model) != self.shape or labels0.shape[0] != self.batch:
            raise ValueError(f"a stack of {labels0.shape[0]} problems of "
                             f"{TickShape.of(hoods, model)}; the workspace was built for "
                             f"{self.batch} of {self.shape}")
        self._hoods, self._model = hoods, model
        self.labels = labels0.clone()
        self.active = torch.zeros_like(self.active)
        self._stopped = torch.zeros_like(self._stopped)
        self._stale = False

    def begin_em(self, mu: Tensor, sigma: Tensor, active, log_sigma=None) -> None:
        """The EM iteration's parameters ((B, K), ``sigma`` clamped) and the
        lanes that run it; their rings restart.  ``log_sigma`` as the
        attribute's."""
        self.mu, self.sigma, self.log_sigma = mu, sigma, log_sigma
        self.active = torch.as_tensor([bool(a) for a in active], device=self.device)
        self.ring = self.ring.masked_fill(self.active[:, None, None], 0.0)

    def step(self, gate: bool, cap: bool = False) -> None:
        self._step(self._hoods, self._model, gate, cap)


class DppPoolWorkspace(_DppLanes):
    """:func:`run_em_ticked`'s slot pool in the modes ``static`` and
    ``faithful`` (``make_workspace(..., batch=B, pool=True)``), with the
    interface of the tick's ``PoolTickWorkspace``: it owns each slot's
    problem (hood arrays, the K = 2 replication arrays, region arrays and
    model scalars) and MAP counter (``map_i``); :meth:`admit` writes one
    slot's rows, :meth:`begin_lanes` starts an EM iteration of some slots,
    :meth:`retire` stops one, and each :meth:`step` is one flat MAP
    iteration of the active lanes, each at its own iteration (gate and cap
    from its counter).  Empty slots gather the sentinel vertex and hood and
    keep mu 0 and sigma 1, so their thrown-away compute stays finite."""

    def __init__(self, shape: TickShape, batch: int, **kw):
        super().__init__(shape, batch, **kw)
        cap, n_hoods, n_vert, k = shape
        dev, i32, f32 = self.device, torch.int32, torch.float32
        rep = 2 * cap if k == 2 else 0  # the replication arrays serve faithful K = 2
        self.vertex = torch.full((batch, cap), n_vert - 1, dtype=i32, device=dev)
        self.hood_id = torch.full((batch, cap), n_hoods, dtype=i32, device=dev)
        self.valid = torch.zeros((batch, cap), dtype=torch.bool, device=dev)
        self.rep_old_index = torch.full((batch, rep), cap - 1, dtype=i32, device=dev)
        self.rep_test_label = torch.zeros((batch, rep), dtype=i32, device=dev)
        self.rep_hood_id = torch.full((batch, rep), n_hoods, dtype=i32, device=dev)
        self.rep_valid = torch.zeros((batch, rep), dtype=torch.bool, device=dev)
        self.region_mean = torch.zeros((batch, n_vert), dtype=f32, device=dev)
        self.region_weight = torch.zeros((batch, n_vert), dtype=f32, device=dev)
        self.beta = torch.zeros((batch,), dtype=f32, device=dev)
        self.sigma_min = torch.zeros((batch,), dtype=f32, device=dev)
        self.reseed_mu = torch.zeros((batch, k), dtype=f32, device=dev)
        self.reseed_sigma = torch.ones((batch,), dtype=f32, device=dev)
        self.map_i = torch.zeros((batch,), dtype=i32, device=dev)
        self.owner = None
        self._hoods = Hoods(
            vertex=self.vertex, hood_id=self.hood_id, valid=self.valid, sizes=None,
            offsets=None, n_hoods=n_hoods, n_regions=n_vert - 1, n_elements=-1,
            rep_old_index=self.rep_old_index, rep_test_label=self.rep_test_label,
            rep_hood_id=self.rep_hood_id, rep_valid=self.rep_valid)
        self._model = E.EnergyModel(self.region_mean, self.region_weight, self.beta,
                                    self.sigma_min, self.reseed_mu, self.reseed_sigma)

    def _check_slot(self, slot: int) -> int:
        if not 0 <= slot < self.batch:
            raise ValueError(f"slot {slot} outside the pool's {self.batch} slots")
        return slot

    def admit(self, slot: int, hoods: Hoods, model: E.EnergyModel, labels0: Tensor) -> None:
        """Write one request's padded problem into ``slot`` (inactive until
        :meth:`begin_lanes`); no other slot's rows move."""
        self._check_slot(slot)
        if TickShape.of(hoods, model) != self.shape:
            raise ValueError(f"a problem of {TickShape.of(hoods, model)}; the pool was built "
                             f"for {self.shape}")
        self.active[slot] = False
        pairs = [(self.vertex, hoods.vertex), (self.hood_id, hoods.hood_id),
                 (self.valid, hoods.valid), (self.region_mean, model.region_mean),
                 (self.region_weight, model.region_weight), (self.beta, model.beta),
                 (self.sigma_min, model.sigma_min), (self.reseed_mu, model.reseed_mu),
                 (self.reseed_sigma, model.reseed_sigma), (self.labels, labels0)]
        if self.n_labels == 2:
            pairs += [(self.rep_old_index, hoods.rep_old_index),
                      (self.rep_test_label, hoods.rep_test_label),
                      (self.rep_hood_id, hoods.rep_hood_id), (self.rep_valid, hoods.rep_valid)]
        for dst, src in pairs:
            dst[slot].copy_(src)
        self.map_i[slot] = 0
        self._stopped[slot] = False

    def begin_lanes(self, slots, mu: Tensor, sigma: Tensor) -> None:
        """Start an EM iteration of ``slots``: their parameters (rows of
        ``mu`` and ``sigma``, clamped), rings and MAP counters."""
        idx = torch.as_tensor(list(slots), dtype=torch.long, device=self.device)
        self.mu[idx] = mu
        self.sigma[idx] = sigma
        self.ring[idx] = 0.0
        self.map_i[idx] = 0
        self.active[idx] = True

    def retire(self, slot: int) -> None:
        self.active[self._check_slot(slot)] = False

    def step(self) -> None:
        i = self.map_i + 1
        act = self.active
        self._step(self._hoods, self._model, i > WINDOW, i == self.max_map_iters)
        self.map_i = torch.where(act, i, self.map_i)


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
    """The EM driver of the modes ``static`` and ``faithful`` on either
    route and of mode ``static-pallas`` on the sharded route; only the MAP
    loop and the collective context differ.  (Mode ``static-pallas`` on
    one device is the compiled program, :func:`_run_program`.)

    When ``ctx`` is sharded, ``hoods`` is this rank's element block (with
    globally indexed ``vertex``/``hood_id``) while ``model``, ``labels0``,
    ``mu0`` and ``sigma0`` are the same on every rank, and so is all label
    and parameter state after each step.  In mode ``static-pallas``,
    ``workspace`` is the rank's ``kernels.ops.map_step_workspace``
    (``distributed.make_workspace``): one step, one flag read and one
    all-reduce per MAP iteration, with the AND of the flag word past the
    window.  The modes take no workspace (:func:`_map_loop`).
    """
    validate_config(config)
    n_hoods = hoods.n_hoods
    dev = labels0.device
    f32 = torch.float32
    fused = config.mode == "static-pallas"
    if fused and not ctx.sharded:
        raise ValueError("mode 'static-pallas' on one device runs the compiled EM program "
                         "(run_em), not this driver")
    if not fused:
        if workspace is not None:
            raise ValueError(f"mode {config.mode!r} takes no workspace")
        labels = labels0
    else:
        sctx = E.make_static_context(hoods, model, backend=config.backend, ctx=ctx)
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
    cen = _census.ACTIVE
    while em_i < config.max_em_iters and not done:
        if cen is not None:
            cen.enter(_EM)
        i = 0
        if not fused:
            labels, hood_energy, i, map_div = _map_loop(hoods, model, labels, mu, sigma, config, ctx)
            mu, sigma, sum_w = E.update_parameters_stats(model, labels, config.mode,
                                                         backend=config.backend)
        else:
            # MAP loop: per iteration one launch (the head tests iteration
            # i, the step computes i + 1), the AND of the flag word past
            # the window, one flag read and one all-reduce of the step.  The
            # launch that stops the loop only tests: its step is dropped.
            ws.begin_em(mu, torch.maximum(sigma, model.sigma_min))
            while True:
                if cen is not None:
                    cen.enter(_MAP)
                more = i < config.max_map_iters
                ws.step(i > WINDOW, step=more)
                if i > WINDOW:
                    # Every rank has the same i, so all skip or all join the
                    # collective.
                    ctx.and_flags(ws.flag_word)
                flag = ws.flag()
                if flag or not more:
                    break
                ctx.psum(ws.buffer)
                i += 1
            if cen is not None:
                cen.leave(_MAP)
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
    if cen is not None:
        cen.leave(_EM)

    # The workspace's buffers belong to the plan.
    labels = ws.labels.clone() if fused else labels.clone()
    hood_energy = hood_energy.clone()
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
    """EM on one problem, on the device its tensors live on.  In mode
    ``static-pallas`` the compiled EM program of ``workspace``
    (``make_workspace``: the bucket's buffers and program, carried across
    its solves; without it the solve builds its own): on the card one graph
    launch and one host read.  The modes ``static`` and ``faithful`` take
    no workspace."""
    if config.mode != "static-pallas":
        return _em_driver(hoods, model, labels0, mu0, sigma0, config, collectives.LOCAL, workspace)
    (labels, mu, sigma, hood_e, total), em_iters, map_iters, status, _ = _run_program(
        hoods, model, labels0, mu0, sigma0, config, workspace, None)
    return EMResult(labels=labels[0], mu=mu[0], sigma=sigma[0], hood_energy=hood_e[0],
                    total_energy=total[0], em_iters=em_iters[0], map_iters=map_iters[0],
                    status=status[0])


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
    steps: int            # lockstep MAP iterations: steps of the workspace

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
    stays inactive.  In mode ``static-pallas`` that is the stack's compiled
    program (:func:`_run_program`; on the card one graph launch: per
    lockstep MAP iteration one launch of the tick's lane entry, per EM
    iteration one of the boundary's lane form, and one host read).  In the
    modes ``static`` and ``faithful``, per MAP iteration one flat MAP
    iteration of every lane on the workspace and one read of the B flag
    words; per EM iteration the boundary over every lane at once
    (``params_from_stats`` on (B, 3, K), the divergence and degeneracy
    tests, the total-energy rings) and one host read.  Each lane's result
    is its own :func:`run_em`'s bit for bit.
    ``workspace`` (``make_workspace(..., batch=B)``) carries the buffers
    across solves of one bucket and batch size.
    """
    validate_config(config)
    n_hoods = hoods.n_hoods
    batch, dev, f32 = int(labels0.shape[0]), labels0.device, torch.float32
    n_labels = model.n_labels
    if config.mode == "static-pallas":
        (labels, mu, sigma, hood_e, total), em_iters, map_iters, status, steps = _run_program(
            hoods, model, labels0, mu0, sigma0, config, workspace, batch)
        return BatchedEMResult(labels=labels, mu=mu, sigma=sigma, hood_energy=hood_e,
                               total_energy=total, em_iters=tuple(em_iters),
                               map_iters=tuple(map_iters), status=tuple(status), steps=steps)
    ws = workspace if workspace is not None else make_workspace(
        TickShape.of(hoods, model), config, device=dev, batch=batch)
    _check_workspace(ws, config, n_labels)
    if ws.batch != batch:
        raise ValueError(f"workspace built for {ws.batch} lanes, the stack has {batch}")
    ws.start(hoods, model, labels0)

    mu, sigma = mu0, sigma0
    hood_energy = torch.zeros((batch, n_hoods), dtype=f32, device=dev)
    total_hist = torch.zeros((batch, WINDOW + 1), dtype=f32, device=dev)
    em_iters, map_iters = [0] * batch, [0] * batch
    status = [STATUS_OK] * batch
    running = [True] * batch   # lanes whose EM has not finished
    em_i = 0                   # every running lane is at the same EM iteration
    steps = 0
    cen = _census.ACTIVE
    while em_i < config.max_em_iters and any(running):
        if cen is not None:
            cen.enter(_EM)
        lanes = list(running)
        ws.begin_em(mu, torch.maximum(sigma, model.sigma_min[:, None]), lanes)
        # MAP loop: per iteration one launch for the running lanes and one
        # read of their flag words; a lane's stopping launch takes its
        # M-step sums and retires it until the next EM iteration.
        in_map, flags, lane_map = list(lanes), [0] * batch, [0] * batch
        i = 0
        while i < config.max_map_iters and any(in_map):
            if cen is not None:
                cen.enter(_MAP)
            i += 1
            cap = i == config.max_map_iters
            ws.step(i > WINDOW, cap)
            steps += 1
            words = ws.flags()
            for b in range(batch):
                if in_map[b]:
                    lane_map[b], flags[b] = i, words[b]
                    in_map[b] = not (words[b] or cap)
        if cen is not None:
            cen.leave(_MAP)
        if i:
            he, msums = ws.hood_e, ws.stats
        else:
            # No MAP iteration: the modes' M-step still reads the labels.
            he = hood_energy.new_zeros(hood_energy.shape)
            msums = torch.stack(
                E.m_step_sums_lanes(model, ws.labels, config.mode, backend=config.backend), dim=1)
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
    if cen is not None:
        cen.leave(_EM)

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
# EM and MAP iterations, and advances it by micro-steps: one step of the
# pool (a launch of the tick's pool entry in mode static-pallas, one flat
# MAP iteration of every lane in the modes static and faithful), in which
# each active lane runs its own next MAP iteration, and one read of the B
# flag words.  Where a lane's MAP loop stopped, one launch of the boundary
# kernel's lane form runs that lane's EM boundary at its own EM iteration
# (``_tick_boundary``), and the host reads the words it wrote and starts the
# lane's next EM iteration, or marks it done.  Between calls the caller retires done
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
    micro_steps: int = 0     # pool steps issued on this state (a failed tick
                             # that issued none may be replayed)

    @property
    def batch(self) -> int:
        return len(self.done)

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


# What a pool workspace holds for its lanes, by the mode's family: the
# inputs a tick only reads, and the state it writes.  Both routes' pools of
# one family have these names (the kernel pool's ``labels``, ``votes``,
# ``active`` and ``map_i`` are views of its parity-swapped buffers and
# words); the kernel pool keeps its hood runs as ``offsets`` where the
# plain one keeps ``hood_id``.
_POOL_INPUTS = {
    "static-pallas": ("y", "w", "nall", "valid", "vertex", "region_mean", "region_weight", "beta"),
    "dpp": ("vertex", "hood_id", "valid", "rep_old_index", "rep_test_label", "rep_hood_id",
            "rep_valid", "region_mean", "region_weight", "beta", "sigma_min", "reseed_mu",
            "reseed_sigma"),
}
_POOL_STATE = {
    "static-pallas": ("labels", "votes", "ring", "hood_e", "stats", "active", "map_i", "mu",
                      "sigma"),
    "dpp": ("labels", "ring", "hood_e", "active", "map_i", "mu", "sigma", "_flags", "_stats",
            "_stopped"),
}
#: A DPP pool's host attributes: the M-step read's bookkeeping.
_DPP_ATTRS = ("_stale", "m_steps", "log_sigma")


def _family(ws) -> str:
    return "static-pallas" if ws.mode == "static-pallas" else "dpp"


@dataclass(eq=False)
class TickSnapshot:
    """A copy of everything a tick writes in a pool: the workspace's lane
    state (``buffers``, and a DPP pool's host attributes), and the
    :class:`TickState` with its tensors cloned and its host lists copied
    (``state``, no workspace).  :func:`carry_tick_state` takes it up."""

    buffers: dict
    attrs: dict
    state: TickState


def _state_copy(state: TickState, workspace) -> TickState:
    """``state`` on ``workspace``, its tensors cloned and host lists copied."""
    return TickState(
        workspace=workspace, mu=state.mu.clone(), sigma=state.sigma.clone(),
        total_hist=state.total_hist.clone(), sigma_min=state.sigma_min.clone(),
        reseed_mu=state.reseed_mu.clone(), reseed_sigma=state.reseed_sigma.clone(),
        em_i=list(state.em_i), map_i=list(state.map_i), map_total=list(state.map_total),
        done=list(state.done), status=list(state.status), micro_steps=state.micro_steps)


def tick_snapshot(state: TickState) -> TickSnapshot:
    """The pool's state as it stands, copied: the point a failed tick is
    replayed from (:func:`carry_tick_state`).  Device copies of the lanes'
    written buffers, none of their inputs (a tick does not write them)."""
    ws = state.workspace
    family = _family(ws)
    return TickSnapshot(
        buffers={n: getattr(ws, n).clone() for n in _POOL_STATE[family]},
        attrs={n: getattr(ws, n) for n in _DPP_ATTRS} if family == "dpp" else {},
        state=_state_copy(state, None),
    )


def hood_ids(offsets: Tensor, valid: Tensor, n_hoods: int) -> Tensor:
    """Each element's hood (``Hoods.hood_id``, ``n_hoods`` for an invalid
    element) from the hood runs ``offsets`` ((..., n_hoods + 1)) and the
    element mask ``valid`` ((..., capacity), bool or float): the kernel
    pool keeps the runs, the plain one the ids."""
    ends = offsets[..., 1:].contiguous()
    elems = torch.arange(valid.shape[-1], dtype=offsets.dtype, device=offsets.device)
    hid = torch.searchsorted(ends, elems.expand(valid.shape).contiguous(), right=True)
    return torch.where(valid.bool(), hid.to(torch.int32), n_hoods)


def carry_tick_state(state: TickState, workspace, snapshot: Optional[TickSnapshot] = None) -> TickState:
    """``state``'s pool carried onto ``workspace``, another route's pool of
    the same bucket, slots, K, mode, precision and MAP cap: every lane's
    inputs (the element or hood arrays, the region arrays, ``beta``) from
    ``state``'s workspace, and every lane's written state (labels, ring,
    hood energies, M-step sums, active word, MAP counter, parameters) with
    the host counters, health and ``micro_steps`` from ``snapshot`` (the
    point a failed tick is replayed from), or from ``state`` as it stands.
    Returns the new :class:`TickState`, which takes ``workspace`` over
    (``workspace.owner``, as :func:`blank_tick_state`); each lane then goes
    on bit for bit as it would have on ``state``'s route, where the two
    routes' steps agree.  The target must be a pool whose buffers are its
    own tensors (the plain pool, or a DPP pool): the plain route is the one
    a pool falls back to."""
    src = state.workspace
    family = _family(src)
    if not isinstance(workspace, (PlainPoolTickWorkspace, DppPoolWorkspace)):
        raise ValueError(f"a pool is carried onto a plain or DPP pool, not {type(workspace).__name__}")
    if workspace is src:
        raise ValueError("carry_tick_state needs another pool workspace")
    mine = (src.mode, src.precision, tuple(src.shape), src.batch, src.max_map_iters)
    theirs = (workspace.mode, workspace.precision, tuple(workspace.shape), workspace.batch,
              workspace.max_map_iters)
    if mine != theirs:
        raise ValueError(f"pool of (mode, precision, shape, slots, MAP cap) {mine} carried onto "
                         f"one of {theirs}")
    snap = snapshot if snapshot is not None else tick_snapshot(state)
    for name in _POOL_INPUTS[family]:
        getattr(workspace, name).copy_(getattr(src, name))
    if family == "static-pallas":
        hid = src.hood_id if hasattr(src, "hood_id") else hood_ids(src.offsets, src.valid,
                                                                  src.shape.n_hoods)
        workspace.hood_id.copy_(hid)
    for name, t in snap.buffers.items():
        getattr(workspace, name).copy_(t)
    for name, v in snap.attrs.items():
        setattr(workspace, name, v)
    new = _state_copy(snap.state, workspace)
    workspace.owner = weakref.ref(new)
    return new


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
    when not given; the modes ``static`` and ``faithful`` read none).  The
    lane starts its first EM iteration, as ``run_em`` does; no other lane's
    buffers move."""
    ws = state.workspace
    if ws.mode == "static-pallas":
        if sctx is None:
            sctx = E.make_static_context(hoods, model)
        ws.admit(slot, hoods, model, sctx.y, sctx.w, sctx.nall_e, sctx.validf, labels0)
    else:
        ws.admit(slot, hoods, model, labels0)
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
    """The EM boundary of the lanes whose MAP loop just stopped: the
    boundary kernel's lane form over the pool (``kops.em_boundary_lanes``,
    on the plain route ``ref.em_boundary_lanes``: ``params_from_stats``,
    the divergence and degeneracy tests, the total-energy rings, the
    status, each lane at its own EM iteration) with those lanes running,
    from one copy of their words to the device; then one host read of the
    words it wrote, and the lanes that go on start their next EM
    iteration."""
    cen = _census.ACTIVE
    if cen is not None:
        cen.enter(_EM)
    ws, dev, batch = state.workspace, state.mu.device, state.batch
    stopped = [0] * batch
    for b in lanes:
        stopped[b] = 1
    words = torch.tensor([[0] * batch, state.map_i, flags, stopped, state.em_i, state.map_total,
                          state.status, [0] * batch], dtype=torch.int32).to(dev)
    ctl = torch.zeros((len(CTL_WORDS),), dtype=torch.int32, device=dev)
    kops.em_boundary_lanes(
        BoundaryState(ws.stats, ws.hood_e, words, ctl, state.mu, state.sigma, ws.mu, ws.sigma,
                      ws.ring, state.total_hist, state.sigma_min, state.reseed_mu,
                      state.reseed_sigma),
        max_em_iters=config.max_em_iters, max_map_iters=config.max_map_iters, conv_tol=CONV_TOL,
        backend=config.backend)
    rows = words.tolist()
    go, em_iters, map_iters, status = (rows[r] for r in (ACTIVE, EM_ITERS, MAP_ITERS, STATUS))
    go_on = []
    for b in lanes:
        state.em_i[b], state.map_total[b], state.status[b] = em_iters[b], map_iters[b], status[b]
        state.map_i[b] = 0
        if go[b]:
            go_on.append(b)
        else:
            state.done[b] = True
    if go_on:
        state.begin(go_on)
    if cen is not None:
        cen.leave(_EM)


def _tick_micro(state: TickState, config: EMConfig) -> None:
    """One micro-step: one step of the pool (every lane not done runs its
    next MAP iteration) and one read of the flag words; the host mirrors
    each lane's stopping rule (flag word set, or the cap), as the step
    applies it, and runs the EM boundary of the lanes that stopped."""
    cen = _census.ACTIVE
    if cen is not None:
        cen.enter(_MAP)
    ws = state.workspace
    state.micro_steps += 1
    ws.step()
    words = ws.flags()
    stopped = []
    for b in range(state.batch):
        if state.done[b]:
            continue
        state.map_i[b] += 1
        if words[b] or state.map_i[b] == config.max_map_iters:
            stopped.append(b)
    if cen is not None:
        cen.leave(_MAP)
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
    whatever shares its pool, in every mode: the pool (``make_workspace(...,
    pool=True)``) must have been built for ``config``'s mode.
    """
    validate_config(config)
    if config.max_em_iters < 1 or config.max_map_iters < 1:
        raise ValueError("run_em_ticked requires max_em_iters/max_map_iters >= 1")
    if tick_iters < 1:
        raise ValueError(f"tick_iters must be >= 1, got {tick_iters}")
    ws = state.workspace
    if ws.owner is None or ws.owner() is not state:
        raise ValueError("the pool workspace belongs to another TickState (blank_tick_state)")
    if (ws.mode, ws.precision, ws.max_map_iters) != (
            config.mode, config.precision, config.max_map_iters):
        raise ValueError(
            f"pool built for mode {ws.mode!r}, precision {ws.precision!r} and max_map_iters "
            f"{ws.max_map_iters}, the config has {config.mode!r}, {config.precision!r} and "
            f"{config.max_map_iters}")
    steps = 0
    while steps < tick_iters and not all(state.done):
        _tick_micro(state, config)
        steps += 1
    return state, steps
