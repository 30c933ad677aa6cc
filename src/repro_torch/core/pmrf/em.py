"""EM / MAP optimization driver (paper Alg. 2, lines 6-12).

Counterpart of ``repro.core.pmrf.em``.  An outer EM loop (parameter
estimation) wraps an inner MAP loop (label inference).  Convergence
follows §3.2.2: per-hood energy sums over the last L=3 iterations,
converged when every change is below 1e-4 (relative).

The execution ``mode`` selects the MAP iteration.  ``static`` and
``faithful`` are the paper's primitive sequence (:func:`map_step`: counts,
energies, the per-element minimum by an axis-min or by the paper's
Gather / SortByKey / ReduceByKey(Min), hood sums, votes), each primitive
its own operation; the EM boundary takes ``energy.update_parameters_stats``.
The float sums of these modes go through ``segment_reduce``'s
element-order ``add``, so on the card they are the CPU plain path's bits.
``static-pallas`` fuses the iteration into one kernel launch.

On one device every driver is a **compiled program**, as every driver of
the reference is one ``jit`` with its loops on the device: a workspace
built from the bucket's shapes and the EM limits (:func:`make_workspace`)
holds, on the card, one CUDA graph, so a call is one graph launch and one
host read of mapped result words; on the CPU, or with ``backend="torch"``,
the same control structure runs as a plain program on the host.

* :func:`run_em` and :func:`run_em_batched` (:func:`_run_program`): the
  reference's ``Segmenter.compile`` executable, a stack's the vmapped
  ``run_em``: the MAP loop and the EM loop as two conditional nodes.  In
  mode ``static-pallas`` the MAP step is one launch of the tick's lane
  entry (``kernels.em_tick``; plain program ``kernels.ref.run_program``);
  in the modes it is one flat MAP iteration of every lane
  (:func:`map_step_lanes` on a :class:`DppBatchWorkspace`, one problem
  being one lane), captured with PyTorch's graph capture and cloned into
  the program (``em_tick.ModesProgram``), followed by the MAP loop's
  control kernel; each EM iteration then runs the captured M-step (the
  modes) and the boundary kernel's lane form (``csrc/em_boundary.cuh``).
* :func:`run_em_ticked` (:func:`_tick_program`): the reference's
  continuous-batching driver, a tick of a slot pool whose lanes sit at
  different EM and MAP iterations.  The tick is one graph
  (``em_tick.TickProgram``, ``csrc/em_control.cuh``): per micro-step the
  pool's step (the tick's pool entry, or the modes' captured flat step),
  the stop test, and, where some lane's MAP loop stopped, an IF node with
  the modes' M-step and the boundary kernel's lane form, each lane at its
  own EM iteration; its loop exits early once every lane is done.  The
  plain tick runs the same kernels' plain versions (``kernels.ref.tick_init``,
  ``tick_stops``, ``tick_tail``, ``tick_publish``) with no read inside: its
  ``tick_iters`` micro-steps (:func:`_tick_micro`) take the loop's and the
  IF node's conditions as masks, and its one read is the publish.

In each, every lane's result equals its own :func:`run_em`'s bit for bit.
``testing.host_loop`` keeps the host-stepped drivers (per MAP iteration
one step and one read of the flag words, per EM iteration the host's
boundary and its read) as the programs' parity reference.

The sharded route (``distributed.run_em_sharded``) still steps from the
host: one driver for one problem (:func:`_em_driver`), parametrised by a
collective context (``collectives.ReduceCtx``).  In mode
``static-pallas`` each MAP iteration is one ``fused_map_step`` launch on
the rank's workspace (the last step's labels and tests, this step's
counts, energies, hood sums and votes), one all-reduce of the step's hood
sums and votes and, past the window, the AND of the flag word; the launch
that stops the MAP loop also sums the M-step's per-label terms in vertex
order.  In the modes, :func:`_map_loop` runs :func:`map_step` through the
context.  Every convergence decision goes through the context, so all
ranks take the same trajectory; its ``while_loop``s are Python loops that
read the MAP ``done`` flag once per MAP iteration and three words per EM
boundary.

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
from repro_torch.kernels import ref
from repro_torch.kernels.ref import (ACTIVE, CTL_WORDS, FLAG, LANE_WORDS, MAP_I, TICK_WORDS,
                                     BoundaryState, PlainPoolTickWorkspace, TickShape)

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
    ``config``, built from the shapes alone, with the compiled EM program
    of ``config``'s limits: for :func:`run_em`, with ``batch=B`` for
    :func:`run_em_batched`, or with ``batch=B, pool=True`` the slot pool of
    :func:`run_em_ticked` (its program is the tick).  In mode
    ``static-pallas`` a tick workspace (``kernels.ops.tick_workspace``); in
    the modes ``static`` and ``faithful`` a :class:`DppBatchWorkspace` (one
    problem is one lane) or a :class:`DppPoolWorkspace`.  On the card the
    program is one CUDA graph, on the plain route the same control run by
    the host.  A session keeps one per bucket (and per pool) and every solve
    of the bucket reuses it (``workspace=``); ``kernels.ops.WORKSPACE_BUILDS``
    counts every build and ``kernels.ops.PROGRAM_BUILDS`` every program."""
    if config.mode == "static-pallas":
        return kops.tick_workspace(
            shape, device=device, batch=batch, pool=pool, max_map_iters=config.max_map_iters,
            max_em_iters=config.max_em_iters, precision=config.precision,
            conv_tol=CONV_TOL, window=WINDOW, backend=config.backend,
        )
    if pool and batch is None:
        raise ValueError("a pool workspace needs batch=B")
    cls = DppPoolWorkspace if pool else DppBatchWorkspace
    ws = cls(TickShape(*shape), 1 if batch is None else batch, mode=config.mode, device=device,
             backend=config.backend, max_map_iters=config.max_map_iters,
             max_em_iters=config.max_em_iters)
    kops.count_workspace_build()
    kops.count_program_build("pool" if pool else "solve" if batch is None else "stack")
    return ws


def _check_workspace(ws, config: EMConfig, n_labels: int) -> None:
    if not all(hasattr(ws, a) for a in ("mode", "precision", "n_labels", "run_program")):
        raise ValueError(f"a {type(ws).__name__} is not a workspace of the compiled EM program "
                         "(make_workspace)")
    if (ws.mode, ws.precision, ws.n_labels) != (config.mode, config.precision, n_labels):
        raise ValueError(
            f"workspace built for mode {ws.mode!r}, precision {ws.precision!r} and "
            f"K = {ws.n_labels}, the solve has {config.mode!r}, {config.precision!r} and "
            f"K = {n_labels}"
        )
    limits = (getattr(ws, "max_em_iters", None), getattr(ws, "max_map_iters", None))
    if limits != (config.max_em_iters, config.max_map_iters):
        raise ValueError(
            f"workspace built with the EM program of (max_em_iters, max_map_iters) "
            f"{limits}, the solve has {(config.max_em_iters, config.max_map_iters)}")


def _run_program(hoods: Hoods, model: E.EnergyModel, labels0: Tensor, mu0: Tensor,
                 sigma0: Tensor, config: EMConfig, workspace, batch: Optional[int]):
    """The compiled EM program on one device, in every mode: in mode
    ``static-pallas`` the element arrays (``energy.make_static_context``,
    one ``segment_reduce`` launch) first; ``start`` (the solve's arrays
    copied into the workspace), the program (on the card one graph launch,
    on the plain route the plain program) and one read of its counters;
    then the result, copied out of the workspace.  ``batch`` None for one problem,
    else the stack's lanes.  Returns ``(outputs, em_iters, map_iters,
    status, steps)``: ``outputs`` (labels, mu, sigma, hood energies,
    total energies) with a lane axis, the counts one int per lane."""
    validate_config(config)
    dev = labels0.device
    n_labels = model.n_labels
    ws = workspace if workspace is not None else make_workspace(
        TickShape.of(hoods, model), config, device=dev, batch=batch)
    _check_workspace(ws, config, n_labels)
    lanes = 1 if batch is None else batch
    if getattr(ws, "batch", lanes) != lanes:
        raise ValueError(f"workspace built for {ws.batch} lanes, the solve has {lanes}")
    cen = _census.ACTIVE
    if cen is not None:
        cen.enter(_SOLVE)
    if config.mode != "static-pallas":
        ws.start(hoods, model, labels0, mu0, sigma0)
    elif batch is None:
        sctx = E.make_static_context(hoods, model, backend=config.backend)
        ws.start(hoods, model, sctx.y, sctx.w, sctx.nall_e, sctx.validf, labels0, mu0, sigma0)
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
    keep per lane, and their step.  Every buffer is the workspace's own,
    fixed for its life, so the captured step of the compiled program reads
    and writes the same addresses at every replay: the lanes' problems
    (hood arrays, the K = 2 replication arrays, region arrays, model
    scalars; empty lanes gather the sentinel vertex and hood and keep mu 0
    and sigma 1, so their thrown-away compute stays finite), labels,
    history ring, last hood sums, M-step sums, parameters, the lane block
    (``kernels.ref.LANE_WORDS``: the active word, MAP counter and flag word
    are views of its rows, ``active``, ``map_i`` and ``_flags``) and the
    program's words and EM level (``em_mu``, ``em_sigma``, ``total_hist``).

    The step is one flat MAP iteration (:func:`map_step_lanes`) of every
    lane, then, per lane, the history ring, the window test past the gate
    and the finiteness test; a lane whose MAP loop stops (flag word set, or
    the cap) leaves the active lanes.  A lane that is not active is frozen
    bit for bit: its compute is thrown away.  Every result is written in
    place (``copy_``), and the step's operation count does not depend on the
    lanes.  Host-stepped, its one host read is :meth:`flags`.

    :attr:`stats` holds the M-step sums of the lanes whose MAP loop
    stopped: the first read after a step takes them for every lane that
    stopped since the last read, in one ``energy.m_step_sums_lanes`` (three
    ordered ``add`` launches; ``m_steps`` counts them).

    Built with the EM limits (``max_em_iters`` not None) a workspace also
    holds its compiled program: on the card (the kernel route) one CUDA
    graph with the step and the M-step captured into it
    (``kernels.em_tick.ModesProgram``, or a pool's ``TickProgram``), on the
    plain route the same control structure run by the host
    (``kernels.ref.run_program``; the pool's plain tick)."""

    precision = "f32"

    def __init__(self, shape: TickShape, batch: int, *, mode: str, device,
                 backend: Optional[str] = None, max_map_iters: int = 10, max_em_iters=None):
        if mode not in ("static", "faithful"):
            raise ValueError(f"a DPP workspace runs mode 'static' or 'faithful', got {mode!r}")
        if batch < 1:
            raise ValueError(f"a DPP workspace needs batch >= 1, got {batch}")
        cap, n_hoods, n_vert, k = shape
        E.check_lane_key_spaces(batch, cap, n_hoods, n_vert, k)
        self.shape, self.batch, self.mode, self.backend = shape, batch, mode, backend
        self.n_labels, self.max_map_iters = k, max_map_iters
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        f32, i32 = torch.float32, torch.int32
        z = lambda *s, dtype=f32: torch.zeros((batch, *s), dtype=dtype, device=dev)  # noqa: E731
        one = lambda *s: torch.ones((batch, *s), dtype=f32, device=dev)  # noqa: E731
        rep = 2 * cap if k == 2 else 0  # the replication arrays serve faithful K = 2
        self.vertex = torch.full((batch, cap), n_vert - 1, dtype=i32, device=dev)
        self.hood_id = torch.full((batch, cap), n_hoods, dtype=i32, device=dev)
        self.valid = z(cap, dtype=torch.bool)
        self.rep_old_index = torch.full((batch, rep), cap - 1, dtype=i32, device=dev)
        self.rep_test_label = z(rep, dtype=i32)
        self.rep_hood_id = torch.full((batch, rep), n_hoods, dtype=i32, device=dev)
        self.rep_valid = z(rep, dtype=torch.bool)
        self.region_mean, self.region_weight = z(n_vert), z(n_vert)
        self.beta, self.sigma_min, self.reseed_sigma = z(), one(), one()
        self.reseed_mu = z(k)
        self.labels = z(n_vert, dtype=i32)
        self.ring = z(WINDOW + 1, n_hoods)
        self.hood_e = z(n_hoods)
        self.mu, self.sigma = z(k), one(k)
        self._stats = z(3, k)
        self._stopped = z(dtype=torch.bool)  # stopped lanes whose sums are not yet taken
        self.lane = torch.zeros((len(LANE_WORDS), batch), dtype=i32, device=dev)
        self.ctl = torch.zeros((len(CTL_WORDS),), dtype=i32, device=dev)
        self.tick = torch.zeros((len(TICK_WORDS),), dtype=i32, device=dev)
        self.active, self.map_i, self._flags = self.lane[ACTIVE], self.lane[MAP_I], self.lane[FLAG]
        self.em_mu, self.em_sigma, self.total_hist = z(k), one(k), z(WINDOW + 1)
        self.mu0, self.sigma0 = z(k), one(k)
        self._stale = False  # a step ran since the last read of ``stats``
        self.m_steps = 0     # M-step sums taken
        #: (B, K), or None: stands for ``torch.log`` of the clamped sigma
        #: (``energy.label_energies``'s ``log_sigma``); host-stepped only.
        self.log_sigma = None
        self._hoods = Hoods(
            vertex=self.vertex, hood_id=self.hood_id, valid=self.valid, sizes=None,
            offsets=None, n_hoods=n_hoods, n_regions=n_vert - 1, n_elements=-1,
            rep_old_index=self.rep_old_index, rep_test_label=self.rep_test_label,
            rep_hood_id=self.rep_hood_id, rep_valid=self.rep_valid)
        self._model = E.EnergyModel(self.region_mean, self.region_weight, self.beta,
                                    self.sigma_min, self.reseed_mu, self.reseed_sigma)
        self.max_em_iters = max_em_iters
        self.program = None
        self._captured = None
        self.program_launches = {}

    # -- the lanes' problems --------------------------------------------------

    def _inputs(self, hoods: Hoods, model: E.EnergyModel) -> list:
        pairs = [(self.vertex, hoods.vertex), (self.hood_id, hoods.hood_id),
                 (self.valid, hoods.valid), (self.region_mean, model.region_mean),
                 (self.region_weight, model.region_weight), (self.beta, model.beta),
                 (self.sigma_min, model.sigma_min), (self.reseed_mu, model.reseed_mu),
                 (self.reseed_sigma, model.reseed_sigma)]
        if self.n_labels == 2:
            pairs += [(self.rep_old_index, hoods.rep_old_index),
                      (self.rep_test_label, hoods.rep_test_label),
                      (self.rep_hood_id, hoods.rep_hood_id), (self.rep_valid, hoods.rep_valid)]
        return pairs

    def _kernel_route(self) -> bool:
        return kops._use_kernel(self.backend, self.device)

    # -- the step and the M-step (device work only) ---------------------------

    def _step_core(self, gate, cap, i: Optional[Tensor] = None) -> None:
        """One flat MAP iteration of the active lanes, in place; ``gate`` and
        ``cap`` bools or (B,) bool tensors, ``i`` (B,) the iteration each
        lane runs (its MAP counter's next value) or None."""
        act = self.active != 0
        new, hood_e = map_step_lanes(self._hoods, self._model, self.mode, self.labels, self.mu,
                                     self.sigma, backend=self.backend, log_sigma=self.log_sigma)
        ring = torch.cat([hood_e[:, None], self.ring[:, :-1]], dim=1)
        conv = torch.all(_window_converged(ring.transpose(0, 1)), dim=1) & gate
        div = ~torch.all(torch.isfinite(hood_e), dim=1)
        flag = conv.to(torch.int32) * kops.FLAG_CONVERGED | div.to(torch.int32) * kops.FLAG_DIVERGED
        stop = act & ((flag != 0) | cap)
        self.labels.copy_(torch.where(act[:, None], new, self.labels))
        self.hood_e.copy_(torch.where(act[:, None], hood_e, self.hood_e))
        self.ring.copy_(torch.where(act[:, None, None], ring, self.ring))
        self._flags.copy_(torch.where(act, flag, 0))
        self.active.copy_(act & ~stop)
        torch.logical_or(self._stopped, stop, out=self._stopped)
        if i is not None:
            self.map_i.copy_(torch.where(act, i, self.map_i))

    def _lane_step(self) -> None:
        """:meth:`_step_core` with each lane at its own MAP iteration, its
        gate and cap from its counter (the pool's step, and the program's)."""
        i = self.map_i + 1
        self._step_core(i > WINDOW, i == self.max_map_iters, i)

    def _mstep_core(self, every_lane: bool = False) -> None:
        """The M-step sums of the stopped lanes (``every_lane``: of every
        lane, the modes' M-step when no MAP iteration ran) into ``_stats``,
        in place; no lane is left stopped."""
        sums = E.m_step_sums_lanes(self._model, self.labels, self.mode,
                                   lanes=None if every_lane else self._stopped, backend=self.backend)
        sums = torch.stack(sums, dim=1)
        self._stats.copy_(sums if every_lane else torch.where(self._stopped[:, None, None], sums,
                                                               self._stats))
        self._stopped.zero_()

    @property
    def stats(self) -> Tensor:
        """(B, 3, K): each stopped lane's M-step sums ``(sum_w, sum_wy,
        sum_wyy)`` of the labels its MAP loop stopped at; the first read
        after a step takes them for the lanes that stopped since the last
        one (their rows change, no other lane's)."""
        if self._stale:
            self._mstep_core()
            self._stale = False
            self.m_steps += 1
        return self._stats

    def flags(self) -> list:
        """The B flag words (``kernels.ops.FLAG_*``; 0 for a lane that was
        not active): the host-stepped step's one host read."""
        return self._flags.tolist()

    def boundary_state(self) -> BoundaryState:
        """The boundary kernel's tensors over the lanes (its lane form)."""
        return BoundaryState(self._stats, self.hood_e, self.lane, self.ctl, self.em_mu,
                             self.em_sigma, self.mu, self.sigma, self.ring, self.total_hist,
                             self.sigma_min, self.reseed_mu, self.reseed_sigma)

    # -- the compiled program on the card -------------------------------------

    def _capture(self) -> tuple:
        """The step and the M-step captured once (``em_tick.CapturedOps``,
        their ``segment_reduce`` launches counted on the device in
        ``ctl``'s last three words): the nodes every program of this
        workspace takes."""
        if self._captured is None:
            from repro_torch.kernels import em_tick

            every = self.max_map_iters == 0
            words = self.ctl[ref.SEG_ADD].data_ptr()
            with torch.cuda.device(self.device):
                self._captured = (
                    em_tick.CapturedOps(self._lane_step, self.device, words),
                    em_tick.CapturedOps(lambda: self._mstep_core(every), self.device, words))
        return self._captured

    def count_program(self, steps: int, msteps: int) -> None:
        """The host's step counts of a program or tick: ``steps`` flat steps
        and ``msteps`` M-steps, as its words counted them."""
        kops.count_lane_step(steps)
        self.m_steps += msteps


class DppBatchWorkspace(_DppLanes):
    """:func:`run_em` and :func:`run_em_batched`'s workspace in the modes
    ``static`` and ``faithful`` (``make_workspace``, ``batch=B`` for a
    stack; one problem is one lane), with the interface of the tick's
    ``BatchTickWorkspace``.

    The program (``make_workspace`` builds it with the config's EM limits):
    :meth:`start` with ``mu0`` and ``sigma0`` copies the solve in,
    :meth:`run_program` runs it (on the card one graph launch: per lockstep
    MAP iteration the captured flat step and the MAP loop's control kernel,
    per EM iteration the captured M-step and the boundary kernel's lane
    form), :meth:`program_result` reads its counters (one wait).

    Host-stepped (``testing.host_loop``): :meth:`start` without ``mu0``,
    :meth:`begin_em` starts an EM iteration of the given lanes, each
    :meth:`step` is one flat MAP iteration of the active lanes at the
    lockstep iteration ``i`` (``gate``: ``i > WINDOW``; ``cap``: ``i ==
    max_map_iters``)."""

    def __init__(self, shape: TickShape, batch: int, **kw):
        super().__init__(shape, batch, **kw)
        if self.max_em_iters is not None and self._kernel_route():
            from repro_torch.kernels import em_tick

            step, mstep = self._capture()
            self.program = em_tick.ModesProgram(
                self.device, self.boundary_state(), self.mu0, self.sigma0, step, mstep,
                max_em_iters=self.max_em_iters, max_map_iters=self.max_map_iters,
                conv_tol=CONV_TOL, n_vertices=self.shape.n_vertices)

    def start(self, hoods: Hoods, model: E.EnergyModel, labels0: Tensor, mu0=None,
              sigma0=None) -> None:
        """Copy a stack's problems (or one problem's, as lane 0) into the
        workspace.  With ``mu0`` and ``sigma0`` it is the program's solve;
        without, a host-stepped one (every lane inactive until
        :meth:`begin_em`)."""
        lead = (self.batch,)
        if TickShape.of(hoods, model) != self.shape or labels0.reshape(lead + (-1,)).shape[0] != self.batch:
            raise ValueError(f"a stack of {labels0.shape[0]} problems of "
                             f"{TickShape.of(hoods, model)}; the workspace was built for "
                             f"{self.batch} of {self.shape}")
        pairs = self._inputs(hoods, model) + [(self.labels, labels0)]
        if mu0 is not None:
            pairs += [(self.mu0, mu0), (self.sigma0, sigma0)]
        for dst, src in pairs:
            dst.copy_(src.reshape(dst.shape))
        self._stopped.zero_()
        self._stale = False
        if mu0 is None:
            self.active.zero_()

    def begin_em(self, mu: Tensor, sigma: Tensor, active, log_sigma=None) -> None:
        """The EM iteration's parameters ((B, K), ``sigma`` clamped) and the
        lanes that run it; their rings restart.  ``log_sigma`` as the
        attribute's."""
        self.mu.copy_(mu)
        self.sigma.copy_(sigma)
        self.log_sigma = log_sigma
        self.active.copy_(torch.as_tensor([bool(a) for a in active], device=self.device))
        self.ring.masked_fill_(self.active[:, None, None] != 0, 0.0)

    def step(self, gate: bool, cap: bool = False) -> None:
        self._step_core(gate, cap)
        self._stale = True
        kops.count_lane_step()

    # -- the program ----------------------------------------------------------

    def program_begin(self) -> None:
        """The plain program's start (``ref.program_begin``; the labels are
        in place already)."""
        ref.program_begin(ref.ProgramState(*(None,) * 9, self.mu0, self.sigma0, None,
                                           self.labels, None, self.boundary_state()),
                          max_em_iters=self.max_em_iters, max_map_iters=self.max_map_iters)

    def program_step(self) -> None:
        """The plain program's MAP iteration: the lanes' step and the MAP
        loop's control (``ref.map_ctl``)."""
        self._lane_step()
        ref.map_ctl(self.lane, self.ctl)
        kops.count_lane_step()

    def program_boundary(self) -> None:
        """The plain program's EM boundary: the M-step, then the boundary's
        lane form (``ref.em_boundary_lanes``)."""
        self._mstep_core(self.max_map_iters == 0)
        self.m_steps += 1
        ref.em_boundary_lanes(self.boundary_state(), max_em_iters=self.max_em_iters,
                              max_map_iters=self.max_map_iters, conv_tol=CONV_TOL,
                              stats_at_zero=True)

    def run_program(self, marks=None) -> None:
        """The solve bound by :meth:`start` (with ``mu0``): on the card one
        graph launch on the current stream, else the plain program
        (``ref.run_program``; ``marks`` its census hook)."""
        if self.max_em_iters is None:
            raise ValueError("this workspace was built without the EM limits: it has no program")
        if self.log_sigma is not None:
            raise ValueError("the program takes no log_sigma")
        if self.program is None:
            ref.run_program(self, marks)
        else:
            self.launch_program()

    def launch_program(self) -> None:
        self._stream = torch.cuda.current_stream(self.device).cuda_stream
        self.program.launch(self._stream)

    def program_result(self) -> tuple:
        """The solve's counters, one read: each lane's EM iterations, MAP
        iterations and status, and the lockstep MAP iterations.  On the
        card the host's launch counts take the graph's flat steps and
        M-steps as the device counted them (``program_launches``)."""
        if self.program is None:
            return ref.program_result(self.lane, self.ctl)
        em, maps, status, steps, flat, boundaries = self.program.result(self._stream)
        self.program_launches = {"step": flat, "em_boundary": boundaries}
        self.count_program(flat, boundaries)
        kops.count_boundaries(boundaries)
        return em, maps, status, steps

    def program_views(self) -> tuple:
        """(B, ...) views of the program's outputs: labels (a copy: the
        result's own), the EM-level mu and sigma, the hood energies and the
        total-energy ring."""
        return self.labels.clone(), self.em_mu, self.em_sigma, self.hood_e, self.total_hist


class DppPoolWorkspace(_DppLanes):
    """:func:`run_em_ticked`'s slot pool in the modes ``static`` and
    ``faithful`` (``make_workspace(..., batch=B, pool=True)``), with the
    interface of the tick's ``PoolTickWorkspace``: it owns each slot's
    problem and MAP counter (``map_i``); :meth:`admit` writes one slot's
    rows, :meth:`begin_lanes` starts an EM iteration of some slots,
    :meth:`retire` stops one, and each :meth:`step` is one flat MAP
    iteration of the active lanes, each at its own iteration (gate and cap
    from its counter).  On the card, built with the EM limits, it holds the
    compiled tick (``em_tick.TickProgram`` with the captured step and
    M-step): :meth:`launch_tick`, then :meth:`tick_result`."""

    def __init__(self, shape: TickShape, batch: int, **kw):
        super().__init__(shape, batch, **kw)
        self.owner = None
        if self.max_em_iters is not None and self._kernel_route():
            from repro_torch.kernels import em_tick

            step, mstep = self._capture()
            with torch.cuda.device(self.device):
                self.program = em_tick.TickProgram(
                    self, lambda pb, g: pb.child(g, step), lambda pb, g: pb.child(g, mstep),
                    max_em_iters=self.max_em_iters, conv_tol=CONV_TOL, stats_at_zero=True)

    @property
    def graph_tick(self) -> bool:
        """True when the tick runs as the compiled graph (the kernel route)."""
        return self._kernel_route()

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
        self.active[slot] = 0
        for dst, src in self._inputs(hoods, model) + [(self.labels, labels0)]:
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
        self.active[idx] = 1

    def retire(self, slot: int) -> None:
        self.active[self._check_slot(slot)] = 0

    def step(self) -> None:
        self._lane_step()
        self._stale = True
        kops.count_lane_step()

    def program_step(self) -> None:
        """The plain tick's step (counted from the tick's words)."""
        self._lane_step()

    def program_mstep(self) -> None:
        """The plain tick's M-step of the lanes that stopped, before their
        boundary (counted from the tick's words)."""
        self._mstep_core()

    def launch_tick(self, tick_iters: int, em_iters, map_iters, status) -> None:
        """One tick of the compiled program on the current stream: its
        in-words written, one graph launch."""
        self._stream = torch.cuda.current_stream(self.device).cuda_stream
        self.program.launch(self._stream, tick_iters, em_iters, map_iters, status)

    def tick_result(self) -> dict:
        """Wait for the tick (one wait): ``TickProgram.result``, the host's
        counts taking what the graph ran."""
        out = self.program.result(self._stream)
        self.count_program(out["steps"], out["stops"])
        kops.count_boundaries(out["boundaries"])
        return out


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
    """EM on one problem, on the device its tensors live on: the compiled
    EM program of ``workspace`` (``make_workspace``: the bucket's buffers
    and program, carried across its solves; without it the solve builds its
    own), in every mode: on the card one graph launch and one host read.
    (``testing.host_loop.run_em`` steps the same solve from the host.)"""
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
    stays inactive.  That is the stack's compiled program
    (:func:`_run_program`; on the card one graph launch and one host read):
    per lockstep MAP iteration one launch of the tick's lane entry in mode
    ``static-pallas``, one flat MAP iteration of every lane in the modes
    ``static`` and ``faithful``; per EM iteration (the modes' M-step, then)
    one launch of the boundary's lane form.  Each lane's result is its own
    :func:`run_em`'s bit for bit.
    ``workspace`` (``make_workspace(..., batch=B)``) carries the buffers
    across solves of one bucket and batch size.
    """
    validate_config(config)
    batch = int(labels0.shape[0])
    (labels, mu, sigma, hood_e, total), em_iters, map_iters, status, steps = _run_program(
        hoods, model, labels0, mu0, sigma0, config, workspace, batch)
    return BatchedEMResult(labels=labels, mu=mu, sigma=sigma, hood_energy=hood_e,
                           total_energy=total, em_iters=tuple(em_iters),
                           map_iters=tuple(map_iters), status=tuple(status), steps=steps)


# ---------------------------------------------------------------------------
# Ticked EM: the continuous-batching serving driver
# ---------------------------------------------------------------------------
#
# ``run_em_batched`` runs every lane until the slowest converges.  The
# ticked driver keeps a fixed pool of slots whose lanes sit at different
# EM and MAP iterations, and advances it by micro-steps: one step of the
# pool (a launch of the tick's pool entry in mode static-pallas, one flat
# MAP iteration of every lane in the modes static and faithful), in which
# each active lane runs its own next MAP iteration; where a lane's MAP loop
# stopped, the boundary kernel's lane form runs that lane's EM boundary at
# its own EM iteration and starts its next EM iteration, or leaves it done.
# A tick is the pool's compiled program (``_tick_program``): on the card one
# graph launch and one read of the words it wrote, from which the host's
# lists are taken.  Between calls the caller retires done lanes and admits
# new requests into the freed slots (``init_tick_lane``); the pool's
# buffers never change shape, so no workspace is built.


@dataclass(eq=False)
class TickState:
    """A slot pool's state (the reference's per-lane ``TickState`` for
    every slot).  The device half lives in ``workspace`` (a pool workspace,
    ``make_workspace(..., pool=True)``): each lane's labels, history ring,
    last hood energies, M-step sums, active word and MAP counter, and the
    EM level the tensors here are views of (the workspace's own buffers,
    which the compiled tick reads and writes): the EM-level parameters and
    total-energy rings ((B, K) and (B, WINDOW + 1)) and the model terms the
    EM boundary reads (``sigma_min``, ``reseed_mu``, ``reseed_sigma``, with
    a lane axis).  On the host: each lane's counters and health, taken
    from the one read of each tick.

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


def _state_on(workspace, lists: dict) -> TickState:
    """A :class:`TickState` whose tensors are ``workspace``'s EM-level
    buffers (the compiled tick reads and writes them at fixed addresses),
    with the host lists ``lists``; it takes the workspace over
    (``workspace.owner``, a weak reference, so that a pool dropped by its
    engine frees its pinned host words at once)."""
    ws = workspace
    state = TickState(workspace=ws, mu=ws.em_mu, sigma=ws.em_sigma, total_hist=ws.total_hist,
                      sigma_min=ws.sigma_min, reseed_mu=ws.reseed_mu, reseed_sigma=ws.reseed_sigma,
                      **lists)
    ws.owner = weakref.ref(state)
    return state


def blank_tick_state(workspace) -> TickState:
    """An all-empty slot pool on ``workspace``: every lane ``done`` and
    inactive, with benign parameters (sigma 1).  The workspace is taken
    over by the new state; a state that lost it may not step."""
    batch = workspace.batch
    for b in range(batch):
        workspace.retire(b)
    for name, value in (("em_mu", 0.0), ("em_sigma", 1.0), ("total_hist", 0.0),
                        ("sigma_min", 1.0), ("reseed_mu", 0.0), ("reseed_sigma", 1.0)):
        getattr(workspace, name).fill_(value)
    return _state_on(workspace, dict(em_i=[0] * batch, map_i=[0] * batch, map_total=[0] * batch,
                                     done=[True] * batch, status=[STATUS_OK] * batch))


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
    st = snap.state
    for name, t in (("em_mu", st.mu), ("em_sigma", st.sigma), ("total_hist", st.total_hist),
                    ("sigma_min", st.sigma_min), ("reseed_mu", st.reseed_mu),
                    ("reseed_sigma", st.reseed_sigma)):
        getattr(workspace, name).copy_(t)
    new = _state_on(workspace, dict(em_i=list(st.em_i), map_i=list(st.map_i),
                                    map_total=list(st.map_total), done=list(st.done),
                                    status=list(st.status)))
    new.micro_steps = st.micro_steps
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


def _take_tick(state: TickState, lanes) -> None:
    """The host lists from one read of the tick's words: per lane
    ``(em_iters, map_iters, status, map_i, active)``; a lane that was not
    done and is no longer active finished (its MAP counter 0, as the
    host-stepped tick leaves it)."""
    for b, (em_i, map_total, status, map_i, active) in enumerate(lanes):
        if state.done[b]:
            continue
        state.em_i[b], state.map_total[b], state.status[b] = em_i, map_total, status
        state.map_i[b] = map_i if active else 0
        state.done[b] = not active


def _tick_boundary(state: TickState, config: EMConfig) -> None:
    """The plain tick's IF body, under its condition as a mask: a DPP
    pool's M-step first (three ordered ``add``; a lane that did not stop
    keeps its sums), then the boundary's lane form over the pool
    (``kops.em_boundary_lanes``: ``params_from_stats``, the divergence and
    degeneracy tests, the total-energy rings, the status, each lane at its
    own EM iteration, and the next EM iteration's start of the lanes that
    go on), in place on the pool's words.  Only the lanes that stopped
    (their ``running`` words) move; the program's words keep the
    boundary's writes only where some lane stopped, as the card's IF node
    runs the body only then."""
    cen = _census.ACTIVE
    if cen is not None:
        cen.enter(_EM)
    ws = state.workspace
    ctl = ws.ctl.clone()
    if _family(ws) == "dpp":
        ws.program_mstep()
    kops.em_boundary_lanes(ws.boundary_state(), max_em_iters=config.max_em_iters,
                           max_map_iters=config.max_map_iters, conv_tol=CONV_TOL,
                           backend=config.backend)
    ws.ctl.copy_(torch.where(ws.tick[ref.T_STOP] != 0, ws.ctl, ctl))
    if cen is not None:
        cen.leave(_EM)


def _tick_micro(state: TickState, config: EMConfig) -> None:
    """One micro-step of the plain tick, the WHILE body under the loop's
    condition as a mask (no host read): one step of the pool (every active
    lane runs its next MAP iteration), the stop test (``ref.tick_stops``),
    the IF body (:func:`_tick_boundary`) and the tail.  Once the condition
    is down no lane is active, so the step and the boundary move no lane;
    what they would still write (the flag words, the program's and the
    tick's words) is put back."""
    cen = _census.ACTIVE
    if cen is not None:
        cen.enter(_MAP)
    ws = state.workspace
    go = ws.tick[ref.T_LOOP] != 0
    held = [t.clone() for t in (ws.lane[FLAG], ws.ctl, ws.tick)]
    ws.program_step()
    ref.tick_stops(ws.lane, ws.tick, ws.max_map_iters)
    _tick_boundary(state, config)
    ref.tick_tail(ws.lane, ws.tick)
    for t, h in zip((ws.lane[FLAG], ws.ctl, ws.tick), held):
        t.copy_(torch.where(go, t, h))
    if cen is not None:
        cen.leave(_MAP)


def _tick_program(state: TickState, config: EMConfig, tick_iters: int) -> int:
    """One tick of the pool's compiled program: on the card one graph
    launch and one wait (``ws.launch_tick`` then ``ws.tick_result``); on
    the plain route the same program as plain operations with no read
    inside (``ref.tick_init``, ``tick_iters`` micro-steps with the loop's
    condition as a mask, :func:`_tick_micro`) and one read of the words
    (``ref.tick_publish``).  The host lists are taken from that one read;
    returns the micro-steps the loop's condition let run."""
    ws = state.workspace
    cen = _census.ACTIVE
    if cen is not None:
        cen.enter(_SOLVE)
    if ws.graph_tick:
        ws.launch_tick(tick_iters, state.em_i, state.map_total, state.status)
        state.micro_steps += 1  # launched: a failure from here on is not replayed
        out = ws.tick_result()
    else:
        words = torch.tensor([tick_iters, *state.em_i, *state.map_total, *state.status],
                             dtype=torch.int32)
        ref.tick_init(ws.lane, ws.ctl, ws.tick, words)
        state.micro_steps += 1  # stepping: a failure from here on is not replayed
        for _ in range(tick_iters):
            _tick_micro(state, config)
        out = ref.tick_publish(ws.lane, ws.ctl, ws.tick)
        if _family(ws) == "dpp":
            ws.count_program(out["steps"], out["stops"])
    state.micro_steps += out["steps"] - 1
    _take_tick(state, out["lanes"])
    if cen is not None:
        cen.leave(_SOLVE)
    return out["steps"]


def run_em_ticked(
    state: TickState, config: EMConfig = EMConfig(), tick_iters: int = 8
) -> Tuple[TickState, int]:
    """Advance a slot pool by up to ``tick_iters`` micro-steps (one tick);
    returns ``(state, steps_executed)``.

    The tick is the pool's compiled program (:func:`_tick_program`: on
    the card one graph launch and one host read, whatever ``tick_iters``;
    one graph per pool serves every tick size).  It exits early once every
    lane is done: the remaining micro-steps would change nothing, and the
    caller gets control back at the convergence boundary, so
    ``steps_executed`` (at most ``tick_iters``) counts the micro-steps
    actually run.  Between calls
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
    if (ws.mode, ws.precision, ws.max_em_iters, ws.max_map_iters) != (
            config.mode, config.precision, config.max_em_iters, config.max_map_iters):
        raise ValueError(
            f"pool built for mode {ws.mode!r}, precision {ws.precision!r}, max_em_iters "
            f"{ws.max_em_iters} and max_map_iters {ws.max_map_iters}, the config has "
            f"{config.mode!r}, {config.precision!r}, {config.max_em_iters} and "
            f"{config.max_map_iters}")
    if all(state.done):
        return state, 0
    return state, _tick_program(state, config, tick_iters)
