"""EM / MAP optimization driver (paper Alg. 2, lines 6-12).

Counterpart of ``repro.core.pmrf.em`` for the ``static-pallas`` route.  An
outer EM loop (parameter estimation) wraps an inner MAP loop (label
inference).  Convergence follows §3.2.2: per-hood energy sums over the
last L=3 iterations, converged when every change is below 1e-4
(relative).

There is one driver (:func:`_em_driver`), parametrised by a collective
context (``collectives.ReduceCtx``): :func:`run_em` binds the
single-device context, where each MAP iteration is one ``fused_em_tick``
launch on a workspace the plan owns (label gather, history ring,
convergence and finiteness flags and the M-step sums all in the kernel);
``distributed.run_em_sharded`` binds a sharded context, where each MAP
iteration is one ``fused_map_step`` launch on the rank's workspace (the
last step's labels and tests, this step's counts, energies, hood sums and
votes), one all-reduce of the step's hood sums and votes and, past the
window, the AND of the flag word; its M-step is
``energy.update_parameters_stats``.  Every convergence decision goes
through the context, so all ranks take the same trajectory.

The JAX driver's ``while_loop``s are Python loops here.  The loop
conditions need the MAP ``done`` flag on the host, so each MAP iteration
reads one flag word from the device, and each EM boundary reads three.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.pmrf import collectives
from repro_torch.core.pmrf import energy as E
from repro_torch.core.pmrf.hoods import Hoods
from repro_torch.kernels import ops as kops

Tensor = torch.Tensor

CONV_TOL = 1.0e-4
WINDOW = 3  # the paper's L

MODES = ("faithful", "static", "static-pallas")
PRECISIONS = ("f32", "bf16")
#: Modes of the reference that this package does not run yet, and where
#: ROADMAP.md queues them.
UNPORTED_MODES = {
    "static": "ROADMAP.md Queue 1 item 4 (serial EM, modes static and faithful)",
    "faithful": "ROADMAP.md Queue 1 item 4 (serial EM, modes static and faithful)",
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

#: Data-term sentinel of inert (padded) labels in the reference's mixed-K
#: pools; a label at INERT_MU is never a "real" label for DEGENERATE.
INERT_MU = 1.0e8


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


def _window_converged(hist: Tensor) -> Tensor:
    """True where the last WINDOW deltas of the ring are all below tolerance."""
    deltas = torch.abs(hist[:-1] - hist[1:])
    scale = torch.clamp_min(torch.abs(hist[0]), 1.0)
    return torch.all(deltas < CONV_TOL * scale, dim=0)


def _degenerate_components(model: E.EnergyModel, sigma: Tensor, sum_w: Tensor) -> Tensor:
    """A real label with (near-)zero mass whose sigma sits at sigma_min can
    never recapture mass (the collapsed-Gaussian hazard)."""
    dead = sum_w < 1e-3 * torch.sum(sum_w)
    real = model.reseed_mu < INERT_MU
    return torch.any(dead & real & (sigma <= model.sigma_min))


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


def make_workspace(hoods: Hoods, model: E.EnergyModel, config: EMConfig):
    """The single-device route's MAP-iteration workspace for ``config``
    (``kernels.ops.tick_workspace``); a plan keeps one and its solves
    reuse it (``run_em(..., workspace=)``)."""
    return kops.tick_workspace(
        hoods, model, precision=config.precision, conv_tol=CONV_TOL, window=WINDOW,
        backend=config.backend,
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
        ws = workspace if workspace is not None else make_workspace(hoods, model, config)
        if (ws.precision, ws.n_labels) != (config.precision, model.n_labels):
            raise ValueError(
                f"workspace built for precision {ws.precision!r} and K = {ws.n_labels}, "
                f"the solve has {config.precision!r} and K = {model.n_labels}"
            )
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
            # MAP loop: one launch and one flag read per iteration.
            while i < config.max_map_iters and not flag:
                i += 1
                ws.step(i > WINDOW)
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
            mu, sigma, sum_w = E.update_parameters_stats(
                model, ws.labels, config.mode, backend=backend
            )
        map_div = bool(flag & kops.FLAG_DIVERGED)
        div_t = ~torch.all(torch.isfinite(mu)) | ~torch.all(torch.isfinite(sigma))
        deg_t = _degenerate_components(model, sigma, sum_w)
        total_hist = torch.cat([torch.sum(hood_energy)[None], total_hist[:-1]])
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
        total_energy=torch.sum(hood_energy),
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
    one plan; without it the solve builds its own."""
    return _em_driver(hoods, model, labels0, mu0, sigma0, config, collectives.LOCAL, workspace)
