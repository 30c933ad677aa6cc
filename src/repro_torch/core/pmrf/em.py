"""EM / MAP optimization driver (paper Alg. 2, lines 6-12).

Counterpart of ``repro.core.pmrf.em`` for the single-device
``static-pallas`` route.  An outer EM loop (parameter estimation) wraps an
inner MAP loop (label inference); each MAP iteration is one
``fused_em_tick`` call, which also returns the M-step sums and the
per-hood convergence predicate.  Convergence follows §3.2.2: per-hood
energy sums over the last L=3 iterations, converged when every change is
below 1e-4 (relative).

The JAX driver's ``while_loop``s are Python loops here.  The loop
conditions need the MAP ``done`` flag on the host, so each MAP iteration
reads one flag from the device, and each EM boundary reads three.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

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
    precision: str = "f32"        # fused-tick energy arithmetic: "f32" | "bf16"


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


def run_em(
    hoods: Hoods,
    model: E.EnergyModel,
    labels0: Tensor,
    mu0: Tensor,
    sigma0: Tensor,
    config: EMConfig = EMConfig(),
) -> EMResult:
    """EM on one problem, on the device its tensors live on."""
    validate_config(config)
    backend = config.backend
    n_hoods = hoods.n_hoods
    dev = labels0.device
    f32 = torch.float32
    sctx = E.make_static_context(hoods, model, backend=backend)

    labels, mu, sigma = labels0, mu0, sigma0
    hood_energy = torch.zeros((n_hoods,), dtype=f32, device=dev)  # if max_em_iters == 0
    total_hist = torch.zeros((WINDOW + 1,), dtype=f32, device=dev)
    em_i = 0
    map_total = 0
    status = STATUS_OK
    done = False
    while em_i < config.max_em_iters and not done:
        # MAP loop: one fused tick per iteration.
        hist = torch.zeros((WINDOW + 1, n_hoods), dtype=f32, device=dev)
        hood_energy = torch.zeros((n_hoods,), dtype=f32, device=dev)
        msums = torch.zeros((3, mu.shape[0]), dtype=f32, device=dev)
        diverged = torch.zeros((), dtype=torch.bool, device=dev)
        i = 0
        map_done = False
        while i < config.max_map_iters and not map_done:
            labels, hood_e, conv, sum_w, sum_wy, sum_wyy = E.em_tick_fused(
                hoods, model, sctx, labels, mu, sigma, hist,
                backend=backend, precision=config.precision, conv_tol=CONV_TOL,
            )
            msums = torch.stack([sum_w, sum_wy, sum_wyy])
            hist = torch.cat([hood_e[None], hist[:-1]])
            hood_energy = hood_e
            i += 1
            diverged = ~torch.all(torch.isfinite(hood_e))
            # The kernel reduced the window predicate; the gate on the
            # iteration count stays here.
            stop = (conv | diverged) if i > WINDOW else diverged
            map_done = bool(stop)

        mu, sigma, sum_w = E.params_from_stats(model, msums[0], msums[1], msums[2])
        div_t = diverged | ~torch.all(torch.isfinite(mu)) | ~torch.all(torch.isfinite(sigma))
        deg_t = _degenerate_components(model, sigma, sum_w)
        total_hist = torch.cat([torch.sum(hood_energy)[None], total_hist[:-1]])
        em_i += 1
        conv_t = _window_converged(total_hist) if em_i > WINDOW else torch.zeros_like(div_t)
        div, deg, em_conv = (bool(v) for v in torch.stack([div_t, deg_t, conv_t]).tolist())
        map_total += i
        finished = div or not (em_i < config.max_em_iters and not em_conv)
        done = em_conv or div
        status = _boundary_status(div, deg, finished, em_conv, em_i, config.max_em_iters)

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
