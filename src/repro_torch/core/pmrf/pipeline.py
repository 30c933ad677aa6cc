"""DPP-PMRF pipeline phases: ``initialize`` (plan) and ``optimize`` (solve).

Counterpart of ``repro.core.pmrf.pipeline``; the session API
(``repro_torch.api``) builds on these.  ``segment_image`` and
``segment_volume`` are the reference's deprecated one-shot entry points,
shims over a shared session (``api.session_for``).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device, to_tensor
from repro_torch.core import oversegment
from repro_torch.core.pmrf import em as em_mod
from repro_torch.core.pmrf.cliques import CliqueSet, enumerate_maximal_cliques
from repro_torch.core.pmrf.energy import EnergyModel, make_energy_model
from repro_torch.core.pmrf.graph import RegionGraph, build_region_graph
from repro_torch.core.pmrf.hoods import Hoods, build_hoods


@dataclass
class Problem:
    """A fully initialized PMRF problem (init phase output)."""

    graph: RegionGraph
    cliques: CliqueSet
    hoods: Hoods
    model: EnergyModel
    labels_px: np.ndarray  # (H, W) oversegmentation label map (host)


@dataclass
class SegmentationResult:
    segmentation: np.ndarray      # (H, W) int32 {0..K-1}
    region_labels: np.ndarray     # (V,) int32
    mu: np.ndarray
    sigma: np.ndarray
    em_iters: int
    map_iters: int
    total_energy: float
    init_seconds: float
    optimize_seconds: float
    # "converged" | "max_iters" | "diverged" | "degenerate" | "running"
    status: str = "converged"

    @property
    def ok(self) -> bool:
        """True when the result is a legitimate segmentation."""
        return self.status in ("converged", "max_iters")


def initialize(
    image,
    *,
    overseg_grid: Tuple[int, int] = (16, 16),
    overseg_iters: int = 5,
    beta: float = 0.75,
    sigma_min: float = 2.0,
    n_labels: int = 2,
    oversegmentation=None,
    device: DeviceLike = None,
) -> Problem:
    """Initialization phase (paper Alg. 2 lines 1-5): oversegmentation,
    region graph, maximal cliques, neighborhoods and the energy model.
    ``oversegmentation`` (an (H, W) label map) skips SLIC."""
    dev = resolve_device(device)
    img = to_tensor(image, torch.float32, dev)
    if oversegmentation is None:
        labels_px = oversegment.slic(img, grid=overseg_grid, iters=overseg_iters, device=dev)
        n_regions = overseg_grid[0] * overseg_grid[1]
    else:
        labels_px = to_tensor(oversegmentation, torch.int32, dev)
        n_regions = int(labels_px.max()) + 1
    graph = build_region_graph(img, labels_px, n_regions)
    cliques = enumerate_maximal_cliques(graph)
    hoods = build_hoods(graph, cliques)
    model = make_energy_model(
        graph.region_mean, graph.region_size, beta=beta, sigma_min=sigma_min,
        n_labels=n_labels,
    )
    return Problem(
        graph=graph,
        cliques=cliques,
        hoods=hoods,
        model=model,
        labels_px=labels_px.cpu().numpy(),
    )


def initial_params(problem: Problem, seed: int, init: str):
    """``(labels0, mu0, sigma0)``: random from ``seed`` or by quantiles."""
    n_labels = problem.model.n_labels
    n_regions = problem.graph.n_regions
    if init == "random":
        gen = torch.Generator(device=problem.model.region_mean.device).manual_seed(seed)
        return em_mod.init_params(gen, n_regions, n_labels)
    if init == "quantile":
        return em_mod.quantile_init(problem.graph.region_mean, n_regions, n_labels)
    raise ValueError(f"init must be 'random' or 'quantile', got {init!r}")


def optimize(
    problem: Problem,
    *,
    seed: int = 0,
    config: em_mod.EMConfig = em_mod.EMConfig(),
    init: str = "random",
    workspace=None,
) -> em_mod.EMResult:
    """Optimization phase (the paper's timed region); ``workspace`` as in
    ``em.run_em``."""
    labels0, mu0, sigma0 = initial_params(problem, seed, init)
    return em_mod.run_em(
        problem.hoods, problem.model, labels0, mu0, sigma0, config, workspace=workspace
    )


def assemble_result(
    problem: Problem,
    result: em_mod.EMResult,
    init_seconds: float,
    optimize_seconds: float,
) -> SegmentationResult:
    region_labels = result.labels.cpu().numpy()[: problem.graph.n_regions]
    return SegmentationResult(
        segmentation=region_labels[problem.labels_px].astype(np.int32),
        region_labels=region_labels,
        mu=result.mu.cpu().numpy(),
        sigma=result.sigma.cpu().numpy(),
        em_iters=result.em_iters,
        map_iters=result.map_iters,
        total_energy=float(result.total_energy),
        init_seconds=init_seconds,
        optimize_seconds=optimize_seconds,
        status=em_mod.STATUS_NAMES.get(result.status, "running"),
    )


def _can_batch(problems: List[Problem]) -> bool:
    """Batch when padding stays bounded: every slice's capacity within 2x of
    the smallest (one bucket)."""
    caps = [p.hoods.capacity for p in problems]
    return len(problems) > 1 and max(caps) <= 2 * min(caps)


def _legacy_session(overseg_grid, beta, mode, backend, init, max_em_iters, max_map_iters,
                    device):
    """The legacy keyword arguments as a shared session's config."""
    from repro_torch import api  # deferred: api builds on this module

    return api.session_for(
        api.ExecutionConfig(
            backend=backend,
            mode=mode,
            max_em_iters=max_em_iters,
            max_map_iters=max_map_iters,
            beta=beta,
            init=init,
            overseg_grid=tuple(overseg_grid),
        ),
        device=device,
    )


def _warn_deprecated(name: str) -> None:
    warnings.warn(
        f"{name} is deprecated; use repro_torch.api.Segmenter (plan/compile/execute "
        "+ submit/drain). This shim routes through a shared session and will be "
        "removed in a future release.",
        DeprecationWarning,
        stacklevel=3,
    )


def segment_image(
    image,
    *,
    seed: int = 0,
    overseg_grid: Tuple[int, int] = (16, 16),
    beta: float = 0.75,
    mode: str = "static-pallas",
    backend: str = "auto",
    init: str = "random",
    max_em_iters: int = 20,
    max_map_iters: int = 10,
    oversegmentation=None,
    device: DeviceLike = None,
) -> SegmentationResult:
    """Deprecated one-shot entry point; see ``repro_torch.api.Segmenter``.
    ``mode`` defaults to the one mode ported (the reference's to
    ``"static"``)."""
    _warn_deprecated("segment_image")
    sess = _legacy_session(overseg_grid, beta, mode, backend, init, max_em_iters,
                           max_map_iters, device)
    return sess.execute(sess.plan(image, oversegmentation=oversegmentation), seed=seed)


def segment_volume(
    images,
    *,
    seed: int = 0,
    overseg_grid: Tuple[int, int] = (16, 16),
    beta: float = 0.75,
    mode: str = "static-pallas",
    backend: str = "auto",
    init: str = "random",
    max_em_iters: int = 20,
    max_map_iters: int = 10,
    batch: str = "auto",
    device: DeviceLike = None,
) -> Tuple[List[SegmentationResult], float]:
    """Deprecated one-shot stack entry point; see
    ``Segmenter.segment_stack``.  Returns ``(results, mean optimize
    seconds)``, the per-slice average the paper reports."""
    _warn_deprecated("segment_volume")
    sess = _legacy_session(overseg_grid, beta, mode, backend, init, max_em_iters,
                           max_map_iters, device)
    return sess.segment_stack(images, seed=seed, batch=batch)
