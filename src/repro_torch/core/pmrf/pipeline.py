"""DPP-PMRF pipeline phases: ``initialize`` (plan) and ``optimize`` (solve).

Counterpart of ``repro.core.pmrf.pipeline``; the session API
(``repro_torch.api``) builds on these.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

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
