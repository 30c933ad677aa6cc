"""DPP-PMRF: the paper's probabilistic-graphical-model optimizer."""

from repro_torch.core.pmrf.cliques import CliqueSet, enumerate_maximal_cliques
from repro_torch.core.pmrf.collectives import LOCAL, ReduceCtx
from repro_torch.core.pmrf.convert import problem_from_numpy
from repro_torch.core.pmrf.em import EMConfig, EMResult, run_em
from repro_torch.core.pmrf.energy import EnergyModel, make_energy_model
from repro_torch.core.pmrf.graph import RegionGraph, build_region_graph
from repro_torch.core.pmrf.hoods import Hoods, build_hoods, pad_hoods
from repro_torch.core.pmrf.pipeline import (
    Problem,
    SegmentationResult,
    initialize,
    optimize,
)

__all__ = [
    "CliqueSet",
    "enumerate_maximal_cliques",
    "LOCAL",
    "ReduceCtx",
    "problem_from_numpy",
    "EMConfig",
    "EMResult",
    "run_em",
    "EnergyModel",
    "make_energy_model",
    "RegionGraph",
    "build_region_graph",
    "Hoods",
    "build_hoods",
    "pad_hoods",
    "Problem",
    "SegmentationResult",
    "initialize",
    "optimize",
]
