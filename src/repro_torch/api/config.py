"""Execution policy for the session API.

Counterpart of ``repro.api.config.ExecutionConfig`` for what this package
runs: mode ``static-pallas``, its precision, the label count, the EM
limits, the init, the oversegmentation, the shard count and the session's
bucketing and executable cache.  ``backend``
is ``"auto"`` (the CUDA kernels for tensors on the card, the plain
PyTorch versions on the CPU) or ``"torch"`` (the plain versions on any
device).

``shards > 1`` runs the sharded route over the default
``torch.distributed`` process group, one rank per shard (``torchrun
--nproc-per-node shards``); that group takes the place of the
reference's ``mesh_axis``, so there is no such field here.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import torch

from repro_torch.core.pmrf import em as em_mod
from repro_torch.kernels import ops as kops

#: Default bucket grids: element capacity to a multiple of 256, hood and
#: region counts to a multiple of 64 (the reference's defaults).
DEFAULT_CAPACITY_BUCKET = 256
DEFAULT_SEGMENT_BUCKET = 64


@dataclass(frozen=True)
class ExecutionConfig:
    backend: str = "auto"          # auto | torch
    mode: str = "static-pallas"    # the one mode ported so far
    precision: str = "f32"         # f32 | bf16 energy arithmetic
    n_labels: int = 2
    max_em_iters: int = 20
    max_map_iters: int = 10
    beta: float = 0.75
    sigma_min: float = 2.0
    init: str = "random"           # random | quantile
    overseg_grid: Tuple[int, int] = (16, 16)
    overseg_iters: int = 5
    shards: int = 1                # ranks of the default process group
    capacity_bucket: int = DEFAULT_CAPACITY_BUCKET
    segment_bucket: int = DEFAULT_SEGMENT_BUCKET
    max_cached_executables: int = 32

    def __post_init__(self):
        if self.backend not in kops.BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; have {kops.BACKENDS}")
        if self.mode not in em_mod.MODES:
            raise ValueError(f"unknown mode {self.mode!r}; have {em_mod.MODES}")
        if self.mode in em_mod.UNPORTED_MODES:
            raise NotImplementedError(
                f"mode {self.mode!r} is not ported to repro_torch yet; it is "
                f"queued in {em_mod.UNPORTED_MODES[self.mode]}"
            )
        if self.precision not in em_mod.PRECISIONS:
            raise ValueError(
                f"unknown precision {self.precision!r}; have {em_mod.PRECISIONS}"
            )
        if self.init not in ("random", "quantile"):
            raise ValueError(f"init must be 'random' or 'quantile', got {self.init!r}")
        if self.n_labels < 2:
            raise ValueError(f"n_labels must be >= 2, got {self.n_labels}")
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.capacity_bucket < 1 or self.segment_bucket < 1:
            raise ValueError("bucket granularities must be >= 1")
        if self.max_cached_executables < 1:
            raise ValueError("max_cached_executables must be >= 1")
        object.__setattr__(self, "overseg_grid", tuple(self.overseg_grid))

    def resolved_backend(self, device) -> str:
        """The route on ``device``: "cuda" (the kernels) or "torch" (the
        plain versions)."""
        if self.backend == "torch" or torch.device(device).type != "cuda":
            return "torch"
        return "cuda"

    def em_config(self) -> em_mod.EMConfig:
        return em_mod.EMConfig(
            max_em_iters=self.max_em_iters,
            max_map_iters=self.max_map_iters,
            mode=self.mode,
            beta=self.beta,
            sigma_min=self.sigma_min,
            backend=self.backend,
            precision=self.precision,
        )

    def with_(self, **changes) -> "ExecutionConfig":
        """Functional update (dataclasses.replace with validation)."""
        return replace(self, **changes)
