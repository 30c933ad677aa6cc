"""Execution policy for the session API.

Counterpart of ``repro.api.config.ExecutionConfig`` for what this package
runs: mode ``static-pallas``, its precision, the label count, the EM
limits, the init and the oversegmentation.  ``backend`` is ``"auto"``
(the CUDA kernels for tensors on the card, the plain PyTorch versions on
the CPU) or ``"torch"`` (the plain versions on any device).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

from repro_torch.core.pmrf import em as em_mod
from repro_torch.kernels import ops as kops


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
        object.__setattr__(self, "overseg_grid", tuple(self.overseg_grid))

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
