"""Execution policy for the session API.

Counterpart of ``repro.api.config.ExecutionConfig`` for what this package
runs: the mode (``static-pallas``, the fused route; ``static`` and
``faithful``, the paper's primitive sequence), the precision, the label
count, the EM limits, the init, the oversegmentation, the shard count, the
session's bucketing and executable cache, and the
:class:`FallbackPolicy` for compile and execute failures.  ``backend`` is
``"auto"`` (the CUDA kernels for tensors on the card, the plain PyTorch
versions on the CPU) or ``"torch"`` (the plain versions on any device).

``shards > 1`` runs the sharded route over the default
``torch.distributed`` process group, one rank per shard (``torchrun
--nproc-per-node shards``); that group takes the place of the
reference's ``mesh_axis``, so there is no such field here.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Callable, Optional, Tuple, TypeVar

import torch

from repro_torch.core.pmrf import em as em_mod

T = TypeVar("T")

#: Default bucket grids: element capacity to a multiple of 256, hood and
#: region counts to a multiple of 64 (the reference's defaults).
DEFAULT_CAPACITY_BUCKET = 256
DEFAULT_SEGMENT_BUCKET = 64


@dataclass(frozen=True)
class FallbackPolicy:
    """What a session (and its serving engine) does when a compile or an
    execute raises.

    First the same route is tried again, up to ``max_retries`` times, with
    a backoff that starts at ``backoff_s`` and doubles up to
    ``max_backoff_s`` (transient failures: allocator pressure, an injected
    fault).  A CUDA error is never tried again: one that poisons the
    context would fail every retry.  Then:

    * ``backend=None`` (the default): no other route is taken.  The error
      is raised wrapped in :class:`~repro_torch.api.errors.FallbackError`,
      so that a failure of the kernels is never hidden behind the plain
      path.
    * ``backend="torch"``: the session builds the executable again on the
      plain PyTorch route (``ExecutionConfig(backend="torch")`` on the same
      device), with a ``fallback_events`` entry, a ``RuntimeWarning`` and
      a redirect, so that warm traffic of the failed key goes straight to
      the fallback executable.  ``FallbackError`` if that fails too.
    * ``enabled=False``: the original error is raised after the retries.

    The reference falls back to its plain lowering by default; on the card
    that would hide the kernel, so here the plain route is taken only on
    request.
    """

    enabled: bool = True
    backend: Optional[str] = None  # None | "torch"
    max_retries: int = 1           # same-route retries before giving up or falling back
    backoff_s: float = 0.05        # first backoff, doubled per retry
    max_backoff_s: float = 1.0

    def __post_init__(self):
        if self.backend not in (None, "torch"):
            raise ValueError(
                f"unknown fallback backend {self.backend!r}; have None (no fallback) or 'torch'"
            )
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff seconds must be >= 0")

    def retrying(self, attempt: Callable[[], T], *, max_retries: Optional[int] = None,
                 replayable: Optional[Callable[[], bool]] = None) -> T:
        """``attempt()``, called again on the same route after an exception,
        up to ``max_retries`` (default: the policy's) more times, with the
        capped doubling backoff.  The last exception is raised.  A CUDA
        error is raised at once (:func:`is_cuda_error`), and so is any
        error after which ``replayable()`` says the attempt may not run
        again (it changed state in place)."""
        retries = self.max_retries if max_retries is None else max_retries
        delay = self.backoff_s
        tries = 0
        while True:
            try:
                return attempt()
            except Exception as e:  # classified here, re-raised unless retried
                if tries >= retries or is_cuda_error(e) or (replayable is not None and not replayable()):
                    raise
                tries += 1
                time.sleep(min(delay, self.max_backoff_s))
                delay *= 2


def is_cuda_error(e: BaseException) -> bool:
    """True for a CUDA error: a kernel wrapper's ``CUDA error`` (a refused
    or failed launch) or PyTorch's accelerator error (a fault on the card,
    raised at the next synchronisation).  No retry cures one, and a sticky
    one poisons the context; an out-of-memory error is not one."""
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    return isinstance(e, RuntimeError) and "CUDA error" in str(e)


@dataclass(frozen=True)
class ExecutionConfig:
    backend: str = "auto"          # auto | torch
    mode: str = "static-pallas"    # static-pallas | static | faithful
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
    fallback: FallbackPolicy = field(default_factory=FallbackPolicy)

    def __post_init__(self):
        em_mod.validate_config(self.em_config())  # backend, mode, precision
        if not isinstance(self.fallback, FallbackPolicy):
            raise TypeError(f"fallback must be a FallbackPolicy, got {type(self.fallback).__name__}")
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

    def em_config(self, backend: Optional[str] = None) -> em_mod.EMConfig:
        """The EM driver's config; ``backend`` overrides the session's (a
        fallback executable's)."""
        return em_mod.EMConfig(
            max_em_iters=self.max_em_iters,
            max_map_iters=self.max_map_iters,
            mode=self.mode,
            beta=self.beta,
            sigma_min=self.sigma_min,
            backend=self.backend if backend is None else backend,
            precision=self.precision,
        )

    def with_(self, **changes) -> "ExecutionConfig":
        """Functional update (dataclasses.replace with validation)."""
        return replace(self, **changes)
