"""Plan -> execute session API.

Counterpart of ``repro.api.session.Segmenter`` without its executable
cache, micro-batching (``submit``/``drain``), ``segment_stack`` and
fallback policy, which ROADMAP.md queues for the next slice.  PyTorch runs
eagerly, so there is no compile phase to cache yet.

* :meth:`Segmenter.plan`: oversegmentation, region graph, cliques and
  neighborhoods (the paper's untimed init phase);
* :meth:`Segmenter.execute`: the EM solve (the paper's timed phase);
* :meth:`Segmenter.segment`: both.

Both phases are timed on the host clock around work that ends in
``torch.cuda.synchronize`` when they run on the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch import DeviceLike, resolve_device, to_tensor
from repro_torch.api.config import ExecutionConfig
from repro_torch.api.errors import PlanError
from repro_torch.core.pmrf import pipeline as pipeline_mod


@dataclass
class Plan:
    """A planned (initialized) segmentation problem."""

    problem: pipeline_mod.Problem
    init_seconds: float


class Segmenter:
    """A segmentation session: one execution policy on one device
    (``device=None``: the CUDA device, or :class:`RuntimeError`)."""

    def __init__(self, config: ExecutionConfig = ExecutionConfig(), *, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def plan(self, image, *, oversegmentation=None) -> Plan:
        """Initialization phase; rejects empty or non-finite images with
        :class:`PlanError` before any work."""
        img = image if isinstance(image, torch.Tensor) else to_tensor(image)
        if img.numel() == 0:
            raise PlanError(f"cannot plan a zero-element image (shape {tuple(img.shape)})")
        if img.is_floating_point():
            bad = int((~torch.isfinite(img)).sum())
            if bad:
                raise PlanError(
                    f"image contains {bad} non-finite pixel(s); segmentation "
                    "energies are undefined for NaN/Inf intensities"
                )
        self._sync()
        t0 = time.perf_counter()
        c = self.config
        problem = pipeline_mod.initialize(
            img,
            overseg_grid=c.overseg_grid,
            overseg_iters=c.overseg_iters,
            beta=c.beta,
            sigma_min=c.sigma_min,
            n_labels=c.n_labels,
            oversegmentation=oversegmentation,
            device=self.device,
        )
        self._sync()
        return Plan(problem=problem, init_seconds=time.perf_counter() - t0)

    def execute(self, plan: Plan, *, seed: int = 0) -> pipeline_mod.SegmentationResult:
        """The EM solve of one plan (``seed`` drives the random init)."""
        self._sync()
        t0 = time.perf_counter()
        res = pipeline_mod.optimize(
            plan.problem, seed=seed, config=self.config.em_config(), init=self.config.init
        )
        self._sync()
        opt_s = time.perf_counter() - t0
        return pipeline_mod.assemble_result(plan.problem, res, plan.init_seconds, opt_s)

    def segment(self, image, *, seed: int = 0, oversegmentation=None):
        """Plan + execute in one call."""
        return self.execute(self.plan(image, oversegmentation=oversegmentation), seed=seed)
