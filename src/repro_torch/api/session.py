"""Plan -> execute session API.

Counterpart of ``repro.api.session.Segmenter`` without its executable
cache, micro-batching (``submit``/``drain``), ``segment_stack`` and
fallback policy, which ROADMAP.md queues for the next slice.  PyTorch runs
eagerly, so there is no compile phase to cache yet.

* :meth:`Segmenter.plan`: oversegmentation, region graph, cliques and
  neighborhoods (the paper's untimed init phase);
* :meth:`Segmenter.execute`: the EM solve (the paper's timed phase), on
  the sharded route when ``config.shards > 1``: every rank of the default
  ``torch.distributed`` group calls it with the same plan and solves its
  block of the hood elements.  On one device the plan keeps the MAP
  loop's workspace, so a warm solve allocates nothing in that loop;
* :meth:`Segmenter.segment`: both.

Both phases are timed on the host clock around work that ends in
``torch.cuda.synchronize`` when they run on the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch import DeviceLike, resolve_device, to_tensor
from repro_torch.api.config import ExecutionConfig
from repro_torch.api.errors import PlanError
from repro_torch.core.pmrf import distributed as distributed_mod
from repro_torch.core.pmrf import em as em_mod
from repro_torch.core.pmrf import pipeline as pipeline_mod
from repro_torch.core.pmrf.hoods import Hoods


@dataclass
class Plan:
    """A planned (initialized) segmentation problem."""

    problem: pipeline_mod.Problem
    init_seconds: float
    # partition_hoods results by shard count, made at the first sharded solve
    partitions: Dict[int, Hoods] = field(default_factory=dict, repr=False)
    # MAP-iteration workspaces (em.make_workspace) by (precision, backend),
    # made at the first single-device solve and reused by the later ones
    workspaces: Dict[Tuple[str, str], object] = field(default_factory=dict, repr=False)


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

    def _check_group(self) -> None:
        """The sharded route's process group: the default group, with one
        rank per shard; raises with what to do otherwise."""
        n = self.config.shards
        if not dist.is_initialized():
            found = "torch.distributed is not initialised"
        elif dist.get_world_size() != n:
            found = f"the default process group has {dist.get_world_size()} ranks"
        else:
            return
        raise RuntimeError(
            f"ExecutionConfig(shards={n}) runs one process per shard over the "
            f"default torch.distributed process group, but {found}; launch "
            f"with `torchrun --nproc-per-node {n}` and call "
            "torch.distributed.init_process_group first (`python -m "
            f"repro_torch.launch.segment --shards {n}` under torchrun does both)"
        )

    def execute(self, plan: Plan, *, seed: int = 0) -> pipeline_mod.SegmentationResult:
        """The EM solve of one plan (``seed`` drives the random init)."""
        shards = self.config.shards
        em_config = self.config.em_config()
        if shards > 1:
            self._check_group()
            if shards not in plan.partitions:
                plan.partitions[shards] = distributed_mod.partition_hoods(plan.problem.hoods, shards)
        else:
            key = (em_config.precision, em_config.backend)
            if key not in plan.workspaces:
                plan.workspaces[key] = em_mod.make_workspace(
                    plan.problem.hoods, plan.problem.model, em_config
                )
        self._sync()
        t0 = time.perf_counter()
        if shards > 1:
            p = plan.problem
            labels0, mu0, sigma0 = pipeline_mod.initial_params(p, seed, self.config.init)
            res = distributed_mod.run_em_sharded(
                plan.partitions[shards], p.model, labels0, mu0, sigma0, config=em_config,
            )
        else:
            res = pipeline_mod.optimize(
                plan.problem, seed=seed, config=em_config, init=self.config.init,
                workspace=plan.workspaces[key],
            )
        self._sync()
        opt_s = time.perf_counter() - t0
        return pipeline_mod.assemble_result(plan.problem, res, plan.init_seconds, opt_s)

    def segment(self, image, *, seed: int = 0, oversegmentation=None):
        """Plan + execute in one call."""
        return self.execute(self.plan(image, oversegmentation=oversegmentation), seed=seed)
