"""Plan -> compile -> execute session API.

Counterpart of ``repro.api.session.Segmenter``.

* :meth:`Segmenter.plan`: oversegmentation, region graph, cliques and
  neighborhoods (the paper's untimed init phase), the problem's bucket:
  its ``(capacity, n_hoods, n_regions)`` rounded up to the session's grid
  (``capacity_bucket``, ``segment_bucket``), and the calibrated cost
  model's prediction of one warm execute (``Plan.predicted_optimize_s``;
  :meth:`Segmenter.cost_model`, ``repro_torch.planning``).
* :meth:`Segmenter.compile`: the executable of one bucket (and batch
  size), built from its shapes alone and kept in an LRU cache keyed by
  :class:`ExecutableKey`.  PyTorch runs eagerly, so what a compile builds
  is the MAP loop's workspace (``kernels.ops.tick_workspace``, every buffer
  of the route's kernel) and binds the driver to it; a warm hit builds no
  workspace (``kernels.ops.WORKSPACE_BUILDS`` counts them; the budget
  ledger's ``"compile"`` section counts misses and hits).  In the modes
  ``static`` and ``faithful`` a one-request executable binds the driver
  alone; a batched one binds it to the stack's ``em.DppBatchWorkspace``.
* :meth:`Segmenter.execute`: the plan padded into its bucket (memoised on
  the plan) and solved by the bucket's executable.  Padding lanes are
  invalid elements, empty phantom hoods and weight-0 vertices, which add
  nothing to any sum, so a padded solve equals the natural one bit for
  bit.
* :meth:`Segmenter.submit` / :meth:`Segmenter.drain`: pending requests of
  one bucket run as one ``run_em_batched`` (per lockstep MAP iteration one
  batched tick launch in mode ``static-pallas``, one flat MAP iteration of
  every lane in the modes ``static`` and ``faithful``); each lane equals
  its serial :meth:`execute` bit for bit.
  :meth:`Segmenter.segment_stack` submits a volume's slices under their
  joint bucket, or solves them one by one, as :meth:`choose_batch`
  predicts faster.
* :meth:`Segmenter.compile_ticked` / :meth:`Segmenter.ticked_pool` /
  :meth:`Segmenter.lane_state`: the continuous-batching engine's pool
  (``repro_torch.serving.engine``): one pool workspace per (bucket,
  slots), ``em.run_em_ticked`` at any tick size on it, and each request's
  admission-ready lane, memoised on its plan; in every mode.

On the sharded route (``config.shards > 1``) every rank of the default
``torch.distributed`` group calls :meth:`execute` with the same plan and
solves its block of the hood elements; the plan's partition is memoised on
the plan, its rank workspace kept in the session's cache under the
executable's key (which carries ``shards``); ``drain`` runs such requests
serially.

Failures of a compile or an execute follow ``config.fallback``
(:class:`~repro_torch.api.config.FallbackPolicy`): retries on the same
route, then, only where the policy names the plain route, a recompile
there (``fallback_events``, a ``RuntimeWarning``, and a redirect of the
failed key); otherwise :class:`~repro_torch.api.errors.FallbackError`.
The chaos harness's ``on_compile`` and ``on_execute`` hooks sit inside the
attempts.

Both phases are timed on the host clock around work that ends in
``torch.cuda.synchronize`` when they run on the card.
"""

from __future__ import annotations

import itertools
import time
import warnings
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import DeviceLike, resolve_device, to_tensor
from repro_torch import planning as planning_mod
from repro_torch.analysis import budget as budget_mod
from repro_torch.api.config import ExecutionConfig
from repro_torch.api.errors import FallbackError, PlanError
from repro_torch.core.pmrf import distributed as distributed_mod
from repro_torch.core.pmrf import em as em_mod
from repro_torch.core.pmrf import energy as energy_mod
from repro_torch.core.pmrf import pipeline as pipeline_mod
from repro_torch.core.pmrf.hoods import Hoods, pad_hoods, stack_hoods
from repro_torch.kernels.ref import TickShape
from repro_torch.planning import legacy_batch_choice
from repro_torch.testing import chaos as chaos_mod


class BucketKey(NamedTuple):
    """Shared static shapes a plan is padded to (the compile unit)."""

    capacity: int
    n_hoods: int
    n_regions: int


class ExecutableKey(NamedTuple):
    """Cache key of an executable: the reference's fields.  ``backend`` is
    the route ("cuda": the kernels; "torch": the plain versions), ``batch``
    ``None`` for one request or the group size (the slot count of a ticked
    pool), ``shards`` the rank count, ``tick_iters`` ``None`` but for a
    ticked executable (``Segmenter.compile_ticked``), where it is the tick
    size.  Unlike the reference's, the ticked executables of one pool
    share one workspace, which holds the pool's state: a key per tick size,
    one build per pool."""

    capacity: int
    n_hoods: int
    n_regions: int
    backend: str
    mode: str
    max_em_iters: int
    max_map_iters: int
    batch: Optional[int]
    shards: int
    tick_iters: Optional[int] = None
    n_labels: int = 2
    precision: str = "f32"


_plan_ids = itertools.count()


@dataclass
class Plan:
    """A planned (initialized and bucketed) segmentation problem."""

    problem: pipeline_mod.Problem
    bucket: BucketKey
    init_seconds: float
    # The cost model's estimate of one warm execute of this plan under the
    # session's config: what the autotuner compares when routing.
    predicted_optimize_s: Optional[float] = None
    # Padded inputs, memoised by (bucket, shards, K) and by (bucket, seed,
    # init, shards, K): repeat executes of the plan pay no padding.
    _padded: dict = field(default_factory=dict, repr=False, compare=False)
    uid: int = field(default_factory=lambda: next(_plan_ids), repr=False, compare=False)

    @property
    def n_regions(self) -> int:
        return self.problem.graph.n_regions

    @property
    def partitions(self) -> Dict[int, Hoods]:
        """The plan's sharded partitions made so far, by shard count."""
        return {k[2]: v[0] for k, v in self._padded.items() if k[0] == "hoods" and k[2] > 1}


@dataclass
class Executable:
    """The EM program of one bucket (and batch size): the driver bound to a
    workspace built from the bucket's shapes (none for one request in the
    modes ``static`` and ``faithful``).  On the sharded route the
    static-pallas workspace is the rank's and depends on the plan's
    partition, so the executable keeps one per plan (``shard_workspaces``,
    LRU)."""

    key: ExecutableKey
    workspace: object
    em_config: em_mod.EMConfig
    compile_seconds: float
    calls: int = 0
    shard_workspaces: "OrderedDict[int, object]" = field(default_factory=OrderedDict, repr=False)

    def __call__(self, *args):
        """``(hoods, model, labels0, mu0, sigma0)`` for a solve, or a ticked
        executable's pool state (``em.TickState``): one tick,
        ``(state, steps_executed)``."""
        self.calls += 1
        if self.key.tick_iters is not None:
            (state,) = args
            return em_mod.run_em_ticked(state, self.em_config, self.key.tick_iters)
        run = em_mod.run_em if self.key.batch is None else em_mod.run_em_batched
        return run(*args, self.em_config, workspace=self.workspace)


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    def as_dict(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses, "evictions": self.evictions}


class _Pending(NamedTuple):
    plan: Plan
    seed: int
    bucket: BucketKey


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class Segmenter:
    """A segmentation session: one execution policy on one device
    (``device=None``: the CUDA device, or :class:`RuntimeError`) and one
    executable cache.  Not thread-safe; share it across requests, not
    across threads."""

    def __init__(self, config: ExecutionConfig = ExecutionConfig(), *, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self._cache: "OrderedDict[ExecutableKey, Executable]" = OrderedDict()
        # Ticked pools' workspaces, by their executables' key with tick_iters None.
        self._pools: Dict[ExecutableKey, object] = {}
        self._pending: List[_Pending] = []
        self.stats = CacheStats()
        # The fallback policy's bookkeeping: once a key's compile or execute
        # falls back to the plain route, its warm traffic goes straight to
        # the fallback executable (the redirect).
        self._fallback_redirects: Dict[ExecutableKey, ExecutableKey] = {}
        self.fallback_events: List[Dict[str, str]] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # phase 1: plan
    # ------------------------------------------------------------------

    def bucket_of(self, hoods: Hoods) -> BucketKey:
        """Round a problem's static dims up to the session's bucket grid."""
        c = self.config
        return BucketKey(
            capacity=_round_up(hoods.capacity, c.capacity_bucket),
            n_hoods=_round_up(hoods.n_hoods, c.segment_bucket),
            n_regions=_round_up(hoods.n_regions, c.segment_bucket),
        )

    def plan(self, image, *, oversegmentation=None) -> Plan:
        """Initialization phase and bucket assignment; rejects empty or
        non-finite images with :class:`PlanError` before any work."""
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
        init_s = time.perf_counter() - t0
        bucket = self.bucket_of(problem.hoods)
        return Plan(
            problem=problem, bucket=bucket, init_seconds=init_s,
            predicted_optimize_s=self.cost_model().predict_solve(
                mode=c.mode, bucket=bucket, n_labels=c.n_labels, shards=c.shards,
                precision=c.precision, max_em_iters=c.max_em_iters,
                max_map_iters=c.max_map_iters,
            ),
        )

    def cost_model(self) -> planning_mod.CostModel:
        """The calibrated plan cost model of this session's platform (the
        device's: ``"gpu"`` on the card, ``"cpu"`` on the host); every
        autotuned routing decision queries this one object."""
        return planning_mod.model_for(self.config, device=self.device)

    def choose_batch(
        self, plans: Sequence[Plan], *, joint_bucket: Optional[BucketKey] = None
    ) -> planning_mod.BatchDecision:
        """The cost model's verdict on one lockstep solve of ``plans`` under
        ``joint_bucket`` (default: their elementwise max) against solving
        them one by one, each in its own bucket: what ``segment_stack``'s
        ``batch="auto"`` routes on."""
        if joint_bucket is None:
            joint_bucket = BucketKey(*(max(p.bucket[d] for p in plans) for d in range(3)))
        c = self.config
        return self.cost_model().choose_batch(
            mode=c.mode, buckets=[p.bucket for p in plans], joint_bucket=joint_bucket,
            n_labels=c.n_labels, precision=c.precision, max_em_iters=c.max_em_iters,
            max_map_iters=c.max_map_iters,
        )

    # ------------------------------------------------------------------
    # phase 2: compile (cached)
    # ------------------------------------------------------------------

    def _key_for(self, bucket: BucketKey, batch: Optional[int],
                 backend: Optional[str] = None) -> ExecutableKey:
        c = self.config
        return ExecutableKey(
            capacity=bucket.capacity,
            n_hoods=bucket.n_hoods,
            n_regions=bucket.n_regions,
            backend=c.resolved_backend(self.device) if backend is None else backend,
            mode=c.mode,
            max_em_iters=c.max_em_iters,
            max_map_iters=c.max_map_iters,
            batch=batch,
            shards=c.shards,
            n_labels=c.n_labels,
            precision=c.precision,
        )

    def compile(
        self, target: Union[Plan, BucketKey, Tuple[int, int, int]], *, batch: Optional[int] = None,
        backend: Optional[str] = None,
    ) -> Executable:
        """The executable of a bucket, built on a miss from its shapes alone
        (no data): the bucket's MAP-iteration workspace (``batch``: for
        that many lanes) bound to the EM driver.  LRU-cached by
        :class:`ExecutableKey`; a hit builds nothing.  Eviction drops the
        least recently used executable once the cache passes
        ``config.max_cached_executables``.  ``backend`` overrides the
        session's route ("cuda" or "torch"; the execute-time fallback uses
        it).  A failing build follows ``config.fallback``."""
        bucket = BucketKey(*(target.bucket if isinstance(target, Plan) else target))
        shards = self.config.shards
        if batch is not None and shards > 1:
            raise ValueError(
                "batched executables are not supported with shards > 1 (the ranks "
                "already split one request); drain() runs sharded requests serially"
            )
        if batch is not None and batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")

        def build(route: str):
            em_config = self._em_config_for(route)
            if shards > 1 or (batch is None and self.config.mode != "static-pallas"):
                return None, em_config
            return em_mod.make_workspace(self._shape(bucket), em_config, device=self.device,
                                         batch=batch), em_config

        return self._get_or_build(self._key_for(bucket, batch, backend), build)

    def _em_config_for(self, route: str) -> em_mod.EMConfig:
        """The EM config of an executable on ``route``: the plain route
        forces ``backend="torch"``; the kernel route keeps the session's."""
        return self.config.em_config(backend="torch" if route == "torch" else None)

    def _shape(self, bucket: BucketKey) -> TickShape:
        return TickShape(bucket.capacity, bucket.n_hoods, bucket.n_regions + 1, self.config.n_labels)

    def _get_or_build(self, key: ExecutableKey, build) -> Executable:
        """The cached executable of ``key`` (LRU; a key whose build fell back
        is redirected to its fallback's), or a new one around the workspace
        and EM config ``build(route)`` returns, built under the fallback
        policy (:meth:`_build_with_policy`)."""
        key = self._fallback_redirects.get(key, key)
        exe = self._cache.get(key)
        if exe is not None:
            self._cache.move_to_end(key)
            self.stats.hits += 1
            budget_mod.LEDGER.bump("compile", "warm_hit")
            return exe
        self.stats.misses += 1
        budget_mod.LEDGER.bump("compile", "lower_compile")
        t0 = time.perf_counter()
        workspace, em_config, key = self._build_with_policy(key, build)
        exe = self._cache[key] = Executable(
            key=key, workspace=workspace, em_config=em_config,
            compile_seconds=time.perf_counter() - t0,
        )
        while len(self._cache) > self.config.max_cached_executables:
            self._cache.popitem(last=False)
            self.stats.evictions += 1
        return exe

    def _build_with_policy(self, key: ExecutableKey, build):
        """``build(key.backend)`` (behind the chaos harness's compile hook)
        under ``config.fallback``: retries on the same route, then the plain
        route if the policy names it (an event, a warning, a redirect), else
        :class:`FallbackError`, or the original error when the policy is
        disabled.  Returns ``(workspace, em_config, key_built)``."""
        policy = self.config.fallback

        def attempt(route: str):
            def run():
                chaos_mod.on_compile(route)
                return build(route)
            return run

        try:
            return (*policy.retrying(attempt(key.backend)), key)
        except Exception as e:
            if not policy.enabled:
                raise
            if policy.backend is None or key.backend == policy.backend:
                raise FallbackError(
                    f"compile failed on route {key.backend!r} (retried up to "
                    f"{policy.max_retries} times); the policy takes no other route "
                    "(FallbackPolicy(backend='torch') asks for the plain one)"
                ) from e
            fb_key = key._replace(backend=policy.backend)
            self._record_fallback("compile", key.backend, policy.backend, e)
            try:
                built = policy.retrying(attempt(policy.backend))
            except Exception as fb_e:
                raise FallbackError(
                    f"compile failed on route {key.backend!r} and on the fallback route "
                    f"{policy.backend!r}"
                ) from fb_e
            self._fallback_redirects[key] = fb_key
            return (*built, fb_key)

    def _record_fallback(self, stage: str, route: str, to: str, error: Exception) -> None:
        self.fallback_events.append({"stage": stage, "from": route, "to": to, "error": repr(error)})
        warnings.warn(
            f"{stage} on route {route!r} failed ({error!r}); falling back to {to!r}",
            RuntimeWarning, stacklevel=4,
        )

    def _pool_workspace(self, bucket: BucketKey, batch: int, route: Optional[str] = None):
        """The pool workspace of ``batch`` slots of ``bucket`` on ``route``
        (default: the session's), built on first use from the shapes alone
        and kept for the session."""
        key = self._key_for(bucket, batch, route)
        ws = self._pools.get(key)
        if ws is None:
            ws = self._pools[key] = em_mod.make_workspace(
                self._shape(bucket), self._em_config_for(key.backend), device=self.device,
                batch=batch, pool=True)
        return ws

    def _check_ticked(self, batch: int, tick_iters: int = 1) -> None:
        if self.config.shards > 1:
            raise ValueError(
                "ticked serving executables are single-device (the pool's slot axis "
                "is the parallel axis); use shards=1"
            )
        if batch < 1 or tick_iters < 1:
            raise ValueError("compile_ticked needs batch >= 1 and tick_iters >= 1")

    def compile_ticked(
        self, target: Union[Plan, BucketKey, Tuple[int, int, int]], *, batch: int,
        tick_iters: int = 8,
    ) -> Executable:
        """The ticked serving executable of a ``batch``-slot pool of a
        bucket: ``em.run_em_ticked`` at ``tick_iters``, called on the pool's
        state (:meth:`ticked_pool`) and returning ``(state,
        steps_executed)``.  LRU-cached beside the other executables under
        its own key (``ExecutableKey.tick_iters``); every tick size of one
        pool runs on the one pool workspace, built at the first compile,
        so switching tick sizes builds nothing.  A failing build follows
        ``config.fallback``; a fallback executable runs on the plain
        route's pool workspace."""
        bucket = BucketKey(*(target.bucket if isinstance(target, Plan) else target))
        self._check_ticked(batch, tick_iters)
        key = self._key_for(bucket, batch)._replace(tick_iters=tick_iters)
        return self._get_or_build(key, lambda route: (
            self._pool_workspace(bucket, batch, route), self._em_config_for(route)))

    def ticked_pool(self, target, *, batch: int, backend: Optional[str] = None) -> em_mod.TickState:
        """An all-empty slot pool for the ticked executables of a bucket
        (``em.blank_tick_state`` on the pool's workspace: every lane done,
        ready for admission), on the route ``backend`` (default: the
        session's; pass the executables' ``key.backend``).  The pool's state
        lives in that workspace, so a new pool of the same bucket and slots
        takes it over from any earlier one."""
        bucket = BucketKey(*(target.bucket if isinstance(target, Plan) else target))
        self._check_ticked(batch)
        return em_mod.blank_tick_state(self._pool_workspace(bucket, batch, backend))

    def lane_inputs(self, plan: Plan, *, bucket: Optional[BucketKey] = None, seed: int = 0):
        """One request's padded inputs for a ticked pool: ``(hoods, model,
        labels0, mu0, sigma0)``, the arrays :meth:`execute` gives ``run_em``
        (memoised on the plan), so a lane's ticked trajectory is the serial
        result's."""
        bucket = BucketKey(*bucket) if bucket is not None else plan.bucket
        return self._pad_plan(plan, bucket, seed)

    def lane_state(self, plan: Plan, *, bucket: Optional[BucketKey] = None, seed: int = 0):
        """One request's admission-ready lane: :meth:`lane_inputs` and its
        element arrays (``energy.make_static_context``, one
        ``segment_reduce`` launch; ``None`` in the modes ``static`` and
        ``faithful``, whose pools read none), ``(hoods, model, labels0, mu0,
        sigma0, sctx)``.  The element arrays are memoised on the plan beside
        its padding, so repeat traffic admits with device copies alone."""
        bucket = BucketKey(*bucket) if bucket is not None else plan.bucket
        hoods, model, labels0, mu0, sigma0 = self._pad_plan(plan, bucket, seed)
        if self.config.mode != "static-pallas":
            return hoods, model, labels0, mu0, sigma0, None
        memo_key = ("lane", bucket, self.config.shards, self.config.n_labels)
        sctx = plan._padded.get(memo_key)
        if sctx is None:
            sctx = plan._padded[memo_key] = energy_mod.make_static_context(
                hoods, model, backend=self.config.backend)
        return hoods, model, labels0, mu0, sigma0, sctx

    def clear_cache(self) -> None:
        self._cache.clear()
        self._pools.clear()

    @property
    def cache_keys(self) -> Tuple[ExecutableKey, ...]:
        return tuple(self._cache)

    # ------------------------------------------------------------------
    # phase 3: execute
    # ------------------------------------------------------------------

    def _pad_plan(self, plan: Plan, bucket: BucketKey, seed: int):
        """One plan's inputs padded into ``bucket``: ``(hoods, model,
        labels0, mu0, sigma0)``, memoised on the plan (the padded hoods and
        model once per bucket, the initial parameters once per seed).

        The initial parameters come from the plan's own unpadded problem,
        so a padded solve draws what the natural one draws.  A plan with
        fewer labels than the session is label-padded with inert labels
        (``energy.pad_model_labels``); one with more is refused.  On the
        sharded route the padded hoods are also partitioned."""
        n_labels, shards = self.config.n_labels, self.config.shards
        plan_labels = plan.problem.model.n_labels
        if plan_labels > n_labels:
            raise ValueError(
                f"plan has {plan_labels} labels but the session runs n_labels={n_labels}; "
                "re-plan with a wider session"
            )
        memo_key = (bucket, seed, self.config.init, shards, n_labels)
        cached = plan._padded.get(memo_key)
        if cached is not None:
            return cached
        p = plan.problem
        cap, nh, nr = bucket
        hoods_key = ("hoods", bucket, shards, n_labels)
        padded = plan._padded.get(hoods_key)
        if padded is None:
            hoods = pad_hoods(p.hoods, capacity=cap, n_hoods=nh, n_regions=nr, n_elements=-1)
            if shards > 1:
                hoods = distributed_mod.partition_hoods(hoods, shards)
            model = energy_mod.pad_model_labels(energy_mod.pad_model(p.model, nr), n_labels)
            padded = plan._padded[hoods_key] = (hoods, model)
        hoods, model = padded
        labels0, mu0, sigma0 = pipeline_mod.initial_params(p, seed, self.config.init)
        mu0, sigma0 = energy_mod.pad_params_labels(mu0, sigma0, n_labels)
        lab = torch.zeros((nr + 1,), dtype=torch.int32, device=labels0.device)
        lab[: p.graph.n_regions] = labels0[: p.graph.n_regions]
        plan._padded[memo_key] = (hoods, model, lab, mu0, sigma0)
        return plan._padded[memo_key]

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

    def _run_sharded(self, exe: Executable, plan: Plan, inputs):
        """The sharded solve of one plan; in mode static-pallas on this
        rank's workspace, kept in the executable under the plan (LRU)."""
        hoods, model, labels0, mu0, sigma0 = inputs
        exe.calls += 1
        if exe.em_config.mode != "static-pallas":
            return distributed_mod.run_em_sharded(
                hoods, model, labels0, mu0, sigma0, config=exe.em_config)
        ws = exe.shard_workspaces.get(plan.uid)
        if ws is None:
            ws = exe.shard_workspaces[plan.uid] = distributed_mod.make_workspace(
                hoods, model, exe.em_config)
            while len(exe.shard_workspaces) > self.config.max_cached_executables:
                exe.shard_workspaces.popitem(last=False)
        exe.shard_workspaces.move_to_end(plan.uid)
        return distributed_mod.run_em_sharded(
            hoods, model, labels0, mu0, sigma0, config=exe.em_config, workspace=ws)

    def execute(
        self, plan: Plan, *, seed: int = 0, bucket: Optional[BucketKey] = None
    ) -> pipeline_mod.SegmentationResult:
        """Solve one plan through its bucket's executable (``bucket``
        overrides the plan's own; ``seed`` drives the random init).

        A failing solve follows ``config.fallback``
        (:meth:`_execute_with_policy`); the optimize time includes its
        retries."""
        if self.config.shards > 1:
            self._check_group()
        bucket = BucketKey(*bucket) if bucket is not None else plan.bucket
        exe = self.compile(bucket)
        inputs = self._pad_plan(plan, bucket, seed)
        self._sync()
        t0 = time.perf_counter()
        res = self._execute_with_policy(exe, bucket, inputs, plan=plan)
        opt_s = time.perf_counter() - t0
        return pipeline_mod.assemble_result(plan.problem, res, plan.init_seconds, opt_s)

    def _execute_with_policy(self, exe: Executable, bucket: BucketKey, inputs, *,
                             plan: Optional[Plan] = None, batch: Optional[int] = None):
        """Run ``exe`` on ``inputs`` (one plan's, or with ``batch`` a
        stack's; behind the chaos harness's execute hook, synchronised)
        under ``config.fallback``: retries on the same route (a solve
        restarts from its inputs, so a retry is exact), then the plain
        route if the policy names it (an event, a warning, a redirect of
        the key), else :class:`FallbackError`, or the original error when
        the policy is disabled.  On the sharded route a failed solve is
        neither retried nor rerouted: the ranks' collectives would part."""
        policy = self.config.fallback
        sharded = self.config.shards > 1
        retries = 0 if sharded else policy.max_retries

        def attempt(exe: Executable):
            def run():
                chaos_mod.on_execute(exe.key.backend)
                res = self._run_sharded(exe, plan, inputs) if sharded else exe(*inputs)
                self._sync()
                return res
            return run

        try:
            return policy.retrying(attempt(exe), max_retries=retries)
        except Exception as e:
            if not policy.enabled:
                raise
            if policy.backend is None or exe.key.backend == policy.backend or sharded:
                raise FallbackError(
                    f"execute failed on route {exe.key.backend!r} (retried up to {retries} "
                    "times); no other route was taken"
                ) from e
            self._record_fallback("execute", exe.key.backend, policy.backend, e)
            self._fallback_redirects[exe.key] = exe.key._replace(backend=policy.backend)
            fb = self.compile(bucket, batch=batch, backend=policy.backend)
            try:
                return policy.retrying(attempt(fb), max_retries=retries)
            except Exception as fb_e:
                raise FallbackError(
                    f"execute failed on route {exe.key.backend!r} and on the fallback route "
                    f"{policy.backend!r}"
                ) from fb_e

    def segment(self, image, *, seed: int = 0, oversegmentation=None):
        """Plan + execute in one call."""
        return self.execute(self.plan(image, oversegmentation=oversegmentation), seed=seed)

    # ------------------------------------------------------------------
    # micro-batching: submit / drain
    # ------------------------------------------------------------------

    def submit(self, image_or_plan, *, seed: int = 0, bucket: Optional[BucketKey] = None) -> int:
        """Enqueue a request; returns its ticket (its index in ``drain()``).
        ``bucket`` overrides the plan's own: a caller coalescing a known
        group (a volume's slices) passes the group's joint bucket."""
        plan = image_or_plan if isinstance(image_or_plan, Plan) else self.plan(image_or_plan)
        bucket = BucketKey(*bucket) if bucket is not None else plan.bucket
        self._pending.append(_Pending(plan=plan, seed=seed, bucket=bucket))
        return len(self._pending) - 1

    def pending(self) -> int:
        return len(self._pending)

    def drain(self) -> List[pipeline_mod.SegmentationResult]:
        """Solve every pending request, coalescing same-bucket groups.

        A group of n > 1 requests runs as one ``run_em_batched`` through the
        bucket's batch-n executable, in every mode and under
        ``config.fallback`` as :meth:`execute` is; results come back in
        submission order, each equal to a serial :meth:`execute` bit for
        bit, with the group's optimize time shared evenly.  Sharded
        sessions run every request serially.  If a group fails, every
        request without a result is queued again (ahead of anything
        submitted since) and the error raised."""
        pending, self._pending = self._pending, []
        if not pending:
            return []
        groups: "OrderedDict[BucketKey, List[int]]" = OrderedDict()
        for i, req in enumerate(pending):
            groups.setdefault(req.bucket, []).append(i)
        results: List[Optional[pipeline_mod.SegmentationResult]] = [None] * len(pending)
        try:
            serial = self.config.shards > 1
            for bucket, members in groups.items():
                if len(members) == 1 or serial:
                    for i in members:
                        results[i] = self.execute(pending[i].plan, seed=pending[i].seed, bucket=bucket)
                    continue
                exe = self.compile(bucket, batch=len(members))
                inputs = self.stacked_inputs([pending[i].plan for i in members], bucket=bucket,
                                             seeds=[pending[i].seed for i in members])
                self._sync()
                t0 = time.perf_counter()
                res = self._execute_with_policy(exe, bucket, inputs, batch=len(members))
                opt_s = (time.perf_counter() - t0) / len(members)
                # One copy of each stacked result to the host, not one per lane.
                res = res._replace(**{f: getattr(res, f).cpu()
                                      for f in ("labels", "mu", "sigma", "hood_energy", "total_energy")})
                for j, i in enumerate(members):
                    results[i] = pipeline_mod.assemble_result(
                        pending[i].plan.problem, res.lane(j), pending[i].plan.init_seconds, opt_s)
        except Exception:
            unprocessed = [pending[i] for i in range(len(pending)) if results[i] is None]
            self._pending = unprocessed + self._pending
            raise
        return results  # type: ignore[return-value]

    def stacked_inputs(self, plans: Sequence[Plan], *, bucket: BucketKey, seeds: Sequence[int]):
        """The inputs of one batched solve: each plan padded into ``bucket``
        (memoised, as :meth:`execute` pads it) and stacked on a leading
        lane axis, ``(hoods, model, labels0, mu0, sigma0)``."""
        padded = [self._pad_plan(p, BucketKey(*bucket), s) for p, s in zip(plans, seeds)]
        hoods = stack_hoods([p[0] for p in padded])
        model = energy_mod.EnergyModel(*(torch.stack(f) for f in zip(*(p[1] for p in padded))))
        return (hoods, model, *(torch.stack([p[j] for p in padded]) for j in (2, 3, 4)))

    # ------------------------------------------------------------------
    # slice stacks
    # ------------------------------------------------------------------

    def segment_stack(
        self, images: Sequence, *, seed: int = 0, batch: str = "auto"
    ) -> Tuple[List[pipeline_mod.SegmentationResult], float]:
        """Segment a slice stack; returns ``(results, mean optimize
        seconds)``.

        ``batch="always"`` submits every slice under the stack's joint
        bucket (the elementwise max) so the whole volume runs as one
        batched solve; ``"never"`` solves the slices one by one, each in its
        own bucket.  ``"auto"`` takes the side the calibrated cost model
        predicts faster (:meth:`choose_batch`): the batched side priced at
        the joint bucket with the lockstep-iteration inflation and the
        platform's lane-serialization factor, the serial side at each
        slice's own bucket, so a wide capacity spread shows up as padding
        cost.  One slice, or a sharded session, runs serially.  With
        ``REPRO_DISABLE_AUTOTUNE=1`` ``"auto"`` takes
        :func:`~repro_torch.planning.legacy_batch_choice` instead (batch on
        the card when the capacities are within 2x of each other).  Every
        mode; a sharded session refuses ``"always"``."""
        if batch not in ("auto", "always", "never"):
            raise ValueError(f"batch must be auto/always/never, got {batch!r}")
        if batch == "always" and self.config.shards > 1:
            raise ValueError(
                "batch='always' is not supported with shards > 1; use batch='auto' "
                "(sharded requests run serially)"
            )
        images = list(images)
        if not images:
            raise ValueError("segment_stack: empty image stack")
        plans = [self.plan(img) for img in images]
        joint = BucketKey(*(max(p.bucket[d] for p in plans) for d in range(3)))
        if batch == "always":
            use_batch = True
        elif batch == "never" or self.config.shards > 1 or len(plans) < 2:
            use_batch = False
        elif planning_mod.autotune_disabled():
            use_batch = legacy_batch_choice(
                [p.problem.hoods.capacity for p in plans], planning_mod.platform_of(self.device))
        else:
            use_batch = self.choose_batch(plans, joint_bucket=joint).use_batch
        if use_batch:
            for p in plans:
                self.submit(p, seed=seed, bucket=joint)
            results = self.drain()
        else:
            results = [self.execute(p, seed=seed) for p in plans]
        return results, float(np.mean([r.optimize_seconds for r in results]))


# ---------------------------------------------------------------------------
# module-level session registry (the deprecation shims' backing store)
# ---------------------------------------------------------------------------

_SESSIONS: "OrderedDict[tuple, Segmenter]" = OrderedDict()

#: Sessions kept by :func:`session_for` (LRU): each holds up to its
#: ``max_cached_executables`` executables.
MAX_SESSIONS = 8


def session_for(config: Optional[ExecutionConfig] = None, *, device: DeviceLike = None) -> Segmenter:
    """The process-wide session of a (config, device) (LRU,
    ``MAX_SESSIONS``), so that one-shot callers of one config share its
    executable cache."""
    config = config or ExecutionConfig()
    key = (config, resolve_device(device))
    sess = _SESSIONS.get(key)
    if sess is None:
        sess = _SESSIONS[key] = Segmenter(config, device=key[1])
    else:
        _SESSIONS.move_to_end(key)
    while len(_SESSIONS) > MAX_SESSIONS:
        _SESSIONS.popitem(last=False)
    return sess


def default_session(*, device: DeviceLike = None) -> Segmenter:
    return session_for(ExecutionConfig(), device=device)


def reset_sessions() -> None:
    """Drop every module-level session and its executable cache."""
    _SESSIONS.clear()
