"""Continuous-batching segmentation serving engine (counterpart of
``repro.serving.engine``).

The engine owns a fixed pool of ``max_batch`` slots of one bucket
(``Segmenter.ticked_pool``, on the pool's workspace) and advances every
resident request in **ticks**: one ``em.run_em_ticked`` call, up to
``tick_iters`` micro-steps, each micro-step one step of the pool in which
every live lane runs its own next MAP iteration: one launch of the tick's
pool entry in mode ``static-pallas``, one flat MAP iteration of every lane
(``em.DppPoolWorkspace``) in the modes ``static`` and ``faithful``.  Between
ticks the host retires finished lanes and admits pending requests into
the freed slots in priority/deadline order.  Admission and retirement are
writes to one slot's rows; no other lane moves and no workspace is built.

The lockstep alternative (``run_em_batched``, ``Segmenter.drain``) runs
every lane to the slowest lane's convergence; here a lane pays its own
iterations, plus at most one tick of granularity, and not even that when
the whole pool converges (the driver exits at the convergence boundary).

Tick size trades throughput against latency: large ticks amortise the
fixed cost of a tick on the host, small ticks hand control back sooner
so that done lanes retire and queued requests admit.  With
``tick_iters="auto"`` the engine fits ``cost(t) = a + b*t`` to its own
tick times (``planning.lsq.DecayedAffineFit``) and picks the ladder size
that minimises the expected cost per useful micro-step, with hysteresis.
Every ladder size is compiled at pool bring-up and all of them run on the
one pool workspace, so a switch is a cache hit that builds nothing.  The
fit starts from the calibrated cost model's prediction for the pool
(``CostModel.tick_cost_prior``: the per-launch dispatch as ``a``, one pool
micro-step as ``b``).  Each tick also counts into the budget ledger's
``"serve"`` section (``ticks``, ``lane_steps``).

Every request's result equals its serial ``Segmenter.execute`` bit for
bit (labels, segmentation, mu, sigma, energies, iteration counts,
status), whatever the tick schedule and whatever shares its pool.

Failure model: requests are validated at ``submit`` (``PlanError`` for
an image, :class:`~repro_torch.api.errors.RequestError` for a plan); a
lane that diverges or degenerates on the device retires through the
ordinary path as a :class:`SegCompletion` with that error status; a lane
that never converges is evicted once its micro-step residency budget runs
out.  Healthy co-resident lanes are untouched bit for bit.  Tick times
feed a :class:`~repro_torch.training.fault.StragglerWatchdog`.  A failed
tick follows the session's ``FallbackPolicy``.  On its own route it is
replayed (up to ``max_retries`` times, with the policy's backoff) only
when it failed before its first launch, as the chaos harness's execute
faults do, since a tick that launched has written the pool's state in
place.  Then, under ``FallbackPolicy(backend="torch")``, the live pool
switches to the plain route on the same device, as the reference's
engine moves its pool to its fallback backend: the pool's state is
carried onto the plain route's pool workspace as it stood before the
failed tick (a snapshot taken before every tick while the policy names a
fallback, ``em.tick_snapshot``), every tick size of the ladder is pointed
at the plain route, the tick is replayed there, and the pool never
switches back; one ``fallback_events`` entry (the reference's keys) and
one ``RuntimeWarning`` record it, and ``stats()["fallbacks"]`` counts it.
Every resident lane stays resident and goes on from where it stood.
Otherwise (the default policy, an engine already on the plain route, or
a failure after which the plain replay fails too) the tick raises
:class:`~repro_torch.api.errors.FallbackError` (the original error with
the policy disabled).  A CUDA error (``api.config.is_cuda_error``) never
switches: it may have poisoned the context, so it raises
``FallbackError`` whatever the policy.  A pool whose executables' build
fell back starts on the plain route.

Mixed K: the pool runs at the session's ``n_labels``; a request with
fewer labels is label-padded with inert labels (its real labels take the
trajectory of its own K), one with more is refused at ``submit``.
"""

from __future__ import annotations

import heapq
import math
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch import planning as planning_mod
from repro_torch.analysis import budget as budget_mod
from repro_torch.api.config import ExecutionConfig, is_cuda_error
from repro_torch.api.errors import FallbackError, RequestError
from repro_torch.api.session import BucketKey, Plan, Segmenter
from repro_torch.core.pmrf import em as em_mod
from repro_torch.core.pmrf import energy as energy_mod
from repro_torch.core.pmrf import pipeline as pipeline_mod
from repro_torch.planning.lsq import DecayedAffineFit
from repro_torch.testing import chaos as chaos_mod
from repro_torch.training.fault import StragglerWatchdog

_INF = math.inf

#: Completion statuses that mean "the result is a legitimate segmentation".
OK_COMPLETION_STATUSES = ("converged", "max_iters")

#: Default adaptive tick-size ladder (the reference's).
DEFAULT_TICK_LADDER = (1, 2, 4, 8, 16)

#: Cold-start ``(a, b)`` of the tick-cost fit while the pool's bucket is
#: unknown or the cost model is switched off (``REPRO_DISABLE_AUTOTUNE``):
#: the reference's fallback.
TICK_COST_PRIOR = (5e-3, 5e-3)


@dataclass
class SegRequest:
    """One queued request.  Admission order is ``(priority, deadline,
    rid)``: lower ``priority`` first (0 by default, negative for
    latency-sensitive traffic), then the earliest ``deadline_s`` (``None``
    last), then the lowest ``rid``: a total order even when every deadline
    is ``None``.  A deadline orders admission and makes an adaptive engine
    shrink its ticks near it; it is not enforced."""

    rid: int
    plan: Plan
    seed: int = 0
    deadline_s: Optional[float] = None
    priority: int = 0
    submitted_s: float = field(default_factory=time.perf_counter)


@dataclass
class SegCompletion:
    """A finished request: its result, its disposition and its latency in
    two disjoint parts, ``queue_s`` (submit to admission) and
    ``residence_s`` (admission to retirement); ``latency_s`` is their sum.

    ``status`` is the lane's health (``"converged"``, ``"max_iters"``,
    ``"diverged"``, ``"degenerate"``, ``em.STATUS_NAMES``) for a lane that
    retired on its own, or ``"evicted"`` for one the engine stopped
    (residency budget, or the ``run`` cap).  ``result`` is always there;
    an error completion holds the lane's last state."""

    rid: int
    result: pipeline_mod.SegmentationResult
    latency_s: float
    queue_s: float
    residence_s: float
    ticks_resident: int
    slot: int
    status: str = "converged"

    @property
    def ok(self) -> bool:
        return self.status in OK_COMPLETION_STATUSES


class SegmentationEngine:
    """Fixed-slot continuous-batching server for segmentation requests::

        sess = api.Segmenter(api.ExecutionConfig(init="quantile"))
        eng = SegmentationEngine(sess, max_batch=8, tick_iters="auto")
        for rid, img in enumerate(images):
            eng.submit(img, rid=rid)
        completions = eng.run()

    The pool's bucket is fixed at the first tick: ``bucket=``, or the
    elementwise max of the pending requests' buckets.  Later requests must
    fit it.  ``tick_iters`` is an int or ``"auto"`` (the ladder policy,
    ``tick_hysteresis`` agreeing choices before a switch).
    ``max_ticks_resident`` bounds a lane's stay, in ticks of the initial
    size (default: the ticks of a worst-case ``max_em_iters x
    max_map_iters`` run, plus 2), enforced as a micro-step budget; a lane
    past it is evicted.  Not thread-safe, like the :class:`Segmenter` it
    drives.
    """

    def __init__(
        self,
        session: Union[Segmenter, ExecutionConfig, None] = None,
        *,
        max_batch: int = 8,
        tick_iters: Union[int, str] = 8,
        tick_ladder: Optional[Sequence[int]] = None,
        tick_hysteresis: int = 2,
        deadline_margin: float = 2.0,
        bucket: Optional[BucketKey] = None,
        max_ticks_resident: Optional[int] = None,
        watchdog: Optional[StragglerWatchdog] = None,
        device=None,
    ):
        if session is None:
            session = Segmenter(ExecutionConfig(), device=device)
        elif isinstance(session, ExecutionConfig):
            session = Segmenter(session, device=device)
        if session.config.shards > 1:
            raise ValueError(
                "SegmentationEngine is single-device (the slot axis is the "
                "parallel axis); use a shards=1 session"
            )
        self.adaptive = tick_iters == "auto"
        if self.adaptive:
            ladder = tuple(sorted(set(tick_ladder or DEFAULT_TICK_LADDER)))
            if not ladder or any(t < 1 for t in ladder):
                raise ValueError(f"tick_ladder entries must be >= 1, got {ladder}")
            tick_iters = ladder[min(len(ladder) - 1, len(ladder) // 2)]
        else:
            if not isinstance(tick_iters, int):
                raise ValueError(f"tick_iters must be an int or 'auto', got {tick_iters!r}")
            ladder = (tick_iters,)
        if max_batch < 1 or tick_iters < 1:
            raise ValueError("max_batch and tick_iters must be >= 1")
        if tick_hysteresis < 1:
            raise ValueError("tick_hysteresis must be >= 1")
        self.session = session
        self.max_batch = max_batch
        self.tick_iters = tick_iters          # the current tick size
        self.tick_ladder = ladder
        self.tick_hysteresis = tick_hysteresis
        self.deadline_margin = float(deadline_margin)
        self.bucket: Optional[BucketKey] = BucketKey(*bucket) if bucket is not None else None
        if max_ticks_resident is None:
            # A healthy lane's worst case is max_em_iters * max_map_iters
            # micro-steps; 2 ticks of slack for the boundaries.
            cfg = session.config
            max_ticks_resident = -(-cfg.max_em_iters * cfg.max_map_iters // tick_iters) + 2
        if max_ticks_resident < 1:
            raise ValueError("max_ticks_resident must be >= 1")
        self.max_ticks_resident = max_ticks_resident
        self._max_steps_resident = max_ticks_resident * tick_iters
        self.watchdog = watchdog if watchdog is not None else StragglerWatchdog()

        self._heap: List[tuple] = []   # (priority, deadline key, rid, seq, req)
        self._seq = 0
        self._auto_rid = 0
        self._live_rids: set = set()   # queued and resident
        self._exe = None
        self._route: Optional[str] = None   # the plain route, once the pool switched to it
        self._state: Optional[em_mod.TickState] = None
        self.slot_req: List[Optional[SegRequest]] = [None] * max_batch
        self._slot_admit_s = [0.0] * max_batch
        self._slot_admit_tick = [0] * max_batch
        self._slot_admit_steps = [0] * max_batch
        self._slot_hold = [False] * max_batch   # chaos: never-converge lanes
        self.completions: List[SegCompletion] = []
        self.ticks = 0
        self.admitted = 0
        self.evicted = 0
        self.error_completions = 0
        self.total_steps = 0           # micro-steps issued (pool launches)
        self.lane_steps = 0            # occupied-lane micro-steps
        self.steps_saved = 0           # tick_iters - steps (early tick exits)
        self.tick_retries = 0          # ticks replayed after a failure before their first launch
        self.tick_switches: List[Tuple[int, int, int]] = []  # (tick, from, to)
        self.fallback_events: List[Dict] = []   # a live pool's route switch
        # Per-tick cost: host-phase timers and the decayed affine fit of
        # cost(t) = a + b*t over (steps executed, tick seconds).
        self._phase_s = {"admit": 0.0, "advance": 0.0, "retire": 0.0}
        self._size_ticks: Dict[int, int] = {}
        self._size_s: Dict[int, float] = {}
        self._cm = DecayedAffineFit(decay=0.95)
        self._tick_prior: Optional[Tuple[float, float]] = None
        self._steps_ewma: Optional[float] = None   # micro-steps per request
        self._desired_streak: Tuple[int, int] = (tick_iters, 0)

    # ------------------------------------------------------------------
    # submission (priority/deadline-ordered queue)
    # ------------------------------------------------------------------

    def _validate_plan(self, plan: Plan) -> None:
        """Admission validation: a plan that would poison its lane is
        refused here, before it costs a slot (``Segmenter.plan`` already
        refused non-finite images; this guards prepared plans)."""
        model = plan.problem.model
        for name in ("region_mean", "region_weight"):
            arr = getattr(model, name)
            bad = int((~torch.isfinite(arr)).sum())
            if bad:
                raise RequestError(
                    f"plan model {name} contains {bad} non-finite value(s); "
                    "the lane's first energy evaluation would diverge"
                )
        if not bool(torch.isfinite(model.beta) & torch.isfinite(model.sigma_min)):
            raise RequestError("plan model beta/sigma_min must be finite")

    def submit(
        self,
        image_or_plan,
        *,
        rid: Optional[int] = None,
        seed: int = 0,
        deadline_s: Optional[float] = None,
        priority: int = 0,
    ) -> int:
        """Queue a request (an image or a prepared :class:`Plan`); returns
        its rid.  ``deadline_s`` is seconds from now.  An invalid request
        raises (``PlanError`` for an image, :class:`RequestError` for a
        plan, a deadline, a rid, a bucket past the pool's or more labels
        than the pool's) and never enters the queue."""
        plan = image_or_plan if isinstance(image_or_plan, Plan) else self.session.plan(image_or_plan)
        self._validate_plan(plan)
        if deadline_s is not None and not math.isfinite(deadline_s):
            raise RequestError(f"deadline_s must be finite, got {deadline_s!r}")
        if self.bucket is not None and not _fits(plan.bucket, self.bucket):
            raise RequestError(
                f"request bucket {tuple(plan.bucket)} exceeds the engine's "
                f"fixed pool bucket {tuple(self.bucket)}"
            )
        plan_labels = plan.problem.model.n_labels
        if plan_labels > self.session.config.n_labels:
            raise RequestError(
                f"request has {plan_labels} labels but the pool serves "
                f"n_labels={self.session.config.n_labels}; smaller-K requests "
                "are label-padded with inert labels, larger-K need a wider pool"
            )
        if rid is None:
            while self._auto_rid in self._live_rids:
                self._auto_rid += 1
            rid = self._auto_rid
            self._auto_rid += 1
        elif not isinstance(rid, int):
            raise RequestError(
                f"rid must be an int (it tie-breaks the admission heap), got {type(rid).__name__}"
            )
        elif rid in self._live_rids:
            raise RequestError(
                f"rid {rid} is already queued or in flight; completions are "
                "keyed by rid, so live rids must be unique"
            )
        self._live_rids.add(rid)
        req = SegRequest(
            rid=rid, plan=plan, seed=seed,
            deadline_s=None if deadline_s is None else time.perf_counter() + deadline_s,
            priority=int(priority),
        )
        key = _INF if req.deadline_s is None else req.deadline_s
        heapq.heappush(self._heap, (req.priority, key, int(rid), self._seq, req))
        self._seq += 1
        return rid

    def pending(self) -> int:
        return len(self._heap)

    def active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    # ------------------------------------------------------------------
    # pool bring-up, admission, retirement
    # ------------------------------------------------------------------

    def _ensure_pool(self) -> None:
        if self._exe is not None:
            return
        if self.bucket is None:
            if not self._heap:
                raise RuntimeError("cannot size the pool: no bucket, no pending")
            self.bucket = BucketKey(
                *(max(item[-1].plan.bucket[d] for item in self._heap) for d in range(3)))
        # Every ladder size up front (the session's LRU, so a sibling engine
        # pays nothing); all of them run on the one pool workspace.
        for size in self.tick_ladder:
            exe = self.session.compile_ticked(self.bucket, batch=self.max_batch, tick_iters=size)
            if size == self.tick_iters:
                self._exe = exe
        self._state = self.session.ticked_pool(self.bucket, batch=self.max_batch,
                                               backend=self._exe.key.backend)

    def _admit(self) -> int:
        """Fill free slots from the queue in priority/deadline order: writes
        to the slot's rows alone (``em.init_tick_lane``)."""
        admitted = 0
        now = time.perf_counter()
        for slot in range(self.max_batch):
            if not self._heap or self.slot_req[slot] is not None:
                continue
            req = heapq.heappop(self._heap)[-1]
            h1, m1, lab0, mu0, sig0, sctx = self.session.lane_state(
                req.plan, bucket=self.bucket, seed=req.seed)
            hold = False
            if chaos_mod.is_active():
                # The harness returns new tensors where it corrupts and never
                # writes the plan's memoised inputs; a corrupted model needs
                # its own element arrays (where the pool reads any).
                m1c, lab0, mu0, sig0 = chaos_mod.on_admit(req.rid, m1, lab0, mu0, sig0)
                if m1c is not m1:
                    m1 = m1c
                    if sctx is not None:
                        sctx = energy_mod.make_static_context(
                            h1, m1, backend=self.session.config.backend)
                hold = chaos_mod.hold_lane(req.rid)
            em_mod.init_tick_lane(self._state, slot, h1, m1, lab0, mu0, sig0, sctx)
            self.slot_req[slot] = req
            self._slot_admit_s[slot] = now
            self._slot_admit_tick[slot] = self.ticks
            self._slot_admit_steps[slot] = self.total_steps
            self._slot_hold[slot] = hold
            self.admitted += 1
            admitted += 1
        return admitted

    def _complete_slot(self, slot: int, status: Optional[str] = None) -> None:
        """A completion from the slot's lane, and the slot freed.
        ``status=None`` takes the lane's health; a string is the engine's
        disposition (``"evicted"``)."""
        req = self.slot_req[slot]
        now = time.perf_counter()
        res = em_mod.tick_result(self._state, slot)
        residence_s = now - self._slot_admit_s[slot]
        result = pipeline_mod.assemble_result(req.plan.problem, res, req.plan.init_seconds,
                                              residence_s)
        completion_status = result.status if status is None else status
        if completion_status not in OK_COMPLETION_STATUSES:
            self.error_completions += 1
        else:
            # Request length for the adaptive policy: an EWMA of micro-steps
            # (MAP iterations) per healthy completion.
            steps = float(result.map_iters)
            self._steps_ewma = steps if self._steps_ewma is None else 0.7 * self._steps_ewma + 0.3 * steps
        self.completions.append(SegCompletion(
            rid=req.rid, result=result, latency_s=now - req.submitted_s,
            queue_s=self._slot_admit_s[slot] - req.submitted_s, residence_s=residence_s,
            ticks_resident=self.ticks - self._slot_admit_tick[slot], slot=slot,
            status=completion_status,
        ))
        self.slot_req[slot] = None
        self._slot_hold[slot] = False
        self._live_rids.discard(req.rid)

    def _retire(self, done: List[bool]) -> int:
        """Retire finished lanes: converged ones and quarantined ones alike
        (a diverged or degenerate lane is done, with that status)."""
        retired = 0
        for slot in range(self.max_batch):
            if self.slot_req[slot] is None or not done[slot]:
                continue
            self._complete_slot(slot)
            retired += 1
        return retired

    def _evict(self, slot: int) -> None:
        self._state.retire(slot)
        self._complete_slot(slot, status="evicted")
        self.evicted += 1

    def _evict_overstayers(self) -> int:
        """Evict lanes whose micro-steps passed the residency budget; the
        slot's lane stops (a write to its active word) and frees up."""
        evicted = 0
        for slot in range(self.max_batch):
            if self.slot_req[slot] is None:
                continue
            if self.total_steps - self._slot_admit_steps[slot] < self._max_steps_resident:
                continue
            self._evict(slot)
            evicted += 1
        return evicted

    # ------------------------------------------------------------------
    # adaptive tick-size policy
    # ------------------------------------------------------------------

    def _record_tick(self, steps: int, duration: float) -> None:
        size = self.tick_iters
        self._size_ticks[size] = self._size_ticks.get(size, 0) + 1
        self._size_s[size] = self._size_s.get(size, 0.0) + duration
        self._cm.observe(steps, duration)

    def _tick_cost_default(self) -> Tuple[float, float]:
        """Cold-start ``(a, b)`` of the tick-cost fit: the calibrated cost
        model's prediction for this pool (the session's platform, mode, K
        and precision, the pool's bucket, ``max_batch`` lanes), taken once
        the bucket is known; :data:`TICK_COST_PRIOR` while it is not, or
        with the autotuner switched off."""
        if self._tick_prior is not None:
            return self._tick_prior
        if self.bucket is None or planning_mod.autotune_disabled():
            return TICK_COST_PRIOR
        cfg = self.session.config
        self._tick_prior = self.session.cost_model().tick_cost_prior(
            mode=cfg.mode, bucket=self.bucket, width=self.max_batch,
            n_labels=cfg.n_labels, precision=cfg.precision,
        )
        return self._tick_prior

    def cost_model(self) -> Tuple[float, float]:
        """Fitted per-tick cost ``(a, b)``: ``cost ~= a + b*steps`` seconds,
        starting from :meth:`_tick_cost_default`.  The intercept is floored
        at the measured host overhead per tick (the admit, advance and
        retire timers), so that a run of small ticks cannot fit ``a`` to
        zero and lock the policy there."""
        ph = self._phase_s
        a_floor = (ph["admit"] + ph["advance"] + ph["retire"]) / self.ticks if self.ticks else 0.0
        return self._cm.fit(a_floor=a_floor, default=self._tick_cost_default())

    def _request_steps_estimate(self) -> float:
        if self._steps_ewma is not None:
            return max(self._steps_ewma, 1.0)
        cfg = self.session.config
        return max(cfg.max_em_iters * cfg.max_map_iters / 4.0, 1.0)

    def _nearest_deadline_slack(self) -> Optional[float]:
        """Seconds to the tightest live deadline (resident or queued)."""
        deadlines = [r.deadline_s for r in self.slot_req if r is not None and r.deadline_s is not None]
        deadlines += [item[-1].deadline_s for item in self._heap if item[-1].deadline_s is not None]
        return min(deadlines) - time.perf_counter() if deadlines else None

    def _desired_tick_iters(self) -> int:
        """The ladder size minimising the expected cost per useful
        micro-step, ``(a + b*t) / (t * (1 - t/2S))`` for requests of S
        micro-steps; an empty queue or an urgent request halves S, and a
        near deadline clamps t so that one tick cannot pass it."""
        a, b = self.cost_model()
        s_est = self._request_steps_estimate()
        urgent = any(r is not None and r.priority < 0 for r in self.slot_req) or any(
            item[0] < 0 for item in self._heap)
        if not self._heap or urgent:
            s_est = max(s_est / 2.0, 2.0)
        best, best_u = self.tick_ladder[0], _INF
        for t in self.tick_ladder:
            eff = max(1.0 - t / (2.0 * s_est), 0.25)
            u = (a + b * t) / (t * eff)
            if u < best_u - 1e-12:
                best, best_u = t, u
        slack = self._nearest_deadline_slack()
        if slack is not None:
            below = [t for t in self.tick_ladder if t <= best]
            while len(below) > 1 and (a + b * below[-1]) * self.deadline_margin > max(slack, 0.0):
                below.pop()
            best = below[-1]
        return best

    def _maybe_resize_tick(self) -> None:
        """The adaptive policy with hysteresis: switch only after
        ``tick_hysteresis`` consecutive ticks agree on the same new size.
        A switch is a warm cache hit on the same pool workspace."""
        if not self.adaptive:
            return
        desired = self._desired_tick_iters()
        if desired == self.tick_iters:
            self._desired_streak = (desired, 0)
            return
        size, streak = self._desired_streak
        streak = streak + 1 if size == desired else 1
        self._desired_streak = (desired, streak)
        if streak < self.tick_hysteresis:
            return
        self.tick_switches.append((self.ticks, self.tick_iters, desired))
        self.tick_iters = desired
        self._desired_streak = (desired, 0)
        self._exe = self.session.compile_ticked(self.bucket, batch=self.max_batch,
                                                tick_iters=desired, backend=self._route)

    # ------------------------------------------------------------------
    # the tick
    # ------------------------------------------------------------------

    def _advance_pool(self):
        """One ticked-executable call under the session's fallback policy:
        a failed tick is replayed on the same route while it had launched
        nothing (the pool's micro-step count did not move); then, under a
        policy that names the plain route and for an error that is not a
        CUDA error, the pool switches to it (:meth:`_switch_route`); else
        :class:`FallbackError` (or, with the policy disabled, the original
        error).  Returns ``(state, steps_executed)``.

        The switch replays the whole tick from a snapshot taken before it
        (``em.tick_snapshot``), not from where the failure left the pool: a
        micro-step writes the pool in place at several points (the step's
        buffers, then the boundary's parameters and counters), so no point
        inside a failed micro-step is known to be whole.  The snapshot is
        taken only while the policy names a fallback the pool can still
        take, so a tick under the default policy does the work it did."""
        policy = self.session.config.fallback
        issued = self._state.micro_steps
        attempts = 0
        switchable = (policy.enabled and policy.backend is not None
                      and self._exe.key.backend != policy.backend)
        snapshot = em_mod.tick_snapshot(self._state) if switchable else None

        def tick():
            nonlocal attempts
            attempts += 1
            chaos_mod.on_execute(self._exe.key.backend)
            return self._exe(self._state)

        try:
            out = policy.retrying(tick, replayable=lambda: self._state.micro_steps == issued)
        except Exception as e:
            if not policy.enabled:
                raise
            if switchable and not is_cuda_error(e):
                self.tick_retries += attempts - 1
                return self._switch_route(e, snapshot)
            launched = self._state.micro_steps != issued
            raise FallbackError(
                f"tick {self.ticks} failed on route {self._exe.key.backend!r} "
                + ("after its first launch, so it was not replayed" if launched
                   else f"after {attempts - 1} replay(s)")
                + ("; a CUDA error never switches routes" if is_cuda_error(e) else
                   "; the policy takes no other route (FallbackPolicy(backend='torch') "
                   "asks for the plain one)")
            ) from e
        self.tick_retries += attempts - 1
        return out

    def _switch_route(self, error: Exception, snapshot: em_mod.TickSnapshot):
        """Move the live pool to the policy's plain route and replay the
        failed tick there: an event and a warning, every ladder size
        compiled on that route (the current one becomes the executable),
        the pool's state carried onto that route's pool workspace at
        ``snapshot``, and the tick run again.  :class:`FallbackError` if the
        replay fails too."""
        route = self.session.config.fallback.backend
        frm = self._exe.key.backend
        self.fallback_events.append({"stage": "tick", "from": frm, "to": route, "error": repr(error)})
        warnings.warn(f"tick {self.ticks} on route {frm!r} failed ({error!r}); the pool "
                      f"switches to {route!r}", RuntimeWarning, stacklevel=4)
        self._route = route
        for size in self.tick_ladder:
            exe = self.session.compile_ticked(self.bucket, batch=self.max_batch, tick_iters=size,
                                              backend=route)
            if size == self.tick_iters:
                self._exe = exe
        self._state = self.session.carry_pool(self._state, self.bucket, backend=route,
                                              snapshot=snapshot)
        try:
            chaos_mod.on_execute(route)
            return self._exe(self._state)
        except Exception as fb_e:
            raise FallbackError(
                f"tick {self.ticks} failed on route {frm!r} and on the fallback route {route!r}"
            ) from fb_e

    def step(self) -> int:
        """One engine tick: admit, advance every live lane by up to
        ``tick_iters`` micro-steps, retire finished lanes, evict
        overstayers, then let the adaptive policy reconsider the tick
        size.  Returns the number of lanes advanced (0: nothing to do)."""
        t_admit = time.perf_counter()
        if self._heap:
            self._ensure_pool()
            self._admit()
        n_active = self.active()
        if n_active == 0:
            return 0
        self._phase_s["admit"] += time.perf_counter() - t_admit
        t0 = time.perf_counter()
        chaos_mod.on_tick(self.ticks)
        # The tick reads the flag words after each launch, so the lanes'
        # done flags come back on the host with it: "advance" holds the sync.
        self._state, steps = self._advance_pool()
        done = list(self._state.done)
        t2 = time.perf_counter()
        self._phase_s["advance"] += t2 - t0
        self.watchdog.observe(self.ticks, t2 - t0)
        self._record_tick(steps, t2 - t0)
        self.ticks += 1
        self.total_steps += steps
        self.lane_steps += n_active * steps
        self.steps_saved += self.tick_iters - steps
        budget_mod.LEDGER.bump("serve", "ticks")
        budget_mod.LEDGER.bump("serve", "lane_steps", n_active * steps)
        t3 = time.perf_counter()
        # Chaos never-converge holds: reset the held lanes' progress before
        # retirement, so that they can leave only by eviction.  Writes to
        # the held slot's rows alone.
        for slot in range(self.max_batch):
            if self._slot_hold[slot] and self.slot_req[slot] is not None:
                dmu = chaos_mod.monkey().hold_perturbation(
                    self.slot_req[slot].rid, self.ticks, self._state.mu.shape[1])
                self._state.hold(slot, dmu)
                done[slot] = False
        self._retire(done)
        self._evict_overstayers()
        self._phase_s["retire"] += time.perf_counter() - t3
        self._maybe_resize_tick()
        return n_active

    def run(self, max_ticks: int = 1_000_000) -> List[SegCompletion]:
        """Drive until queue and pool are empty; returns (and clears) the
        completions in retirement order.  At ``max_ticks`` the residents
        are evicted (error completions with their latency) and the queue
        stays for a later ``run``."""
        while self._heap or self.active():
            if self.ticks >= max_ticks:
                for slot in range(self.max_batch):
                    if self.slot_req[slot] is not None:
                        self._evict(slot)
                break
            self.step()
        done, self.completions = self.completions, []
        return done

    def stats(self) -> dict:
        """Occupancy, throughput and health counters, and the per-tick cost
        breakdown (``tick_cost``)."""
        cap = max(self.total_steps * self.max_batch, 1)
        a, b = self.cost_model()
        per_size = {
            size: {"ticks": n, "mean_s": round(self._size_s[size] / n, 6)}
            for size, n in sorted(self._size_ticks.items())
        }
        return {
            "ticks": self.ticks,
            "tick_iters": self.tick_iters,
            "adaptive": self.adaptive,
            "tick_ladder": list(self.tick_ladder),
            "tick_switches": len(self.tick_switches),
            "max_batch": self.max_batch,
            "admitted": self.admitted,
            "total_steps": self.total_steps,
            "lane_steps": self.lane_steps,
            "steps_saved_early_exit": self.steps_saved,
            "occupancy": round(self.lane_steps / cap, 4),
            "evicted": self.evicted,
            "error_completions": self.error_completions,
            "tick_retries": self.tick_retries,
            "fallbacks": len(self.fallback_events),
            "straggler_events": len(self.watchdog.events),
            "tick_cost": {
                "phase_s": {k: round(v, 6) for k, v in self._phase_s.items()},
                "per_size": per_size,
                "model_fixed_s": round(a, 6),
                "model_per_step_s": round(b, 6),
                "prior": list(self._tick_cost_default()),
                "request_steps_est": round(self._request_steps_estimate(), 2),
            },
        }


def _fits(inner: BucketKey, outer: BucketKey) -> bool:
    return all(i <= o for i, o in zip(inner, outer))
