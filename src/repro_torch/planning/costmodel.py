"""Calibrated analytical cost model over the execution axes (counterpart
of ``repro.planning.costmodel``), numpy and the standard library only.

A *predicted-seconds* query over

    (mode, platform, K, bucket, batch width, shards, tick_iters, precision)

for the plan decisions: ``Segmenter.segment_stack(batch="auto")`` asks
:meth:`CostModel.choose_batch`, ``launch.segment --shards auto`` asks
:meth:`CostModel.choose_shards`, and the serving engine seeds its online
decayed least-squares tick-cost fit with :meth:`CostModel.tick_cost_prior`
(the same affine ``a + b*steps`` shape it refines live).

Each EM phase contributes a **transfer** term (bytes touched) and an
**innermost-loops** term (arithmetic), with coefficients fitted once by
``python -m repro_torch.planning.calibrate`` on the card from a seeded
microbenchmark grid and checked in as ``calibration.json``:

* ``count``: the per-(hood, label) count pass over the ``capacity``
  elements, K-1 keyed passes;
* ``energy_min``: the per-label energies and the min/argmin fold;
* ``vote``: the label-vote scatter into an ``(n_regions, K)`` table;
* ``m_step``: the per-EM-boundary parameter update;

plus a per-launch ``dispatch`` constant, a per-EM-boundary constant and
an ``n log n`` sort term.  Several columns are collinear on realistic
grids; the non-negative ridge fit (:func:`repro_torch.planning.lsq.nnls`)
splits mass between them deterministically, and the predictions stay
monotone.

Three structural effects are modeled explicitly:

* **lane serialization** (``width.serial_frac``): a lockstep batch of
  width w costs ``1 + serial_frac*(w-1)`` times a single lane;
* **lockstep inflation** (``priors.iter_cv``): every lane of a batch runs
  to the slowest lane's convergence, ``1 + cv*sqrt(2 ln w)``;
* **collective overhead** (``sharding.*``): sharding divides the element
  terms by the shard count and adds per-MAP-iteration all-reduce terms
  that scale with the reduced key spaces and ``log2(shards)``.

Every floating-point operation is the reference's, in its order: on the
same observations and meta :func:`fit_table` gives the reference's table
bytes, and on the same table every prediction and decision is the
reference's.  Tables are per platform (``meta.platform``: ``"gpu"`` for
the card, ``"cpu"`` for the host); :func:`model_for` maps a torch device
to that name.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .lsq import nnls

__all__ = [
    "FEATURE_NAMES",
    "BatchDecision",
    "ShardDecision",
    "CostModel",
    "fit_table",
    "table_to_json",
    "load_table",
    "default_table_path",
    "model_for",
    "platform_of",
    "reset_models",
    "autotune_disabled",
    "legacy_batch_choice",
]

#: Execution modes the calibration grid covers (mirrors ``em.MODES``;
#: kept literal so this module imports neither torch nor the session).
MODES = ("faithful", "static", "static-pallas")

#: Environment escape hatch: ``REPRO_DISABLE_AUTOTUNE=1`` restores the
#: hard-coded heuristics the model replaced (platform literal + 2x
#: capacity spread, one shard, the fixed tick-cost prior).
DISABLE_ENV = "REPRO_DISABLE_AUTOTUNE"


def _features(
    cap: float, nh: float, nr: float, k: float, em: float, mp: float
) -> List[float]:
    """One design-matrix row: per-phase (transfer, loops) features.

    ``em`` is the EM (outer) iteration count, ``mp`` the total MAP
    (inner) iteration count of the solve being modeled; the MAP-phase
    features scale with ``mp``, the boundary phases with ``em``.
    """
    logc = math.log2(max(cap, 2.0))
    return [
        1.0,                       # dispatch/transfer: per-launch constant
        em,                        # em_boundary/loops: per-EM-iter constant
        mp * cap,                  # count/transfer: element stream read
        mp * cap * (k - 1),        # count/loops: K-1 complement count passes
        mp * (cap + nh * k),       # energy_min/transfer: elements + count gathers
        mp * cap * k,              # energy_min/loops: per-label energies + min fold
        mp * nr * k,               # vote/transfer: (n_regions, K) vote table
        mp * cap,                  # vote/loops: per-element vote contributions
        mp * cap * logc,           # sort/loops: sort-based keyed reductions
        em * nh,                   # m_step/transfer: per-hood energy sums
        em * nr * k,               # m_step/loops: per-(region,label) accumulators
    ]


FEATURE_NAMES: Tuple[str, ...] = (
    "dispatch/transfer",
    "em_boundary/loops",
    "count/transfer",
    "count/loops",
    "energy_min/transfer",
    "energy_min/loops",
    "vote/transfer",
    "vote/loops",
    "sort/loops",
    "m_step/transfer",
    "m_step/loops",
)

#: Features multiplied by the bf16 energy factor (only the energy operands
#: are quantized; everything else stays f32).
_PRECISION_FEATURES = ("energy_min/transfer", "energy_min/loops")


def _round_sig(x: float, sig: int = 12) -> float:
    """Canonical float rounding for byte-deterministic table JSON."""
    if x == 0.0 or not math.isfinite(x):
        return float(x)
    return float(f"{x:.{sig}g}")


# ---------------------------------------------------------------------------
# fitting (pure: observations -> table dict)
# ---------------------------------------------------------------------------


def _solve_row(obs: Dict) -> List[float]:
    return _features(
        obs["cap"], obs["nh"], obs["nr"], obs["k"], obs["em_iters"],
        obs["map_iters"],
    )


def fit_table(observations: Sequence[Dict], meta: Dict) -> Dict:
    """Fit the full calibration table from raw microbenchmark observations.

    Deterministic: same observations (and meta) in, same table dict out;
    ``calibrate --refit`` re-fits from the checked-in observations and
    must reproduce the file's bytes.  Observation kinds:

    * ``solve``  — one warm single-lane execute: ``mode, cap, nh, nr, k,
      em_iters, map_iters, seconds``.
    * ``batched`` — one warm lockstep drain of ``width`` lanes at a joint
      bucket: adds ``width``; ``em_iters``/``map_iters`` are the *max*
      over lanes (what the lockstep program actually runs).
    * ``sharded`` — one warm sharded execute: adds ``shards``.
    """
    observations = sorted(
        observations,
        key=lambda o: (o["kind"], o.get("mode", ""), o["cap"], o.get("k", 0),
                       o.get("width", 0), o.get("shards", 0), o["seconds"]),
    )
    solve = [o for o in observations if o["kind"] == "solve"]
    batched = [o for o in observations if o["kind"] == "batched"]
    sharded = [o for o in observations if o["kind"] == "sharded"]
    if not solve:
        raise ValueError("fit_table needs at least one 'solve' observation")

    coefficients: Dict[str, Dict[str, float]] = {}
    for mode in MODES:
        rows = [o for o in solve if o["mode"] == mode]
        if not rows:
            continue
        A = np.array([_solve_row(o) for o in rows], np.float64)
        y = np.array([o["seconds"] for o in rows], np.float64)
        x = nnls(A, y, l2=1e-6)
        coefficients[mode] = {
            name: _round_sig(float(v)) for name, v in zip(FEATURE_NAMES, x)
        }

    em_counts = np.array([o["em_iters"] for o in solve], np.float64)
    map_ratio = np.array(
        [o["map_iters"] / max(o["em_iters"], 1) for o in solve], np.float64
    )
    priors = {
        "mean_em_iters": _round_sig(float(np.mean(em_counts))),
        "map_iters_per_em": _round_sig(float(np.mean(map_ratio))),
        # Coefficient of variation of the EM iteration count across the
        # calibration problems: drives the lockstep-inflation estimate
        # E[max of w lanes] / E[mean] ~= 1 + cv*sqrt(2 ln w).
        "iter_cv": _round_sig(
            float(np.std(em_counts) / max(np.mean(em_counts), 1e-9))
        ),
    }

    # Lane serialization: how much of a lockstep batch's width is paid in
    # wall clock.  ratio = (batched cost) / (single-lane cost at the same
    # max-lane iteration counts); frac = (ratio - 1) / (width - 1).
    model = CostModel(
        {"coefficients": coefficients, "priors": priors,
         "width": {"serial_frac": 1.0}, "sharding": {},
         "precision": {"bf16_energy_factor": 1.0}, "meta": meta}
    )
    fracs = []
    for o in batched:
        single = model.predict_solve(
            mode=o["mode"], bucket=(o["cap"], o["nh"], o["nr"]),
            n_labels=o["k"], em_iters=o["em_iters"], map_iters=o["map_iters"],
        )
        dispatch = coefficients.get(o["mode"], {}).get("dispatch/transfer", 0.0)
        body = max(single - dispatch, 1e-9)
        ratio = max(o["seconds"] - dispatch, 0.0) / body
        if o["width"] > 1:
            fracs.append((ratio - 1.0) / (o["width"] - 1.0))
    width = {
        "serial_frac": _round_sig(
            float(min(max(np.median(fracs), 0.0), 1.0)) if fracs else 1.0
        )
    }

    # Collective overhead: residual of sharded observations over the
    # serial model evaluated at the per-shard element stream
    # (cap/shards), fitted as fixed-per-MAP-iter + per-psum-element
    # terms, both scaled by log2(shards) (allreduce depth).
    sharding = {"collective_fixed": 0.0, "collective_per_key": 0.0}
    rows, resid = [], []
    model_w = CostModel(
        {"coefficients": coefficients, "priors": priors, "width": width,
         "sharding": sharding, "precision": {"bf16_energy_factor": 1.0},
         "meta": meta}
    )
    for o in sharded:
        s = o["shards"]
        if s <= 1:
            continue
        base = model_w._solve_seconds(
            o["mode"], o["cap"] / s, o["nh"], o["nr"], o["k"],
            o["em_iters"], o["map_iters"],
        )
        depth = math.log2(s)
        keys = o["nh"] * o["k"] + o["nh"] + o["nr"] * o["k"]
        rows.append([o["map_iters"] * depth, o["map_iters"] * depth * keys])
        resid.append(o["seconds"] - base)
    if rows:
        x = nnls(np.array(rows, np.float64), np.array(resid, np.float64),
                 l2=1e-6)
        sharding = {
            "collective_fixed": _round_sig(float(x[0])),
            "collective_per_key": _round_sig(float(x[1])),
        }

    return {
        "version": 1,
        "meta": dict(meta),
        "priors": priors,
        "coefficients": coefficients,
        "width": width,
        "sharding": sharding,
        "precision": {"bf16_energy_factor": 1.0},
        "observations": list(observations),
    }


def table_to_json(table: Dict) -> str:
    """Canonical serialization: sorted keys, 2-space indent, trailing
    newline — byte-deterministic given the table contents."""
    return json.dumps(table, sort_keys=True, indent=2) + "\n"


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BatchDecision:
    """Outcome of a batch-vs-loop query (``segment_stack(batch="auto")``)."""

    use_batch: bool
    serial_s: float       # predicted: per-lane loop, each at its own bucket
    batched_s: float      # predicted: one lockstep launch at the joint bucket
    width: int
    inflation: float      # lockstep E[max]/E[mean] iteration inflation
    calibrated: bool      # False when running on uncalibrated defaults

    def as_dict(self) -> Dict:
        return {
            "use_batch": self.use_batch,
            "predicted_serial_s": round(self.serial_s, 6),
            "predicted_batched_s": round(self.batched_s, 6),
            "width": self.width,
            "lockstep_inflation": round(self.inflation, 4),
            "calibrated": self.calibrated,
        }


@dataclass(frozen=True)
class ShardDecision:
    """Outcome of a shard-count query (``--shards auto``)."""

    shards: int
    predicted_s: Dict[int, float] = field(default_factory=dict)
    calibrated: bool = True

    def as_dict(self) -> Dict:
        return {
            "shards": self.shards,
            "predicted_seconds": {
                str(s): round(v, 6) for s, v in sorted(self.predicted_s.items())
            },
            "calibrated": self.calibrated,
        }

    def warn_if_forced(self, forced: int, *, tolerance: float = 0.10) -> Optional[str]:
        """One-line warning when ``forced`` is predicted at least
        ``tolerance`` slower than the model's choice; None when the
        forced count is fine (or unknown to the prediction set)."""
        if forced == self.shards or forced not in self.predicted_s:
            return None
        best = self.predicted_s[self.shards]
        mine = self.predicted_s[forced]
        if mine <= best * (1.0 + tolerance):
            return None
        return (
            f"--shards {forced} is predicted {mine / best:.2f}x slower than "
            f"--shards {self.shards} at this problem size "
            f"(predicted {mine:.3f}s vs {best:.3f}s); use --shards auto to "
            "let the calibrated cost model choose (DESIGN.md §18)"
        )


#: Uncalibrated per-platform defaults (the reference's): order-of-magnitude
#: host/accelerator constants that reproduce the legacy routing (the host
#: never lockstep-batches, accelerators do; sharding pays only at scale).
#: Predictions from these are flagged ``calibrated=False``: decisions
#: remain sane, absolute seconds are not to be trusted.
_DEFAULT_TABLES: Dict[str, Dict] = {
    platform: {
        "version": 1,
        "meta": {"platform": platform, "backend": "default", "source": "builtin"},
        "priors": {"mean_em_iters": 12.0, "map_iters_per_em": 6.0,
                   "iter_cv": 0.15},
        "coefficients": {
            mode: {
                "dispatch/transfer": 3e-4,
                "em_boundary/loops": 2e-4,
                "count/transfer": 0.0,
                "count/loops": per_elem * 0.5,
                "energy_min/transfer": 0.0,
                "energy_min/loops": per_elem,
                "vote/transfer": 0.0,
                "vote/loops": per_elem * 0.5,
                "sort/loops": per_elem * 0.1,
                "m_step/transfer": 0.0,
                "m_step/loops": per_elem,
            }
            for mode, per_elem in (
                ("faithful", 8e-9), ("static", 2e-9), ("static-pallas", 2e-9),
            )
        },
        "width": {"serial_frac": serial_frac},
        "sharding": {"collective_fixed": coll, "collective_per_key": 2e-9},
        "precision": {"bf16_energy_factor": 1.0},
        "observations": [],
    }
    for platform, serial_frac, coll in (
        ("cpu", 1.0, 1e-3), ("gpu", 0.05, 5e-5), ("tpu", 0.05, 5e-5),
    )
}


class CostModel:
    """``predict(config, bucket) -> seconds`` over the execution axes.

    Construct from a fitted calibration table (:func:`load_table`) or let
    :func:`model_for` pick the checked-in table matching the current
    platform, falling back to the builtin defaults (``calibrated`` is
    False then — decisions still route sanely, absolute numbers do not).
    """

    def __init__(self, table: Dict):
        self.table = table
        self.calibrated = table.get("meta", {}).get("source") != "builtin"

    # -- low-level ------------------------------------------------------

    def _coeffs(self, mode: str) -> Dict[str, float]:
        coeffs = self.table["coefficients"]
        if mode in coeffs:
            return coeffs[mode]
        # A mode missing from the calibration grid borrows the closest
        # fitted one (static ~ static-pallas).
        for alt in ("static", "static-pallas", "faithful"):
            if alt in coeffs:
                return coeffs[alt]
        raise KeyError(f"calibration table has no coefficients (mode={mode!r})")

    def _iters(
        self,
        em_iters: Optional[float],
        map_iters: Optional[float],
        max_em_iters: Optional[int],
        max_map_iters: Optional[int],
    ) -> Tuple[float, float]:
        pr = self.table["priors"]
        em = pr["mean_em_iters"] if em_iters is None else float(em_iters)
        if max_em_iters is not None:
            em = min(em, float(max_em_iters))
        if map_iters is None:
            per = pr["map_iters_per_em"]
            if max_map_iters is not None:
                per = min(per, float(max_map_iters))
            mp = em * per
        else:
            mp = float(map_iters)
        return em, mp

    def _solve_seconds(
        self, mode: str, cap: float, nh: float, nr: float, k: float,
        em: float, mp: float, precision: str = "f32",
    ) -> float:
        coeffs = self._coeffs(mode)
        feats = _features(cap, nh, nr, k, em, mp)
        pfactor = (
            self.table.get("precision", {}).get("bf16_energy_factor", 1.0)
            if precision == "bf16" else 1.0
        )
        total = 0.0
        for name, f in zip(FEATURE_NAMES, feats):
            c = coeffs.get(name, 0.0)
            if name in _PRECISION_FEATURES:
                c *= pfactor
            total += c * f
        return total

    # -- public predictions --------------------------------------------

    def predict_solve(
        self,
        *,
        mode: str,
        bucket: Sequence[int],
        n_labels: int = 2,
        shards: int = 1,
        precision: str = "f32",
        em_iters: Optional[float] = None,
        map_iters: Optional[float] = None,
        max_em_iters: Optional[int] = None,
        max_map_iters: Optional[int] = None,
    ) -> float:
        """Predicted wall seconds for ONE warm run-to-convergence execute
        at ``bucket`` (capacity, n_hoods, n_regions)."""
        cap, nh, nr = (float(x) for x in bucket)
        em, mp = self._iters(em_iters, map_iters, max_em_iters, max_map_iters)
        if shards <= 1:
            return self._solve_seconds(mode, cap, nh, nr, n_labels, em, mp,
                                       precision)
        sh = self.table["sharding"]
        base = self._solve_seconds(
            mode, cap / shards, nh, nr, n_labels, em, mp, precision
        )
        depth = math.log2(shards)
        keys = nh * n_labels + nh + nr * n_labels
        return base + mp * depth * (
            sh.get("collective_fixed", 0.0)
            + sh.get("collective_per_key", 0.0) * keys
        )

    def lockstep_inflation(self, width: int) -> float:
        """E[max]/E[mean] iteration inflation for ``width`` lockstep lanes."""
        if width <= 1:
            return 1.0
        cv = self.table["priors"].get("iter_cv", 0.0)
        return 1.0 + cv * math.sqrt(2.0 * math.log(width))

    def predict_batched(
        self,
        *,
        mode: str,
        bucket: Sequence[int],
        width: int,
        n_labels: int = 2,
        precision: str = "f32",
        em_iters: Optional[float] = None,
        max_em_iters: Optional[int] = None,
        max_map_iters: Optional[int] = None,
    ) -> float:
        """Predicted wall seconds for ONE lockstep ``run_em_batched``
        launch of ``width`` lanes at the joint ``bucket``: every lane runs
        to the slowest lane's convergence (iteration inflation) and the
        platform pays ``1 + serial_frac*(width-1)`` of a single lane's
        body (lane serialization)."""
        infl = self.lockstep_inflation(width)
        em, mp = self._iters(em_iters, None, max_em_iters, max_map_iters)
        single = self.predict_solve(
            mode=mode, bucket=bucket, n_labels=n_labels, precision=precision,
            em_iters=em * infl, map_iters=mp * infl,
        )
        dispatch = self._coeffs(mode).get("dispatch/transfer", 0.0)
        frac = self.table["width"].get("serial_frac", 1.0)
        return dispatch + (single - dispatch) * (1.0 + frac * (width - 1))

    def choose_batch(
        self,
        *,
        mode: str,
        buckets: Sequence[Sequence[int]],
        joint_bucket: Sequence[int],
        n_labels: int = 2,
        precision: str = "f32",
        max_em_iters: Optional[int] = None,
        max_map_iters: Optional[int] = None,
    ) -> BatchDecision:
        """Lockstep-batch vs per-lane serial loop for a same-session group
        (``segment_stack``).  The serial side prices each lane at its OWN
        bucket; the batched side prices the joint bucket — so a wide
        capacity spread shows up as padding cost, not as a hard-coded 2x
        rule."""
        width = len(buckets)
        serial = sum(
            self.predict_solve(
                mode=mode, bucket=b, n_labels=n_labels, precision=precision,
                max_em_iters=max_em_iters, max_map_iters=max_map_iters,
            )
            for b in buckets
        )
        batched = self.predict_batched(
            mode=mode, bucket=joint_bucket, width=width, n_labels=n_labels,
            precision=precision, max_em_iters=max_em_iters,
            max_map_iters=max_map_iters,
        )
        return BatchDecision(
            use_batch=width > 1 and batched < serial,
            serial_s=serial,
            batched_s=batched,
            width=width,
            inflation=self.lockstep_inflation(width),
            calibrated=self.calibrated,
        )

    def choose_shards(
        self,
        *,
        mode: str,
        bucket: Sequence[int],
        candidates: Sequence[int],
        n_labels: int = 2,
        precision: str = "f32",
        max_em_iters: Optional[int] = None,
        max_map_iters: Optional[int] = None,
    ) -> ShardDecision:
        """Cheapest predicted shard count among ``candidates`` (ties break
        toward fewer shards: less mesh, same predicted cost)."""
        if not candidates:
            raise ValueError("choose_shards needs at least one candidate")
        predicted = {
            int(s): self.predict_solve(
                mode=mode, bucket=bucket, n_labels=n_labels, shards=int(s),
                precision=precision, max_em_iters=max_em_iters,
                max_map_iters=max_map_iters,
            )
            for s in candidates
        }
        best = min(sorted(predicted), key=lambda s: (predicted[s], s))
        return ShardDecision(
            shards=best, predicted_s=predicted, calibrated=self.calibrated
        )

    def tick_cost_prior(
        self,
        *,
        mode: str,
        bucket: Sequence[int],
        width: int,
        n_labels: int = 2,
        precision: str = "f32",
    ) -> Tuple[float, float]:
        """Affine prior ``(a, b)`` for the serving engine's per-tick cost
        ``cost ~= a + b*steps``: ``a`` is the per-launch
        dispatch constant, ``b`` the predicted marginal cost of one pool
        micro-step (one MAP iteration across ``width`` lanes, with the
        platform's lane-serialization factor).  The engine's online
        decayed-LSQ fit starts from this instead of blind constants and
        refines it from live ticks — one cost model, two consumers."""
        cap, nh, nr = (float(x) for x in bucket)
        per_step = self._solve_seconds(mode, cap, nh, nr, n_labels, 0.0, 1.0,
                                       precision)
        dispatch = self._coeffs(mode).get("dispatch/transfer", 0.0)
        per_step -= dispatch
        frac = self.table["width"].get("serial_frac", 1.0)
        b = max(per_step * (1.0 + frac * (width - 1)), 1e-6)
        return max(dispatch, 1e-6), b


# ---------------------------------------------------------------------------
# loading / module-level access
# ---------------------------------------------------------------------------


def default_table_path() -> pathlib.Path:
    """The checked-in calibration table (written by
    ``python -m repro_torch.planning.calibrate`` on the card)."""
    return pathlib.Path(__file__).resolve().parent / "calibration.json"


def load_table(path: Optional[os.PathLike] = None) -> Dict:
    p = pathlib.Path(path) if path is not None else default_table_path()
    with open(p) as fh:
        return json.load(fh)


_MODEL_CACHE: Dict[str, CostModel] = {}

#: torch device types to the tables' platform names.
PLATFORMS = {"cuda": "gpu", "cpu": "cpu"}


def platform_of(device) -> str:
    """The table platform of a torch device (or device string):
    ``"gpu"`` for ``cuda``, ``"cpu"`` for ``cpu``."""
    dtype = getattr(device, "type", None) or str(device).split(":")[0]
    try:
        return PLATFORMS[dtype]
    except KeyError:
        raise ValueError(f"no cost-model platform for device type {dtype!r}") from None


def model_for(config=None, *, platform: Optional[str] = None, device=None) -> CostModel:
    """The process-wide :class:`CostModel` of a platform.

    The platform is ``platform`` or, failing that, the one of ``device``
    (:func:`platform_of`; ``None``: the card, ``"gpu"``).  Uses the
    checked-in calibration table when its ``meta.platform`` matches
    (tables are per platform: host timings say nothing about the card),
    otherwise the builtin uncalibrated defaults for the platform.
    ``config`` is accepted for call-site symmetry (the model is
    platform-scoped, not config-scoped) and unused.
    """
    del config
    if platform is None:
        platform = platform_of(device if device is not None else "cuda")
    cached = _MODEL_CACHE.get(platform)
    if cached is not None:
        return cached
    model = None
    try:
        table = load_table()
        if table.get("meta", {}).get("platform") == platform:
            model = CostModel(table)
    except (OSError, ValueError, KeyError):
        model = None
    if model is None:
        model = CostModel(_DEFAULT_TABLES.get(platform, _DEFAULT_TABLES["cpu"]))
    _MODEL_CACHE[platform] = model
    return model


def reset_models() -> None:
    """Drop the model cache (test hook: table monkeypatching)."""
    _MODEL_CACHE.clear()


def autotune_disabled() -> bool:
    """True when ``REPRO_DISABLE_AUTOTUNE`` is set to a truthy value."""
    return os.environ.get(DISABLE_ENV, "") not in ("", "0")


def legacy_batch_choice(capacities: Sequence[int], platform: str) -> bool:
    """The hard-coded ``batch="auto"`` heuristic the model replaced, kept
    verbatim as the ``REPRO_DISABLE_AUTOTUNE=1`` escape hatch: batch only
    on an accelerator (``platform`` a table name, not ``"cpu"``) and only
    when every lane's capacity is within 2x of the smallest (one bucket,
    bounded padding waste)."""
    caps = list(capacities)
    return (
        len(caps) > 1
        and max(caps) <= 2 * min(caps)
        and platform != "cpu"
    )
