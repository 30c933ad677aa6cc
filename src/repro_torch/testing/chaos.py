"""Deterministic chaos harness: seeded fault injection for the serving
stack (counterpart of ``repro.testing.chaos``).

:func:`inject` activates a :class:`ChaosMonkey` built from a frozen
:class:`ChaosConfig`; the session and the serving engine consult the
module hooks at fixed points, and every hook is a no-op when no context is
active.  Each fault is deterministic in ``(seed, rid)`` or ``(seed,
tick)``, with the reference's draws, so both packages poison the same
requests, regions and ticks:

* ``nan_image``: :meth:`ChaosMonkey.poison_image` NaNs pixels, so
  ``Segmenter.plan`` (and ``submit``) refuse the image with ``PlanError``;
* ``bad_init``: :func:`on_admit` NaNs a lane's initial ``mu`` after
  ``submit``'s validation; its first energies are not finite and the lane
  retires ``diverged``;
* ``nan_data``: :func:`on_admit` NaNs an eighth of the lane's region
  means; the same ``diverged``, through the data term;
* ``never_converge``: :func:`hold_lane` marks the request; the engine
  moves the lane's mu and resets its progress after every tick
  (:meth:`ChaosMonkey.hold_perturbation`), so it is evicted when its
  residency budget runs out;
* ``slow_tick``: :func:`on_tick` sleeps every Nth engine tick, for the
  straggler watchdog;
* ``compile_fail``, ``exec_fail``, ``transient_exec_failures``:
  :func:`on_compile` (a session's compile) and :func:`on_execute` (an
  engine's tick) raise :class:`ChaosError`.  Nothing catches it yet: the
  retries and the backend fallback wait for the port's ``FallbackPolicy``.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: Fault classes a request can be assigned.
REQUEST_FAULTS = ("nan_image", "bad_init", "nan_data", "never_converge")


class ChaosError(RuntimeError):
    """An injected (not organic) failure: compile or execute."""


@dataclass(frozen=True)
class ChaosConfig:
    """Seeded fault plan.  Rates draw one uniform per rid (deterministic
    in ``(seed, rid)``); the ``*_rids`` tuples force specific requests."""

    seed: int = 0
    # Bernoulli fault rates per request (disjoint: one draw, partitioned).
    nan_image_rate: float = 0.0
    bad_init_rate: float = 0.0
    nan_data_rate: float = 0.0
    never_converge_rate: float = 0.0
    # Explicit per-fault rid assignments (checked before the rate draw).
    nan_image_rids: Tuple[int, ...] = ()
    bad_init_rids: Tuple[int, ...] = ()
    nan_data_rids: Tuple[int, ...] = ()
    never_converge_rids: Tuple[int, ...] = ()
    # Compile / execute failures.
    compile_fail_backends: Tuple[str, ...] = ()
    exec_fail_backends: Tuple[str, ...] = ()
    transient_exec_failures: int = 0   # the first N on_execute calls raise
    # Slow ticks (the straggler watchdog's exercise).
    slow_tick_every: int = 0           # 0: off; else every Nth tick sleeps
    slow_tick_s: float = 0.0


class ChaosMonkey:
    """The active fault injector; records every injection in ``events``."""

    def __init__(self, config: ChaosConfig):
        self.config = config
        self.events: List[Dict] = []
        self._exec_failures_left = int(config.transient_exec_failures)

    def _draw(self, rid: int) -> float:
        return float(np.random.default_rng((self.config.seed, rid)).random())

    def fault_for_request(self, rid: int) -> Optional[str]:
        """The fault class of ``rid`` (None: healthy).  Explicit rid lists
        win; otherwise one uniform draw is split across the four rates, so
        the classes exclude each other."""
        c = self.config
        for name in REQUEST_FAULTS:
            if rid in getattr(c, f"{name}_rids"):
                return name
        u = self._draw(rid)
        lo = 0.0
        for name in REQUEST_FAULTS:
            hi = lo + getattr(c, f"{name}_rate")
            if lo <= u < hi:
                return name
            lo = hi
        return None

    def _record(self, kind: str, **info) -> None:
        self.events.append({"kind": kind, **info})

    def on_admit(self, rid: int, model, labels0, mu0, sigma0):
        """A lane's admission inputs, corrupted per its fault; returns
        ``(model, labels0, mu0, sigma0)``, new tensors where corrupted and
        the given ones otherwise (those are memoised on the plan)."""
        fault = self.fault_for_request(rid)
        if fault == "bad_init":
            mu0 = torch.full_like(mu0, float("nan"))
            self._record("bad_init", rid=rid)
        elif fault == "nan_data":
            mean = model.region_mean.clone()
            rng = np.random.default_rng((self.config.seed, rid, 1))
            n = max(1, mean.shape[-1] // 8)
            idx = rng.choice(max(mean.shape[-1] - 1, 1), size=n, replace=False)
            mean[..., torch.as_tensor(idx, device=mean.device)] = float("nan")
            model = model._replace(region_mean=mean)
            self._record("nan_data", rid=rid)
        return model, labels0, mu0, sigma0

    def hold_lane(self, rid: int) -> bool:
        held = self.fault_for_request(rid) == "never_converge"
        if held:
            self._record("never_converge", rid=rid)
        return held

    def hold_perturbation(self, rid: int, tick: int, k: int) -> np.ndarray:
        """A finite per-tick mu step for a held lane, which keeps its energy
        field moving so that no convergence window closes."""
        rng = np.random.default_rng((self.config.seed, rid, tick, 2))
        return (rng.standard_normal(k) * 3.0).astype(np.float32)

    def on_compile(self, backend: str) -> None:
        if backend in self.config.compile_fail_backends:
            self._record("compile_fail", backend=backend)
            raise ChaosError(f"injected compile failure for backend {backend!r}")

    def on_execute(self, backend: str) -> None:
        if self._exec_failures_left > 0:
            self._exec_failures_left -= 1
            self._record("transient_exec_fail", backend=backend)
            raise ChaosError("injected transient execute failure")
        if backend in self.config.exec_fail_backends:
            self._record("exec_fail", backend=backend)
            raise ChaosError(f"injected execute failure for backend {backend!r}")

    def on_tick(self, tick: int) -> None:
        c = self.config
        if c.slow_tick_every > 0 and tick % c.slow_tick_every == 0:
            self._record("slow_tick", tick=tick, seconds=c.slow_tick_s)
            time.sleep(c.slow_tick_s)

    def poison_image(self, image, rid: int) -> np.ndarray:
        """The image with a deterministic sixty-fourth of its pixels NaN
        (the ``nan_image`` class: callers submit it and expect
        ``PlanError``)."""
        if isinstance(image, torch.Tensor):
            image = image.cpu().numpy()
        img = np.array(image, dtype=np.float32, copy=True)
        rng = np.random.default_rng((self.config.seed, rid, 3))
        flat = img.reshape(-1)
        idx = rng.choice(flat.size, size=max(1, flat.size // 64), replace=False)
        flat[idx] = np.nan
        self._record("nan_image", rid=rid)
        return img


# ---------------------------------------------------------------------------
# module-level context (what library hooks consult)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[ChaosMonkey] = None


def is_active() -> bool:
    return _ACTIVE is not None


def monkey() -> Optional[ChaosMonkey]:
    return _ACTIVE


@contextlib.contextmanager
def inject(config: ChaosConfig):
    """Activate a chaos context and yield its :class:`ChaosMonkey`.  Nested
    contexts stack (the innermost wins)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, ChaosMonkey(config)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def on_admit(rid, model, labels0, mu0, sigma0):
    if _ACTIVE is None:
        return model, labels0, mu0, sigma0
    return _ACTIVE.on_admit(rid, model, labels0, mu0, sigma0)


def hold_lane(rid: int) -> bool:
    return _ACTIVE is not None and _ACTIVE.hold_lane(rid)


def on_compile(backend: str) -> None:
    if _ACTIVE is not None:
        _ACTIVE.on_compile(backend)


def on_execute(backend: str) -> None:
    if _ACTIVE is not None:
        _ACTIVE.on_execute(backend)


def on_tick(tick: int) -> None:
    if _ACTIVE is not None:
        _ACTIVE.on_tick(tick)
